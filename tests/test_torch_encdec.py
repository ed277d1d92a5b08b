"""Port parity: the encoder-decoder family (``repro_torch.models.attention``'s
cross-attention and its cache lines, ``transformer``'s encoder, encoder
admission, prefill, decode and chunk paths, the calibration features and
losses, the engine's encoder slots and its hash chain, the serve tree)
against ``repro`` at the seamless-m4t-large-v2 smoke config (d 64, 2
encoder and 4 decoder layers of 4 heads of 16, an ungated GELU MLP of 128,
LayerNorm, an untied head of 512), on the reference's params (key 0),
codes (key 1) and random non-zero adapter B factors, carried across with
``repro_torch.interop``, and the reference's encoder inputs.

Bounds, relative to the reference's absmax:

* ``F32_BOUND`` (1e-5, ``test_torch_model``'s): f32 tensors whose only
  difference is the summation order (the model, the caches, the features);
* ``BF16_BOUND`` (3e-2, ``test_torch_model``'s): the bf16 model as
  shipped;
* the losses ``F32_RTOL`` (1e-4, ``test_torch_calibrate``'s) and their
  gradients 1e-4 of each leaf's absmax;
* the engine's greedy tokens (f32): equal, or split at a near-tie of the
  reference's logits within ``F32_BOUND``;
* the hash chain, the serve tree's fused operands, a full prefix hit
  against cold admission, and the cross lines of an engine slot against
  ``cross_kv`` of its request: bitwise.

A padded cross buffer is not bitwise the exact-length computation here,
as the reference claims it is for its own: the masked tail's exp is 0
exactly, but the f32 denominator and ``probs @ V`` reduce over another
length, and PyTorch groups a longer reduction otherwise (7e-7 apart at
this config, ~1e-7 at d 1024 with 333 valid positions of 4096), so
``test_padded_cross_lines_match_exact_length`` holds it to ``F32_BOUND``
and the engine's streams to the tokens of the requests served alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.configs import get_arch as j_arch
from repro.core import calibrate as jcal
from repro.deploy import Deployment as JDeployment
from repro.deploy import ServeEngine as JEngine
from repro.deploy.deployment import calibration_batch as j_calibration_batch
from repro.deploy.engine import Request as JRequest
from repro.models import transformer as JT
from repro_torch import substrate as tsub
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.deploy import Deployment, ServeEngine, calibration_batch
from repro_torch.deploy.engine import Request
from repro_torch.interop import from_reference, to_tensor
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.substrate import prepared as tprep

from test_torch_calibrate import F32_RTOL, port_np
from test_torch_model import BF16_BOUND, F32_BOUND, np_tree, random_lora_b
from test_torch_prefix import _bitwise, _engine, _serve

ARCH = "seamless_m4t_large_v2"
B, S, S_SRC, SRC_LEN, MAX_LEN = 2, 10, 7, 12, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(x):
    return to_tensor(np.asarray(x), "cpu")


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cfg_pair(dtype="float32"):
    cfg_j, cfg_t = j_arch(ARCH).smoke, t_arch(ARCH).smoke
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    return cfg_j, cfg_t


def enc_inputs(n, seed, d=64):
    """Encoder inputs (n, d), bf16-representable f32 as the reference's
    ``jax.random.normal(..., bfloat16)`` draws are."""
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def model():
    """The reference's f32 smoke: teacher params (key 0), codes (key 1),
    random non-zero B factors; carried across."""
    cfg_j, cfg_t = cfg_pair()
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jax.jit(lambda b: jcal.program_model(b, cfg_j.rram, jax.random.PRNGKey(1),
                                                 mode="codes"))(params["base"])
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=3)
    rng = np.random.default_rng(4)
    return {"cfg": (cfg_j, cfg_t), "params": params, "codes": codes,
            "adapters_np": adapters_np,
            "tokens": rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32),
            "enc": np.stack([enc_inputs(S_SRC, 5 + i) for i in range(B)]),
            "params_t": {"base": from_reference(np_tree(params["base"]), "cpu"),
                         "adapters": from_reference(adapters_np, "cpu")},
            "params_j": {"base": params["base"],
                         "adapters": jax.tree_util.tree_map(jnp.asarray, adapters_np)}}


def test_config_and_registry():
    """Both spellings resolve; the reference's source length; the encoder
    stacked over its layers as the reference's scan stacks it (a list under
    ``unroll``); an RG-LRU mixer is refused without its config and
    accepted with it, as an SSM one is."""
    arch = t_arch("seamless-m4t-large-v2")
    assert arch is t_arch(ARCH) and arch.enc_src_len == j_arch(ARCH).enc_src_len == 4096
    assert (arch.full.encoder_layers, arch.full.n_layers) == (24, 24)
    params = TT.init_params(torch.Generator().manual_seed(0), arch.smoke)
    want = jax.eval_shape(lambda k: JT.init_params(k, j_arch(ARCH).smoke), jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
    assert shapes == jax.tree_util.tree_map(lambda x: tuple(x.shape), want)
    assert params["base"]["encoder"]["mixer"]["q"]["w"].shape == (2, 64, 64)
    assert set(params["base"]["body"][0]) == {"norm1", "mixer", "norm_x", "xattn", "norm2", "ffn"}
    unrolled = TT.init_params(torch.Generator().manual_seed(0),
                              dataclasses.replace(arch.smoke, unroll=True))
    assert len(unrolled["base"]["encoder"]) == 2
    with pytest.raises(ValueError, match="needs cfg.rglru"):
        TT._check_supported(dataclasses.replace(arch.smoke, mixer_pattern=("rglru",)))
    TT._check_supported(dataclasses.replace(arch.smoke, mixer_pattern=("rglru",),
                                            rglru=t_arch("recurrentgemma-9b").smoke.rglru))
    TT._check_supported(dataclasses.replace(arch.smoke, mixer_pattern=("ssm",),
                                            ssm=t_arch("falcon-mamba-7b").smoke.ssm))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(model, dtype):
    """The full forward (encoder, decoder self- and cross-attention, head)
    on the teacher with its side-cars; in f32 also the codes deployment
    under ``codes`` (merged side-cars, the prepared tree: the kernels'
    plain versions here, the reference's Pallas kernels in interpret
    mode)."""
    cfg_j, cfg_t = cfg_pair(dtype)
    params = model["params_j"]
    if dtype == "bfloat16":
        like = jax.eval_shape(lambda k: JT.init_params(k, cfg_j), jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(lambda x, s: x.astype(s.dtype), params, like)
    batch_j = {"tokens": jnp.asarray(model["tokens"]), "enc_embeds": jnp.asarray(model["enc"])}
    batch_t = {"tokens": t(model["tokens"]).long(), "enc_embeds": t(model["enc"])}
    want = jax.jit(lambda p, b: JT.forward(p, b, cfg_j))(params, batch_j)
    with torch.no_grad():
        got = TT.forward({"base": from_reference(np_tree(params["base"]), "cpu"),
                          "adapters": from_reference(np_tree(params["adapters"]), "cpu")},
                         batch_t, cfg_t)
    bound = F32_BOUND if dtype == "float32" else BF16_BOUND
    assert rel_err(got.float().numpy(), want) <= bound
    if dtype == "bfloat16":
        return
    merged_j = jcal.merge_adapters_for_serve(model["codes"], params["adapters"])
    prep_j = jsub.prepare_base_for_serve(model["codes"], merged_j, cfg_j)
    codes_t = from_reference(np_tree(model["codes"]), "cpu")
    merged_t = tcal.merge_adapters_for_serve(codes_t, model["params_t"]["adapters"])
    prep_t = tprep.prepare_base_for_serve(codes_t, merged_t, cfg_t)
    with jsub.use_backend("codes"):  # the backend is chosen at trace time
        want = jax.jit(lambda p, b: JT.forward(p, b, cfg_j))(
            {"base": prep_j, "adapters": merged_j}, batch_j)
    with tsub.use_backend("codes"), torch.no_grad():
        got = TT.forward({"base": prep_t, "adapters": merged_t}, batch_t, cfg_t)
    assert rel_err(got.numpy(), want) <= F32_BOUND


def test_prepared_tree_keeps_cross_attention_unfused(model):
    """``prepare_base_for_serve``: the encoder's and the decoder's
    self-attention fuse q/k/v (``_qkv``, scan-stacked), the decoder's
    ``xattn`` keeps its four leaves, as the reference's tree does; the
    fused operands bitwise the reference's."""
    cfg_j, cfg_t = model["cfg"]
    merged_j = jcal.merge_adapters_for_serve(model["codes"], model["params_j"]["adapters"])
    prep_j = jsub.prepare_base_for_serve(model["codes"], merged_j, cfg_j)
    codes_t = from_reference(np_tree(model["codes"]), "cpu")
    prep_t = tprep.prepare_base_for_serve(
        codes_t, tcal.merge_adapters_for_serve(codes_t, model["params_t"]["adapters"]), cfg_t)
    layer = prep_t["body"][0]
    assert set(layer["mixer"]) == set(prep_j["body"][0]["mixer"]) == {"_qkv", "o"}
    assert set(layer["xattn"]) == set(prep_j["body"][0]["xattn"]) == {"q", "k", "v", "o"}
    assert set(prep_t["encoder"]["mixer"]) == {"_qkv", "o"}
    assert tuple(prep_t["encoder"]["mixer"]["_qkv"]["w"].g_pos.shape) == (2, 64, 192)
    for where in (("body", 0, "mixer", "_qkv"), ("body", 0, "xattn", "q"),
                  ("encoder", "mixer", "_qkv"), ("encoder", "ffn", "up")):
        pj, pt = prep_j, prep_t
        for key in where:
            pj, pt = pj[key], pt[key]
        for field in ("g_pos", "g_neg", "scale", "lora_a", "lora_b"):
            np.testing.assert_array_equal(getattr(pt["w"], field).numpy(),
                                          np.asarray(getattr(pj["w"], field)), err_msg=str(where))


def test_encode_and_encode_into_cache_match_reference(model):
    """``encode`` and ``encode_into_cache``: each decoder layer's ``xk``/
    ``xv`` over the first S_SRC of SRC_LEN positions (the tail zero, as
    ``init_cache`` left it) and ``enc_len``; the cache's tree, shapes and
    dtypes the reference's (``enc_len`` int32); ``write_cache_slot`` carries
    the lines and ``enc_len`` into a slot."""
    cfg_j, cfg_t = model["cfg"]
    pj, pt = model["params_j"], model["params_t"]
    cache_j = JT.init_cache(cfg_j, B, MAX_LEN, src_len=SRC_LEN)
    want, cache_j = jax.jit(lambda p, c, e: (
        JT.encode(p["base"], p["adapters"], e, cfg_j), JT.encode_into_cache(p, c, e, cfg_j)))(
        pj, cache_j, jnp.asarray(model["enc"]))
    with torch.no_grad():
        got = TT.encode(pt["base"], pt["adapters"], t(model["enc"]), cfg_t)
    assert rel_err(got.numpy(), want) <= F32_BOUND
    cache_t = TT.init_cache(cfg_t, B, MAX_LEN, "cpu", SRC_LEN)
    spec = jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype.name), cache_j)
    assert jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")), cache_t) == spec
    with torch.no_grad():
        out = TT.encode_into_cache(pt, cache_t, t(model["enc"]), cfg_t)
    assert out is cache_t and cache_t["enc_len"].tolist() == [S_SRC] * B
    for got_l, want_l in zip(TT._cache_layers(cache_t, cfg_t),
                             [jax.tree_util.tree_map(lambda x: x[g], cache_j["body"])[0]
                              for g in range(cfg_j.n_layers)]):
        for name in ("xk", "xv"):
            assert not got_l[name][:, S_SRC:].any()
            assert rel_err(got_l[name].numpy(), want_l[name]) <= F32_BOUND, name
    flat, one = TT.init_flat_cache(cfg_t, 1, MAX_LEN, "cpu", SRC_LEN)
    with torch.no_grad():
        TT.encode_into_cache(pt, one, t(model["enc"][1:]), cfg_t)
    assert one["enc_len"].dtype == torch.int32 and int(one["enc_len"][0]) == S_SRC
    assert flat.clone().view(-1)[-1:].numel() == 1  # the int32 lies inside the buffer
    flat_b, big = TT.init_flat_cache(cfg_t, B, MAX_LEN, "cpu", SRC_LEN)
    TT.write_cache_slot(big, one, 1)
    assert big["enc_len"].tolist() == [0, S_SRC]
    np.testing.assert_array_equal(big["body"][0]["xk"][:, 1].numpy(),
                                  cache_t["body"][0]["xk"][:, 1].numpy())
    flat_b.zero_()
    assert big["enc_len"].tolist() == [0, 0]  # one op zeroes the whole cache


def test_decode_loop_matches_reference(model):
    """A token-by-token ``decode_step`` loop after each row's own
    ``encode_into_cache`` (rows with 7 and 4 valid source positions in a
    12-position buffer, ``write_cache_slot`` into the batch), against the
    reference's loop, as ``tests/test_models.py``'s
    ``test_decode_matches_forward_encdec`` runs it, with side-cars (f32)."""
    cfg_j, cfg_t = model["cfg"]
    pj, pt = model["params_j"], model["params_t"]
    lens = (S_SRC, 4)
    cache_j = JT.init_cache(cfg_j, B, S, src_len=SRC_LEN)
    cache_t = TT.init_cache(cfg_t, B, S, "cpu", SRC_LEN)
    admit = jax.jit(lambda p, c, e: JT.encode_into_cache(p, c, e, cfg_j))
    for b, n in enumerate(lens):  # each row's own encoder admission
        one_j = admit(pj, JT.init_cache(cfg_j, 1, S, src_len=SRC_LEN),
                      jnp.asarray(model["enc"][b:b + 1, :n]))
        cache_j = JT.write_cache_slot(cache_j, one_j, b)
        one_t = TT.init_cache(cfg_t, 1, S, "cpu", SRC_LEN)
        with torch.no_grad():
            TT.encode_into_cache(pt, one_t, t(model["enc"][b:b + 1, :n]), cfg_t)
        TT.write_cache_slot(cache_t, one_t, b)
    assert cache_t["enc_len"].tolist() == list(lens)
    step = jax.jit(lambda p, c, tok, i: JT.decode_step(p, c, tok, i, cfg_j))
    tokens = model["tokens"]
    for i in range(S):
        lj, cache_j = step(pj, cache_j, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        with torch.no_grad():
            lt, cache_t = TT.decode_step(pt, cache_t, t(tokens[:, i:i + 1]).long(), i, cfg_t)
        assert rel_err(lt.numpy(), lj) <= F32_BOUND, i


def test_chunked_admission_matches_the_fused_prefill(model):
    """A prompt admitted chunk by chunk (padded tails) after
    ``encode_into_cache`` on a SRC_LEN buffer gives, at each chunk's last
    position, the logits of the fused ``prefill`` (exact-length cross
    lines) and of the reference's prefill; after the last chunk the self
    cache equals the fused prefill's and both caches' cross lines agree
    (f32)."""
    cfg_j, cfg_t = model["cfg"]
    pj, pt = model["params_j"], model["params_t"]
    tokens, enc = model["tokens"][:1], model["enc"][:1]
    want, _ = jax.jit(lambda p, x, e: JT.prefill(p, x, cfg_j, MAX_LEN, e))(
        pj, jnp.asarray(tokens), jnp.asarray(enc))
    with torch.no_grad():
        full = TT.forward(pt, {"tokens": t(tokens).long(), "enc_embeds": t(enc)}, cfg_t)
        logits, fused = TT.prefill(pt, t(tokens).long(), cfg_t, MAX_LEN, t(enc))
        assert rel_err(logits.numpy(), want) <= F32_BOUND
        assert fused["body"][0]["xk"].shape[2] == S_SRC and fused["enc_len"].tolist() == [S_SRC]
        cache = TT.init_cache(cfg_t, 1, MAX_LEN, "cpu", SRC_LEN)
        TT.encode_into_cache(pt, cache, t(enc), cfg_t)
        for a, b in ((0, 3), (3, 9), (9, S)):
            chunk = torch.zeros((1, 8), dtype=torch.int64)
            chunk[0, :b - a] = t(tokens[0, a:b])
            out, _ = TT.prefill_chunk(pt, chunk, cache, a, b - a, cfg_t, MAX_LEN)
            assert rel_err(out[0, 0].numpy(), full[0, b - 1].numpy()) <= F32_BOUND, (a, b)
    assert rel_err(out.numpy(), want) <= F32_BOUND
    for got, ref in zip(TT._cache_layers(cache, cfg_t), TT._cache_layers(fused, cfg_t)):
        for name in ("k", "v"):
            assert rel_err(got[name].numpy(), ref[name].numpy()) <= F32_BOUND, name
        for name in ("xk", "xv"):
            assert rel_err(got[name][:, :S_SRC].numpy(), ref[name].numpy()) <= F32_BOUND, name


def test_padded_cross_lines_match_exact_length(model):
    """``cross_attention_cached`` over a SRC_LEN buffer whose rows hold 7
    and 3 valid positions: each row bitwise itself alone over the same
    buffer (rows are independent), and within ``F32_BOUND`` of its
    exact-length lines and of the inline ``attention(kv_input=)``, which
    are bitwise each other (the padded tail's exp is 0 exactly, but the
    f32 denominator and ``probs @ V`` reduce over 12 positions instead of
    7 or 3, grouped otherwise: up to 7e-7 apart here)."""
    cfg_t = model["cfg"][1]
    xcfg = TT._attn_cfg(cfg_t, "attn", cross=True)
    lb = tree_lib.index(model["params_t"]["base"]["body"], 0)[0]["xattn"]
    la = tree_lib.index(model["params_t"]["adapters"]["body"], 0)[0]["xattn"]
    x = torch.randn((B, 3, 64), generator=torch.Generator().manual_seed(0))
    lens = (S_SRC, 3)
    with torch.no_grad():
        cache = TA.init_cross_cache(B, SRC_LEN, xcfg, "cpu", torch.float32)
        enc = t(model["enc"])
        k, v = TA.cross_kv(enc, lb, la, xcfg, cfg_t.adapter)
        cache["xk"][:, :S_SRC], cache["xv"][:, :S_SRC] = k, v
        got = TA.cross_attention_cached(x, cache, torch.tensor(lens), lb, la, xcfg, cfg_t.adapter)
        for b, n in enumerate(lens):
            row = {name: cache[name][b:b + 1] for name in ("xk", "xv")}
            alone = TA.cross_attention_cached(x[b:b + 1], row, torch.tensor([n]), lb, la, xcfg,
                                              cfg_t.adapter)
            exact = {"xk": k[b:b + 1, :n], "xv": v[b:b + 1, :n]}
            one = TA.cross_attention_cached(x[b:b + 1], exact, torch.tensor([n]), lb, la, xcfg,
                                            cfg_t.adapter)
            inline = TA.attention(x[b:b + 1], lb, la, xcfg, cfg_t.adapter,
                                  kv_input=enc[b:b + 1, :n])
            assert torch.equal(got[b:b + 1], alone) and torch.equal(one, inline), b
            assert rel_err(alone.numpy(), one.numpy()) <= F32_BOUND, b


def test_teacher_features_and_losses_match_reference(model):
    """On the reference's calibration batch (tokens and bf16 encoder inputs
    of ``seq_len`` frames): ``teacher_features``'s ``enc``, ``enc_out``,
    ``dec``, ``head_in`` and ``head_out``; the cached loss and the fused
    ``feature_calibration_loss`` (encoder terms first, ``n_terms`` =
    encoder + decoder layers + the head) and the cached loss's gradients
    over every side-car, the encoder's and ``xattn``'s included (f32, the
    codes read back under ``dequant``); the fused loss, term for term the
    cached one, at the reference's cached loss."""
    cfg_j, cfg_t = model["cfg"]
    batch_j = j_calibration_batch(cfg_j, 3, 8)
    assert batch_j["enc_embeds"].shape == (3, 8, 64)
    batch_t = {"tokens": t(batch_j["tokens"]).long(), "enc_embeds": t(batch_j["enc_embeds"])}
    assert batch_t["enc_embeds"].dtype == torch.bfloat16
    base_j, base_t = model["params"]["base"], model["params_t"]["base"]
    feats_j = jax.jit(lambda b, x: jcal.teacher_features(b, x, cfg_j))(base_j, batch_j)
    feats_t = tcal.teacher_features(base_t, batch_t, cfg_t)
    assert set(feats_t) == set(feats_j) == {"enc", "enc_out", "dec", "head_in", "head_out"}
    assert tuple(feats_t["enc"].shape) == (3, 3, 8, 64)
    for name in feats_j:
        assert rel_err(feats_t[name].numpy(), feats_j[name]) <= F32_BOUND, name
    codes_t = from_reference(np_tree(model["codes"]), "cpu")
    ad_j, ad_t = model["params_j"]["adapters"], model["params_t"]["adapters"]
    loss_j = jcal.make_cached_calib_loss(cfg_j)
    with jsub.use_backend("dequant"):
        lj, gj = jax.jit(jax.value_and_grad(
            lambda ad: loss_j(ad, model["codes"], feats_j, batch_j)))(ad_j)
    with tsub.use_backend("dequant"):
        loss_t = tcal.make_cached_calib_loss(cfg_t)
        lt, gt = tcal.value_and_grad(lambda ad: loss_t(ad, codes_t, feats_t, batch_t), ad_t)
        ft, _ = TT.feature_calibration_loss(base_t, codes_t, ad_t, batch_t, cfg_t)
    assert float(lt) == pytest.approx(float(lj), rel=F32_RTOL)
    assert float(ft) == pytest.approx(float(lj), rel=F32_RTOL)
    gj, gt = np_tree(gj), port_np(gt)
    assert gt["encoder"]["mixer"]["q"]["lora_b"].shape == (2, 4, 64)
    for path in (("encoder", "mixer", "q"), ("encoder", "ffn", "down"),
                 ("body", 0, "xattn", "k"), ("body", 0, "xattn", "o"), ("lm_head",)):
        w, g = gj, gt
        for key in path:
            w, g = w[key], g[key]
        for leaf in w:
            scale = max(np.abs(w[leaf]).max(), 1e-12)
            assert np.abs(g[leaf] - w[leaf]).max() <= 1e-4 * scale, (path, leaf)


def test_calibrate_and_logit_mse_with_encoder_inputs():
    """``Deployment.calibrate`` on the port alone: its calibration batch
    carries bf16 encoder inputs of ``seq_len`` frames, drawn again equal;
    the feature MSE falls through the compiled step; ``logit_mse`` feeds
    the encoder inputs through."""
    cfg = t_arch(ARCH).smoke
    batch = calibration_batch(cfg, 4, 8)
    assert batch["enc_embeds"].shape == (4, 8, 64) and batch["enc_embeds"].dtype == torch.bfloat16
    assert torch.equal(batch["enc_embeds"], calibration_batch(cfg, 4, 8)["enc_embeds"])
    dep = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24)
    drifted = dep.logit_mse(batch)
    report = dep.calibrate(batch, steps=4)
    assert report.final_loss < report.initial_loss
    assert dep.logit_mse(batch) < drifted


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _deployments(model, backend):
    cfg_j, cfg_t = model["cfg"]
    dep_j = JDeployment(cfg_j, backend, model["params"]["base"], model["codes"],
                        model["params_j"]["adapters"], jax.random.PRNGKey(0),
                        jax.random.PRNGKey(1))
    dep_t = Deployment.from_arrays(cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes),
                                   model["adapters_np"], backend=backend, device="cpu")
    return dep_j, dep_t


def _near_tie(session_j, prompt, enc, ref, got):
    """Equal streams, or a split where the reference's top-2 logits lie
    within ``F32_BOUND`` of their absmax."""
    if list(got) == list(ref):
        return
    j = next(i for i, (a, b) in enumerate(zip(ref, got)) if a != b)
    seq = np.concatenate([prompt, np.asarray(ref[:j], np.int32)])[None]
    with session_j.scope():
        logits = np.asarray(JT.forward(session_j.params, {
            "tokens": jnp.asarray(seq), "enc_embeds": jnp.asarray(enc)[None]},
            session_j.cfg)[0, -1], np.float32)
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] <= F32_BOUND * np.abs(logits).max(), (ref, got)


def _record_slots(engine):
    """Wrap ``engine._finalize_admission`` to keep, per request, its slot's
    cross lines (every decoder layer) and ``enc_len`` as admitted."""
    engine.admitted_lines = {}
    finalize = engine._finalize_admission

    def record(slot, req):
        finalize(slot, req)
        engine.admitted_lines[req.rid] = (
            {name: engine.cache["body"][0][name][:, slot].clone() for name in ("xk", "xv")},
            int(engine.cache["enc_len"][slot]))

    engine._finalize_admission = record


@pytest.mark.parametrize("backend", ["dequant", "codes"])
def test_engine_ragged_staggered_matches_reference(model, backend):
    """The reference's ``test_ragged_staggered_parity_encdec`` traffic (max_len
    24, prompts of 5, 9 and 3 tokens and encoder inputs of 3, 4 and 2
    frames, src_len 4, 2 slots, chunks of 4, staggered submits, 5 tokens
    each), greedy, on both engines over the same deployment: the same
    tokens; each slot's cross lines, as admitted, bitwise
    ``encode_into_cache`` of its request alone; and each stream the
    request's served alone through ``generate`` at its exact source
    length."""
    dep_j, dep_t = _deployments(model, backend)
    s_j, s_t = dep_j.serve(), dep_t.serve()
    vocab = model["cfg"][0].vocab
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(50 + i), (n,), 0, vocab))
               for i, n in enumerate((5, 9, 3))]
    encs = [enc_inputs(n, 200 + i) for i, n in enumerate((3, 4, 2))]
    streams = []
    for engine_cls, session in ((JEngine, s_j), (ServeEngine, s_t)):
        engine = engine_cls(session, max_slots=2, max_len=24, src_len=4, prefill_chunk=4,
                            min_bucket=4)
        if engine_cls is ServeEngine:
            _record_slots(engine)
        reqs = []
        for p, e in zip(prompts, encs):
            reqs.append(engine.submit(p, max_new=5, enc_embeds=e))
            engine.step()
            engine.step()
        engine.run()
        assert all(r.done and len(r.tokens) == 5 for r in reqs)
        streams.append([list(r.tokens) for r in reqs])
    for p, e, ref, got in zip(prompts, encs, *streams):
        _near_tie(s_j, p, e, ref, got)
    cfg_t = dep_t.cfg
    for rid, e in enumerate(encs):
        lines, enc_len = engine.admitted_lines[rid]
        assert enc_len == len(e)
        cache = TT.init_cache(cfg_t, 1, 24, "cpu", 4)
        with s_t.scope(), torch.no_grad():
            TT.encode_into_cache(s_t.params, cache, t(e)[None], cfg_t)
        for name in ("xk", "xv"):
            assert torch.equal(lines[name][:, :len(e)], cache["body"][0][name][:, 0, :len(e)])
    for p, e, got in zip(prompts, encs, streams[1]):
        alone, _ = s_t.generate(torch.as_tensor(p)[None], gen_len=5, enc_embeds=e[None])
        assert list(alone[0]) == got


def test_submit_validation():
    """The reference's ``test_engine_submit_validation`` cases for an
    encoder: an engine without ``src_len``, a request without encoder
    input or longer than ``src_len``, and an encoder input to a
    decoder-only config."""
    session = Deployment.program(t_arch(ARCH).smoke, 0, device="cpu").serve()
    with pytest.raises(ValueError, match="src_len"):
        ServeEngine(session)
    engine = ServeEngine(session, max_slots=1, max_len=16, src_len=4)
    with pytest.raises(ValueError, match="enc_embeds"):
        engine.submit(np.zeros(2, np.int32), max_new=2)
    with pytest.raises(ValueError, match="src_len"):
        engine.submit(np.zeros(2, np.int32), max_new=2,
                      enc_embeds=np.zeros((6, 64), np.float32))
    dec = Deployment.program(t_arch("qwen3_1_7b").smoke, 0, device="cpu").serve()
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(dec, max_slots=1, max_len=8).submit(
            np.zeros(2, np.int32), max_new=2, enc_embeds=np.zeros((4, 64), np.float32))
    with pytest.raises(ValueError, match="src_len"):  # no encoder input: no extent
        session.generate(torch.zeros((1, 2), dtype=torch.int64), gen_len=2)
    with pytest.raises(ValueError, match="enc_embeds"):
        session.prefill(torch.zeros((1, 2), dtype=torch.int64), 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_chain_with_encoder_bytes_is_the_reference_s(dtype):
    """The chain seeded with the encoder input's bytes in the dtype given
    (numpy f32, or ml_dtypes bf16) is the reference's, byte for byte; it
    differs from the chain of the same prompt with another encoder input
    or none."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 512, (9,))
    enc = np.asarray(jnp.asarray(rng.standard_normal((5, 64)), getattr(jnp, dtype)))
    ref = JEngine._hash_chain(None, JRequest(rid=0, prompt=prompt.astype(np.int32), max_new=1,
                                             enc_embeds=enc))
    got = ServeEngine._hash_chain(Request(rid=0, prompt=prompt, max_new=1, enc_embeds=enc))
    assert got == ref and len(got) == 10
    other = enc.copy()
    other[4, 63] = -other[4, 63] if other[4, 63] else 1
    for e in (other, None):
        chain = ServeEngine._hash_chain(Request(rid=0, prompt=prompt, max_new=1, enc_embeds=e))
        assert not set(chain) & set(got)


def test_prefix_full_hit_is_bitwise_cold_admission():
    """A prompt resubmitted whole with the same encoder input runs no
    chunk and no encoder admission, and equals its cold admission bitwise:
    the staged cache (cross lines and ``enc_len`` included), the admission
    logits, the slot's cache row after the run, every token (4-token
    chunks, src_len 8). The same prompt with another encoder input misses."""
    cfg = t_arch(ARCH).smoke
    session = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24).serve()
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (10,))
    enc = enc_inputs(6, 9)
    kw = {"src_len": 8}

    def serve(engine, e=enc):
        submit = type(engine).submit
        engine.submit = lambda p, **k: submit(engine, p, enc_embeds=e, **k)
        return _serve(engine, prompt)

    cold = serve(_engine(session, entries=0, **kw))
    engine = _engine(session, **kw)
    encodes = []
    encode = engine._encode
    engine._encode = lambda req: encodes.append(req.rid) or encode(req)
    first = serve(engine)
    chunks = engine.prefill_chunks
    full = serve(engine)
    assert full[0].prefix_hit_tokens == len(prompt) and engine.prefill_chunks == chunks
    assert encodes == [first[0].rid]
    assert _bitwise(first, cold) and _bitwise(full, cold)
    assert int(engine._staging["enc_len"][0]) == 6
    miss = serve(engine, enc_inputs(6, 10))
    assert miss[0].prefix_hit_tokens == 0 and encodes == [first[0].rid, miss[0].rid]
