"""Port parity: the RG-LRU block (``repro_torch.models.rglru``), the hybrid
stack around it (``repro_torch.models.transformer``'s ``rglru`` branches
beside ``local`` attention with a rolling cache: the forward, the fused
prefill, the decode tick, the calibration features and losses) and the
engine's unchunked admission, against ``repro`` at the recurrentgemma-9b
smoke config (d 64, d_rnn 64, conv 4, 8 layers: two (rglru, rglru, local)
groups and two epilogue rglru layers, local window 8, a tied head of
512), on the reference's params (key 0), codes (key 1) and random
non-zero adapter B factors, carried across with ``repro_torch.interop``.

Bounds, relative to the reference's absmax:

* ``F32_BOUND`` (1e-5, ``test_torch_model``'s): f32 tensors whose only
  difference is the order of the scan's products and of the sums (the
  scan, the block, the model, its caches and features). The port's
  log-depth scan regroups the products otherwise than the reference's
  ``associative_scan``, and XLA's f32 ``exp``, ``log`` and ``logistic``
  differ from PyTorch's in the last bit;
* ``BF16_BOUND`` (3e-2, ``test_torch_model``'s): the block in bf16 as
  shipped;
* the losses ``F32_RTOL`` (1e-4, ``test_torch_calibrate``'s) and their
  gradients 1e-4 of each leaf's absmax; ``Deployment.calibrate``'s losses
  ``F32_RTOL`` per step;
* the prefill logits of the int8 and codes_adc bodies ``QUANT_BOUND``
  (5e-2, ``chip_smoke.py``'s ``LOGITS_BOUND``): one step of a row's s8
  code or of a tile's ADC level moves that row by ~1%;
* ``init_lambda``: the decay it sets, ``a = sigmoid(Lambda)``, within 2
  ulps of the reference's at every channel, and ``Lambda`` itself within
  1e-4 relative. ``torch.linspace`` and ``jnp.linspace`` differ by 1 ulp
  at some channels and the two ``pow`` differ in the last bit; ``log(a /
  (1 - a))`` then amplifies that (``1 - a`` is ~1.2e-4 at the top
  channel), up to a few hundred ulps of ``Lambda`` at 4096 channels
  (4.7e-5 relative). The parity tests carry the reference's ``Lambda``
  across;
* the conv window the block leaves (``conv_tail``), a full prefix hit
  against cold admission, the engine's streams against
  ``serving.generate`` per request: exact; the engine's tokens against
  the reference engine's: equal or split at a near-tie (``F32_BOUND``)."""
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
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro_torch import substrate as tsub
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.deploy import Deployment, ServeEngine
from repro_torch.deploy import serving as tserving
from repro_torch.interop import from_reference, to_tensor
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT

from test_torch_calibrate import F32_RTOL, port_np
from test_torch_model import BF16_BOUND, F32_BOUND, np_tree, random_lora_b
from test_torch_prefix import GEN as PREFIX_GEN
from test_torch_prefix import _cold, _engine, _serve
from test_torch_serve import assert_streams_match
from test_torch_ssm import _bitwise

ARCH = "recurrentgemma_9b"
B, S, GEN = 2, 6, 10   # S + GEN = the cache's 16 positions: the window of 8 wraps in decode
LOOP_S = 12            # the token-loop prompt: its fused prefill wraps the rolling buffers
QUANT_BOUND = 5e-2


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


@pytest.fixture(scope="module")
def model():
    """The reference's f32 smoke: teacher params (key 0, an eager init: at 8
    layers its jit compile takes longer than the eager calls), codes (key
    1), random non-zero B factors; carried across."""
    cfg_j, cfg_t = cfg_pair()
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jax.jit(lambda b: jcal.program_model(b, cfg_j.rram, jax.random.PRNGKey(1),
                                                 mode="codes"))(params["base"])
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=3)
    rng = np.random.default_rng(4)
    return {"cfg": (cfg_j, cfg_t), "params": params, "codes": codes,
            "adapters_np": adapters_np,
            "tokens": rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32),
            "params_t": {"base": from_reference(np_tree(params["base"]), "cpu"),
                         "adapters": from_reference(adapters_np, "cpu")},
            "params_j": {"base": params["base"],
                         "adapters": jax.tree_util.tree_map(jnp.asarray, adapters_np)}}


def _layer(params, g=0, j=0):
    """Scan group ``g``'s layer ``j`` mixer (base, adapters) of a stacked
    tree: layer 0 is an rglru one."""
    base = jax.tree_util.tree_map(lambda x: x[g], params["base"]["body"][j]["mixer"])
    ad = jax.tree_util.tree_map(lambda x: x[g], params["adapters"]["body"][j]["mixer"])
    return base, ad


# ---------------------------------------------------------------------------
# the config and the module
# ---------------------------------------------------------------------------


def test_config_registry_and_refusals():
    """Both spellings resolve; the published widths; the body layout of 8
    and 38 layers; the smoke's param tree (shapes and dtypes) the
    reference's ``jax.eval_shape``; ``_check_supported`` accepts the
    hybrid stack and refuses an rglru mixer without its config;
    ``_chunk_block`` refuses an rglru layer with the reference's message."""
    arch = t_arch("recurrentgemma-9b")
    assert arch is t_arch(ARCH)
    full = arch.full
    assert (full.n_layers, full.d_model, full.vocab, full.tie_lm_head, full.local_window) == (
        38, 4096, 256000, True, 2048)
    assert (full.rglru.d_rnn, full.rglru.conv_kernel, full.mlp.d_ff, full.mlp.activation) == (
        4096, 4, 12288, "gelu_tanh")
    assert (full.attn.num_heads, full.attn.num_kv_heads, full.attn.head_dim) == (16, 1, 256)
    assert full.body_layout() == (0, 12, 2)
    assert dataclasses.replace(full, n_layers=8).body_layout() == (0, 2, 2)
    TT._check_supported(full)
    params = TT.init_params(torch.Generator().manual_seed(0), arch.smoke)
    want = jax.eval_shape(lambda k: JT.init_params(k, j_arch(ARCH).smoke), jax.random.PRNGKey(0))
    shape = jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)), params)
    assert shape == jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), "torch." + str(x.dtype)), want)
    with pytest.raises(ValueError, match="an rglru mixer needs cfg.rglru"):
        TT._check_supported(dataclasses.replace(full, rglru=None))
    cfg = arch.smoke
    lb = TT.tree_lib.index(params["base"]["body"], 0)[0]
    msg = "chunked prefill supports attention mixers only, got 'rglru'"
    with pytest.raises(ValueError) as err:
        TT._chunk_block(torch.zeros((1, 4, 64)), {}, 0, 4, lb, {}, cfg, "rglru", "mlp",
                        max_len=8)
    assert str(err.value) == msg
    with pytest.raises(ValueError, match="attention mixers only") as ref_err:
        JT._chunk_block(jnp.zeros((1, 4, 64)), {}, 0, 4, {"norm1": {"scale": jnp.ones(64)}},
                        {}, j_arch(ARCH).smoke, "rglru", "mlp", max_len=8)
    assert str(ref_err.value) == msg


def _combine(left, right):
    (al, bl), (ar, br) = left, right
    return al * ar, ar * bl + br


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_scan_matches_associative_scan_and_step_by_step(s, with_h0):
    """``scan_pairs`` (the log-depth scan over the whole sequence) against
    the reference's ``jax.lax.associative_scan`` of the same pairs and
    against ``rglru_scan_ref`` (step by step), ``rglru_scan_ref`` against
    the associative scan, and the port's last state: every ``h`` within
    ``F32_BOUND``."""
    rng = np.random.default_rng(s)
    a_t = np.exp(-np.log1p(np.exp(rng.standard_normal((B, s, 32))))).astype(np.float32)
    b_t = rng.standard_normal((B, s, 32)).astype(np.float32)
    h0 = rng.standard_normal((B, 32)).astype(np.float32) if with_h0 else None
    a_cum, b_cum = jax.lax.associative_scan(_combine, (jnp.asarray(a_t), jnp.asarray(b_t)),
                                            axis=1)
    want = np.asarray(b_cum if h0 is None else a_cum * jnp.asarray(h0)[:, None] + b_cum)
    ht = None if h0 is None else t(h0)
    got = TR.scan_pairs(t(a_t), t(b_t), ht)
    got_ref, last = tref.rglru_scan_ref(t(a_t), t(b_t), ht)
    assert tuple(got.shape) == (B, s, 32) and got.dtype == torch.float32
    assert torch.equal(last, got_ref[:, -1])
    for g in (got, got_ref):
        assert rel_err(g.numpy(), want) <= F32_BOUND
    assert rel_err(got.numpy(), got_ref.numpy()) <= F32_BOUND


def test_rglru_scan_with_gates_matches_reference(model):
    """``rglru_scan`` (the gates through layer 0's side-cars, the decay and
    its multiplier in the reference's form, then the scan) against the
    reference's ``_rglru_scan``, from zeros and from an ``h0``."""
    cfg_j, cfg_t = model["cfg"]
    base_j, ad_j = _layer(model["params_j"])
    base_t, ad_t = from_reference(np_tree(base_j), "cpu"), from_reference(np_tree(ad_j), "cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 9, 64)).astype(np.float32)
    h0 = rng.standard_normal((B, 64)).astype(np.float32)
    for h in (None, h0):
        want, want_last = jax.jit(lambda v, b, a, h_: JR._rglru_scan(v, b, a, cfg_j.adapter,
                                                                    h0=h_))(
            jnp.asarray(x), base_j, ad_j, None if h is None else jnp.asarray(h))
        with torch.no_grad():
            got, last = TR.rglru_scan(t(x), base_t, ad_t, cfg_t.adapter,
                                      h0=None if h is None else t(h))
        assert rel_err(got.numpy(), want) <= F32_BOUND
        assert rel_err(last.numpy(), want_last) <= F32_BOUND


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_and_decode_match_reference(model, dtype):
    """``rglru_block`` over 9 positions with its returned cache, then two
    ``rglru_decode`` steps from the reference's cache (in place), on layer
    0's params and side-cars: out, ``h`` and ``conv`` against the
    reference's; the block's ``conv`` bitwise the reference's
    ``conv_tail`` of the port's own ``in_x`` projection (the window a
    decode continues from)."""
    cfg_j, cfg_t = cfg_pair(dtype)
    base_j, ad_j = _layer(model["params_j"])
    if dtype == "bfloat16":
        base_j = dict(base_j)
        for name in TR._LEAVES:
            base_j[name] = {"w": base_j[name]["w"].astype(jnp.bfloat16)}
    base_t, ad_t = from_reference(np_tree(base_j), "cpu"), from_reference(np_tree(ad_j), "cpu")
    jdt = getattr(jnp, dtype)
    x = np.asarray(jnp.asarray(np.random.default_rng(5).standard_normal((B, 9, 64)), jdt))
    block_j = jax.jit(lambda v, b, a: JR.rglru_block(v, b, a, cfg_j.rglru, cfg_j.adapter,
                                                     return_state=True))
    decode_j = jax.jit(lambda v, c, b, a: JR.rglru_decode(v, c, b, a, cfg_j.rglru,
                                                          cfg_j.adapter))
    out_j, cache_j = block_j(jnp.asarray(x), base_j, ad_j)
    with torch.no_grad():
        out_t, cache_t = TR.rglru_block(t(x), base_t, ad_t, cfg_t.rglru, cfg_t.adapter,
                                        return_state=True)
        xb_raw = TL.linear(t(x), base_t["in_x"], ad_t["in_x"], cfg_t.adapter)
    bound = F32_BOUND if dtype == "float32" else BF16_BOUND
    assert out_t.dtype == getattr(torch, dtype)
    assert rel_err(out_t.float().numpy(), out_j) <= bound
    for name in ("h", "conv"):
        assert cache_t[name].dtype == torch.float32
        assert rel_err(cache_t[name].numpy(), cache_j[name]) <= bound, name
    tail = JR.conv_tail(jnp.asarray(xb_raw.float().numpy()).astype(jdt), 4)
    np.testing.assert_array_equal(cache_t["conv"].numpy(), np.asarray(tail))
    cache_t = {k: t(v) for k, v in cache_j.items()}  # decode from the same cache
    for i in range(2):
        step = np.asarray(jnp.asarray(np.random.default_rng(6 + i).standard_normal((B, 1, 64)),
                                      jdt))
        out_j, cache_j = decode_j(jnp.asarray(step), cache_j, base_j, ad_j)
        h_before = cache_t["h"]
        with torch.no_grad():
            out_t, same = TR.rglru_decode(t(step), cache_t, base_t, ad_t, cfg_t.rglru,
                                          cfg_t.adapter)
        assert same is cache_t and cache_t["h"] is h_before  # in place
        assert rel_err(out_t.float().numpy(), out_j) <= bound, i
        for name in ("h", "conv"):
            assert rel_err(cache_t[name].numpy(), cache_j[name]) <= bound, (i, name)


def test_params_carried_across_and_init_draws(model):
    """``from_reference`` carries the reference's RG-LRU params leaf for
    leaf (shapes, dtypes, bits); ``init_rglru`` given draws places them as
    the reference's init does (the leaves' normals scaled by d_in^-0.5,
    the conv taps by K^-0.5, a zero conv bias); its ``lambda_p`` against
    the reference's at the smoke's 64 channels and the full config's 4096:
    the decay ``sigmoid(lambda_p)`` within 2 ulps, ``lambda_p`` within 1e-4
    relative (the module docstring says why not bitwise)."""
    cfg_j, cfg_t = model["cfg"]
    base_j, _ = _layer(model["params_j"])
    base_t = TT.tree_lib.index(model["params_t"]["base"]["body"], 0)[0]["mixer"]
    assert set(base_t) == set(base_j) == set(TR._LEAVES) | {"conv_w", "conv_b", "lambda_p"}
    for name, want in np_tree(base_j).items():
        got = port_np(base_t[name])
        want = want if isinstance(want, dict) else {"": want}
        got = got if isinstance(got, dict) else {"": got}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)
    rg = cfg_t.rglru
    rng = np.random.default_rng(9)
    draws = {name: t(rng.standard_normal(shape).astype(np.float32))
             for name, shape in TR._leaf_shapes(rg).items()}
    draws.update({f"{name}/lora_a": t(rng.uniform(size=(d_in, 4)).astype(np.float32))
                  for name, (d_in, _) in TR._leaf_shapes(rg).items()})
    draws["conv_w"] = t(rng.standard_normal((4, rg.d_rnn)).astype(np.float32))
    base, adapters = TR.init_rglru(None, rg, cfg_t.adapter, torch.float32, draws=draws)
    for name, (d_in, _) in TR._leaf_shapes(rg).items():
        torch.testing.assert_close(base[name]["w"], draws[name] * d_in ** -0.5, rtol=0, atol=0)
        assert set(adapters[name]) == {"lora_a", "lora_b", "dora_m"}
    torch.testing.assert_close(base["conv_w"], draws["conv_w"] * 0.5, rtol=0, atol=0)
    assert not base["conv_b"].any()
    # jitted, XLA drops the full width's unused leaf draws
    full_lambda = jax.jit(lambda k: JR.init_rglru(k, JR.RglruConfig(4096, 4096),
                                                  cfg_j.adapter)[0]["lambda_p"])
    for d, want in ((rg.d_rnn, np.asarray(base_j["lambda_p"])),
                    (4096, np.asarray(full_lambda(jax.random.PRNGKey(0))))):
        got = TR.init_lambda(d)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0, err_msg=str(d))
        decay = torch.sigmoid(got).numpy()
        decay_ref = np.asarray(jax.nn.sigmoid(jnp.asarray(want)))
        assert np.all(np.abs(decay - decay_ref) <= 2 * np.spacing(decay_ref)), d


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_prefill_and_decode_loop_match_reference(model):
    """The forward (f32, side-cars on), the fused ``prefill`` (last logits,
    every rglru layer's ``h`` and ``conv``, every local layer's rolling
    ``k``/``v``) and a ``decode_step`` loop of 10 tokens from it, in a
    cache of 16 positions (the window of 8 wraps), against the reference's;
    the prefill's cache, f32 state beside bf16 or f32 K/V, fits the flat
    buffer bitwise (one copy in, one copy out)."""
    cfg_j, cfg_t = model["cfg"]
    pj, pt = model["params_j"], model["params_t"]
    toks = model["tokens"]
    want = jax.jit(lambda p, x: JT.forward(p, {"tokens": x}, cfg_j))(pj, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(pt, {"tokens": t(toks).long()}, cfg_t)
    assert rel_err(got.numpy(), want) <= F32_BOUND
    max_len = S + GEN
    lj, cache_j = jax.jit(lambda p, x: JT.prefill(p, x, cfg_j, max_len))(pj, jnp.asarray(toks))
    with torch.no_grad():
        lt, cache_t = TT.prefill(pt, t(toks).long(), cfg_t, max_len)
    assert rel_err(lt.numpy(), lj) <= F32_BOUND

    def cache_layers_j(cache):
        body = [jax.tree_util.tree_map(lambda x: x[g], cache["body"]) for g in range(2)]
        return [lay for grp in body for lay in grp] + list(cache["epilogue"])

    kinds = [m for m, _ in cfg_t.layer_kinds()]
    for got_l, want_l, kind in zip(TT._cache_layers(cache_t, cfg_t), cache_layers_j(cache_j),
                                   kinds):
        names = {"h", "conv"} if kind == "rglru" else {"k", "v"}
        assert set(got_l) == set(want_l) == names
        for name in names:
            assert rel_err(got_l[name].numpy(), want_l[name]) <= F32_BOUND, name
        if kind == "local":
            assert got_l["k"].shape[1] == cfg_t.local_window
    for dtype in (torch.float32, torch.bfloat16):  # f32 leaves aligned in the flat buffer
        cfg_d = dataclasses.replace(cfg_t, dtype=dtype)
        flat, views = TT.init_flat_cache(cfg_d, B, max_len, "cpu")
        for dst, src in zip(TT.tree_lib.tensors(views), TT.tree_lib.tensors(cache_t)):
            dst.copy_(src)
        saved = flat.clone()
        flat.zero_()
        assert not any(v.any() for v in TT.tree_lib.tensors(views))
        flat.copy_(saved)
        for dst, src in zip(TT.tree_lib.tensors(views), TT.tree_lib.tensors(cache_t)):
            assert torch.equal(dst, src.to(dst.dtype))
        for lay, kind in zip(TT._cache_layers(views, cfg_d), kinds):
            for name, v in lay.items():
                assert v.dtype == (torch.float32 if kind == "rglru" else dtype), (kind, name)
    step = jax.jit(lambda p, c, tok, i: JT.decode_step(p, c, tok, i, cfg_j))
    nxt = np.random.default_rng(6).integers(0, cfg_j.vocab, (B, GEN)).astype(np.int32)
    for i in range(GEN):
        lj, cache_j = step(pj, cache_j, jnp.asarray(nxt[:, i:i + 1]), jnp.int32(S + i))
        with torch.no_grad():
            lt, cache_t = TT.decode_step(pt, cache_t, t(nxt[:, i:i + 1]).long(), S + i, cfg_t)
        assert rel_err(lt.numpy(), lj) <= F32_BOUND, i


def test_prefill_matches_token_loop(model):
    """Twin of the reference's ``test_fused_prefill_matches_token_loop``
    for the hybrid stack: a 12-token prompt (its fused prefill writes the
    rolling buffers past the window of 8) and a token-by-token decode loop
    give the same last logits and caches (within the scan's rounding,
    ``F32_BOUND``) and the same greedy continuation of 4 tokens."""
    _, cfg_t = model["cfg"]
    pt = {"base": model["params_t"]["base"], "adapters": {}}
    toks = torch.as_tensor(np.random.default_rng(7).integers(0, cfg_t.vocab, (B, LOOP_S)))
    max_len = LOOP_S + 4
    with torch.no_grad():
        lf, cache_f = TT.prefill(pt, toks, cfg_t, max_len)
        cache_l = TT.init_cache(cfg_t, B, max_len, "cpu")
        for i in range(LOOP_S):
            ll, cache_l = TT.decode_step(pt, cache_l, toks[:, i:i + 1], i, cfg_t)
        assert rel_err(lf.numpy(), ll.numpy()) <= F32_BOUND
        for a, b in zip(TT.tree_lib.tensors(cache_f), TT.tree_lib.tensors(cache_l)):
            assert rel_err(a.float().numpy(), b.float().numpy()) <= F32_BOUND
        for i in range(4):
            tf, tl = lf.argmax(-1), ll.argmax(-1)
            assert torch.equal(tf, tl), i
            lf, cache_f = TT.decode_step(pt, cache_f, tf, LOOP_S + i, cfg_t)
            ll, cache_l = TT.decode_step(pt, cache_l, tl, LOOP_S + i, cfg_t)


def _deployments(model, backend):
    cfg_j, cfg_t = model["cfg"]
    dep_j = JDeployment(cfg_j, backend, model["params"]["base"], model["codes"],
                        model["params_j"]["adapters"], jax.random.PRNGKey(0),
                        jax.random.PRNGKey(1))
    dep_t = Deployment.from_arrays(cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes),
                                   model["adapters_np"], backend=backend, device="cpu")
    return dep_j, dep_t


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_prefill_logits_under_each_body_match_reference(model, body):
    """The fused prefill's logits (a 12-token prompt, past the window) of
    the codes deployment's session, ``serve()`` (the f32 body over the
    prepared tree: the five RG-LRU leaves unfused, ``in_x`` and ``in_y``
    included; q/k/v and gate/up fused), ``serve(accum="int8")`` and a
    codes_adc deployment's (raw codes), against the reference's sessions
    over the same codes and side-cars (its Pallas kernels in interpret
    mode)."""
    dep_j, dep_t = _deployments(model, "codes_adc" if body == "codes_adc" else "codes")
    opts = {"accum": body} if body != "codes_adc" else {}
    s_j, s_t = dep_j.serve(**opts), dep_t.serve(**opts)
    if body != "codes_adc":
        layers = TT.tree_lib.index(s_t.params["base"]["body"], 0)
        mixer = layers[0]["mixer"]
        assert set(k for k in mixer if isinstance(mixer[k], dict)) == set(TR._LEAVES)
        assert set(layers[2]["mixer"]) == {"_qkv", "o"}
        assert set(layers[0]["ffn"]) == {"_gate_up", "down"}
    toks = np.random.default_rng(7).integers(0, model["cfg"][0].vocab, (B, LOOP_S))
    lj, _ = s_j.prefill(jnp.asarray(toks.astype(np.int32)), LOOP_S + 4)
    lt, _ = s_t.prefill(t(toks).long(), LOOP_S + 4)
    assert rel_err(lt.numpy(), lj) <= (F32_BOUND if body == "f32" else QUANT_BOUND)


def test_teacher_features_losses_and_calibrate_match_reference(model):
    """On the reference's calibration batch: ``teacher_features`` (every
    block's input), the cached loss and its gradients over the side-cars
    of the RG-LRU leaves, the local attention's ``q`` and the MLP's
    ``gate`` (f32, the codes read back under ``dequant``), and the fused
    ``feature_calibration_loss`` (the same terms) against the reference's
    cached loss; then ``Deployment.calibrate`` over 3 steps (through
    ``CompiledCalibStep``) on the programmed codes: its losses against the
    reference's, the calibrated ``logit_mse`` below the uncalibrated one.
    The peripherals (``conv_w``, ``conv_b``, ``lambda_p``) take no
    gradient and stay as programmed."""
    cfg_j, cfg_t = model["cfg"]
    batch_j = j_calibration_batch(cfg_j, 3, 12)
    batch_t = {"tokens": t(batch_j["tokens"]).long()}
    base_j, base_t = model["params"]["base"], model["params_t"]["base"]
    feats_j = jax.jit(lambda b, x: jcal.teacher_features(b, x, cfg_j))(base_j, batch_j)
    feats_t = tcal.teacher_features(base_t, batch_t, cfg_t)
    assert set(feats_t) == set(feats_j)
    for name in feats_t:
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
        ft, aux = TT.feature_calibration_loss(base_t, codes_t, ad_t, batch_t, cfg_t)
    assert float(lt) == pytest.approx(float(lj), rel=F32_RTOL)
    assert float(ft) == pytest.approx(float(lj), rel=F32_RTOL)  # the same terms, fused
    assert aux["feature_mse"] is ft
    gj, gt = np_tree(gj), port_np(gt)
    paths = ([("body", 0, "mixer", name) for name in TR._LEAVES]
             + [("body", 2, "mixer", "q"), ("body", 1, "ffn", "gate"),
                ("epilogue", 1, "mixer", "out")])
    for path in paths:
        w, g = gj, gt
        for key in path:
            w, g = w[key], g[key]
        for leaf in w:
            scale = max(np.abs(w[leaf]).max(), 1e-12)
            assert np.abs(g[leaf] - w[leaf]).max() <= 1e-4 * scale, (path, leaf)
    assert set(gt["body"][0]["mixer"]) == set(TR._LEAVES)  # no peripheral trains

    dep_j = JDeployment(cfg_j, "codes", base_j, model["codes"], model["params"]["adapters"],
                        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    dep_t = Deployment.from_arrays(
        cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes), np_tree(dep_j.adapters),
        backend="codes", device="cpu")
    peripherals = [t_.clone() for t_ in TT.tree_lib.tensors(
        {k: dep_t.codes["body"][0]["mixer"][k] for k in ("conv_w", "conv_b", "lambda_p")})]
    batch_j = j_calibration_batch(cfg_j, 4, 8)
    batch_t = {"tokens": t(batch_j["tokens"]).long()}
    drifted = dep_t.logit_mse(batch_t)
    rj, rt = dep_j.calibrate(batch_j, steps=3), dep_t.calibrate(batch_t, steps=3)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=F32_RTOL)
    assert rt.final_loss < rt.initial_loss and dep_t.logit_mse(batch_t) < drifted
    after = TT.tree_lib.tensors(
        {k: dep_t.codes["body"][0]["mixer"][k] for k in ("conv_w", "conv_b", "lambda_p")})
    assert all(torch.equal(a, b) for a, b in zip(after, peripherals))


# ---------------------------------------------------------------------------
# the engine: unchunked admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dequant", "codes"])
def test_engine_streams_match_generate_and_reference(model, backend):
    """Ragged, staggered traffic (the reference's ``_ragged_staggered_check``
    shape: 2 slots, max_len 32, prompts of 5, 11 and 3 tokens from its
    keys, 6 greedy tokens each, two steps between submits; the 11-token
    prompt's admission and every stream past position 8 wrap the local
    layers' rolling buffers): every stream equals its request's plain
    ``serving.generate`` loop at batch 1; each admission is one fused
    prefill (no chunk counted); the counters and admission ticks are the
    reference engine's and its tokens equal or split at a near-tie; the
    session compiled its decode tick and one fused-prefill step per prompt
    length."""
    dep_j, dep_t = _deployments(model, backend)
    s_j, s_t = dep_j.serve(), dep_t.serve()
    vocab = model["cfg"][0].vocab
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(50 + i), (n,), 0, vocab))
               for i, n in enumerate((5, 11, 3))]
    runs = []
    for engine_cls, session in ((JEngine, s_j), (ServeEngine, s_t)):
        engine = engine_cls(session, max_slots=2, max_len=32)
        assert engine.chunked is False
        reqs = []
        for p in prompts:
            reqs.append(engine.submit(p, max_new=6))
            engine.step()
            engine.step()
        engine.run()
        assert all(r.done and len(r.tokens) == 6 for r in reqs)
        stats = engine.stats()
        runs.append(([list(r.tokens) for r in reqs], [r.admitted_tick for r in reqs],
                     {k: stats[k] for k in ("ticks", "prefill_chunks", "first_tokens",
                                            "decode_tokens", "completed", "prefix_lookups",
                                            "prefix_hits")}))
    (ref, ref_ticks, ref_stats), (got, got_ticks, got_stats) = runs
    assert got_stats == ref_stats and got_ticks == ref_ticks
    assert got_stats["prefill_chunks"] == 0
    for p, r, g in zip(prompts, ref, got):
        assert_streams_match(s_j, p, r, g)
    for p, g in zip(prompts, got):
        with s_t.scope():
            alone, _ = tserving.generate(s_t.params, torch.as_tensor(p)[None], s_t.cfg,
                                         gen_len=6)
        assert list(alone[0]) == g
    assert {s.key[0] for s in s_t.steps} == {"decode", "prefill"}


def test_prefix_full_hit_is_bitwise_cold_and_no_partial_hit():
    """Twin of the reference's ``test_prefix_cache_full_hit_nonchunked``
    for the hybrid stack: a 7-token prompt resubmitted whole runs no
    prefill and equals its cold admission bitwise (the staged cache, its
    f32 state and bf16 rolling K/V by their bytes, the admission logits,
    the slot's cache row after the run, every token); a longer prompt
    sharing its first 7 tokens is not served from the snapshot (no partial
    hit); a recycled slot's cache is overwritten by its next admission."""
    cfg = t_arch(ARCH).smoke
    session = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24).serve()
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, (7,))
    longer = np.concatenate([prompt, rng.integers(0, cfg.vocab, (5,))])
    cold = _cold(session, prompt)
    cold_long = _cold(session, longer)
    engine = _engine(session)
    prefills = []
    prefill = engine._prefill
    engine._prefill = lambda req: prefills.append(req.rid) or prefill(req)
    first = _serve(engine, prompt)
    full = _serve(engine, prompt)
    assert full[0].prefix_hit_tokens == len(prompt) and prefills == [first[0].rid]
    assert engine.prefix_hits == 1 and engine.prefill_chunks == 0
    assert _bitwise(first, cold) and _bitwise(full, cold)
    part = _serve(engine, longer)
    assert part[0].prefix_hit_tokens == 0 and engine.prefix_partial_hits == 0
    assert prefills == [first[0].rid, part[0].rid] and _bitwise(part, cold_long)
    ref = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24).serve()
    with ref.scope():
        want, _ = tserving.generate(ref.params, torch.as_tensor(prompt)[None], cfg,
                                    gen_len=PREFIX_GEN)
    assert full[0].tokens == list(want[0])
