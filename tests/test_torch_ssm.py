"""Port parity: the Mamba-1 selective SSM (``repro_torch.models.ssm``), the
attention-free stack around it (``repro_torch.models.transformer``'s
``ssm`` branches: the forward, the fused prefill, the decode tick, the
calibration features and losses) and the engine's unchunked admission,
against ``repro`` at the falcon-mamba-7b smoke config (d 64, d_inner 128,
state 8, conv 4, chunk 16, 4 layers, an untied head of 512), on the
reference's params (key 0), codes (key 1) and random non-zero adapter B
factors, carried across with ``repro_torch.interop``.

Bounds, relative to the reference's absmax:

* ``F32_BOUND`` (1e-5, ``test_torch_model``'s): f32 tensors whose only
  difference is the order of the scan's products and of the sums (the
  scan, the block, the model, its caches and features). The port's scan
  regroups the products within a chunk otherwise than the reference's
  ``associative_scan``, and XLA's f32 ``exp`` and ``log1p`` differ from
  PyTorch's in the last bit;
* ``BF16_BOUND`` (3e-2, ``test_torch_model``'s): the block in bf16 as
  shipped;
* the losses ``F32_RTOL`` (1e-4, ``test_torch_calibrate``'s) and their
  gradients 1e-4 of each leaf's absmax; ``Deployment.calibrate``'s losses
  ``F32_RTOL`` per step;
* the prefill logits of the int8 and codes_adc bodies ``QUANT_BOUND``
  (5e-2, ``chip_smoke.py``'s ``LOGITS_BOUND``): one step of a row's s8
  code or of a tile's ADC level moves that row by ~1%;
* ``_causal_conv`` and ``conv_tail`` against the reference's eager calls,
  a full prefix hit against cold admission, the engine's streams against
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
from repro.deploy import serving as jserving
from repro.deploy.deployment import calibration_batch as j_calibration_batch
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import substrate as tsub
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.deploy import Deployment, ServeEngine
from repro_torch.deploy import serving as tserving
from repro_torch.interop import from_reference, to_tensor
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

from test_torch_calibrate import F32_RTOL, port_np
from test_torch_model import BF16_BOUND, F32_BOUND, np_tree, random_lora_b
from test_torch_prefix import GEN as PREFIX_GEN
from test_torch_prefix import _cold, _engine, _serve
from test_torch_serve import assert_streams_match

ARCH = "falcon_mamba_7b"
B, S, GEN = 2, 20, 6   # S > chunk 16: the model's scan runs two chunks, the second padded
# the quantizing bodies against the reference's: a last-bit difference of
# an activation upstream (the scan's regrouping) may move a row's s8 code
# or a tile's ADC level by one step, which moves that row's logits by ~1%
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
    """The reference's f32 smoke: teacher params (key 0, jitted init),
    codes (key 1), random non-zero B factors; carried across."""
    cfg_j, cfg_t = cfg_pair()
    params = jax.jit(lambda k: JT.init_params(k, cfg_j))(jax.random.PRNGKey(0))
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


def _layer(params, i=0):
    """Layer ``i``'s mixer (base, adapters) of a stacked tree."""
    base = jax.tree_util.tree_map(lambda x: x[i], params["base"]["body"][0]["mixer"])
    ad = jax.tree_util.tree_map(lambda x: x[i], params["adapters"]["body"][0]["mixer"])
    return base, ad


# ---------------------------------------------------------------------------
# the config and the module
# ---------------------------------------------------------------------------


def test_config_registry_and_refusals():
    """Both spellings resolve; the published widths; the smoke's layer
    tree the reference's; ``_check_supported`` accepts the SSM stack,
    refuses an ssm or rglru mixer without its config (the SSM config is
    no RG-LRU one); ``_chunk_block`` refuses an ssm layer with the
    reference's message."""
    arch = t_arch("falcon-mamba-7b")
    assert arch is t_arch(ARCH)
    full = arch.full
    assert (full.n_layers, full.d_model, full.vocab, full.tie_lm_head) == (64, 4096, 65024,
                                                                           False)
    assert (full.ssm.d_inner, full.ssm.state_dim, full.ssm.conv_kernel, full.ssm.chunk,
            full.ssm.dt_rank_) == (8192, 16, 4, 256, 256)
    TT._check_supported(full)
    params = TT.init_params(torch.Generator().manual_seed(0), arch.smoke)
    want = jax.eval_shape(lambda k: JT.init_params(k, j_arch(ARCH).smoke), jax.random.PRNGKey(0))
    shape = jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)), params)
    assert shape == jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), "torch." + str(x.dtype)), want)
    with pytest.raises(ValueError, match="needs cfg.ssm"):
        TT._check_supported(dataclasses.replace(full, ssm=None))
    with pytest.raises(ValueError, match="needs cfg.rglru"):
        TT._check_supported(dataclasses.replace(full, mixer_pattern=("rglru",)))
    cfg = arch.smoke
    lb = TT.tree_lib.index(params["base"]["body"], 0)[0]
    msg = "chunked prefill supports attention mixers only, got 'ssm'"
    with pytest.raises(ValueError) as err:
        TT._chunk_block(torch.zeros((1, 4, 64)), {}, 0, 4, lb, {}, cfg, "ssm", "none",
                        max_len=8)
    assert str(err.value) == msg
    with pytest.raises(ValueError, match="attention mixers only") as ref_err:
        JT._chunk_block(jnp.zeros((1, 4, 64)), {}, 0, 4, {"norm1": {"scale": jnp.ones(64)}},
                        {}, j_arch(ARCH).smoke, "ssm", "none", max_len=8)
    assert str(ref_err.value) == msg


def _scan_inputs(s, seed, d=16, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, d)) * 0.5 - 1.0)).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1)))
    b = rng.standard_normal((B, s, n)).astype(np.float32)
    c = rng.standard_normal((B, s, n)).astype(np.float32)
    d_skip = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    h0 = rng.standard_normal((B, d, n)).astype(np.float32)
    return x, dt, a_log, b, c, d_skip, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 40])
def test_selective_scan_matches_reference(s, with_h0):
    """The chunked scan (chunk 16: one chunk, a whole one, one padded, three
    with the last padded) against the reference's ``selective_scan`` and
    ``selective_scan_ref``; the port's ``selective_scan_ref`` against the
    reference's: y and h_final within ``F32_BOUND``."""
    x, dt, a_log, b, c, d_skip, h0 = _scan_inputs(s, seed=s)
    h0 = h0 if with_h0 else None
    args_j = [jnp.asarray(v) for v in (x, dt, a_log, b, c, d_skip)]
    args_t = [t(v) for v in (x, dt, a_log, b, c, d_skip)]
    hj = None if h0 is None else jnp.asarray(h0)
    ht = None if h0 is None else t(h0)
    want = JS.selective_scan(*args_j, chunk=16, h0=hj)
    want_ref = jref.selective_scan_ref(*args_j, h0=hj)
    got = TS.selective_scan(*args_t, chunk=16, h0=ht)
    got_ref = tref.selective_scan_ref(*args_t, h0=ht)
    assert tuple(got[0].shape) == (B, s, 16) and tuple(got[1].shape) == (B, 16, 8)
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, w in ((got, want), (got, want_ref), (got_ref, want_ref)):
        for gi, wi in zip(g, w):
            assert rel_err(gi.numpy(), wi) <= F32_BOUND


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 3, 9])
def test_causal_conv_and_conv_tail_bitwise(s, dtype):
    """``_causal_conv`` (f32 taps in the reference's order, rounded once)
    and ``conv_tail`` (zeros on the left below K - 1 positions) bitwise the
    reference's eager calls."""
    rng = np.random.default_rng(s)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, s, 32)), getattr(jnp, dtype)))
    w = rng.standard_normal((4, 32)).astype(np.float32) * 0.5
    bias = rng.standard_normal(32).astype(np.float32) * 0.1
    want = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = TS._causal_conv(t(x), t(w), t(bias))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    tail = TS.conv_tail(t(x), 4)
    assert tail.dtype == torch.float32 and tuple(tail.shape) == (B, 3, 32)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(JS.conv_tail(jnp.asarray(x), 4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_and_decode_match_reference(model, dtype):
    """``ssm_block`` over 20 positions (two chunks) with its returned
    cache, then two ``ssm_decode`` steps from that cache (in place), on
    layer 0's params and side-cars: out, ``h`` and ``conv`` against the
    reference's."""
    cfg_j, cfg_t = cfg_pair(dtype)
    base_j, ad_j = _layer(model["params_j"])
    if dtype == "bfloat16":
        base_j = dict(base_j)
        for name in TS._LEAVES:
            base_j[name] = {"w": base_j[name]["w"].astype(jnp.bfloat16)}
    base_t, ad_t = from_reference(np_tree(base_j), "cpu"), from_reference(np_tree(ad_j), "cpu")
    jdt = getattr(jnp, dtype)
    x = np.asarray(jnp.asarray(np.random.default_rng(5).standard_normal((B, S, 64)), jdt))
    block_j = jax.jit(lambda v, b, a: JS.ssm_block(v, b, a, cfg_j.ssm, cfg_j.adapter,
                                                    return_state=True))
    decode_j = jax.jit(lambda v, c, b, a: JS.ssm_decode(v, c, b, a, cfg_j.ssm, cfg_j.adapter))
    out_j, cache_j = block_j(jnp.asarray(x), base_j, ad_j)
    with torch.no_grad():
        out_t, cache_t = TS.ssm_block(t(x), base_t, ad_t, cfg_t.ssm, cfg_t.adapter,
                                      return_state=True)
    bound = F32_BOUND if dtype == "float32" else BF16_BOUND
    assert out_t.dtype == getattr(torch, dtype)
    assert rel_err(out_t.float().numpy(), out_j) <= bound
    for name in ("h", "conv"):
        assert cache_t[name].dtype == torch.float32
        assert rel_err(cache_t[name].numpy(), cache_j[name]) <= bound, name
    cache_t = {k: t(v) for k, v in cache_j.items()}  # decode from the same cache
    for i in range(2):
        step = np.asarray(jnp.asarray(np.random.default_rng(6 + i).standard_normal((B, 1, 64)),
                                      jdt))
        out_j, cache_j = decode_j(jnp.asarray(step), cache_j, base_j, ad_j)
        h_before = cache_t["h"]
        with torch.no_grad():
            out_t, same = TS.ssm_decode(t(step), cache_t, base_t, ad_t, cfg_t.ssm,
                                        cfg_t.adapter)
        assert same is cache_t and cache_t["h"] is h_before  # in place
        assert rel_err(out_t.float().numpy(), out_j) <= bound, i
        for name in ("h", "conv"):
            assert rel_err(cache_t[name].numpy(), cache_j[name]) <= bound, (i, name)


def test_params_carried_across_and_init_draws(model):
    """``from_reference`` carries the reference's SSM params leaf for leaf
    (shapes, dtypes, bits); ``init_ssm`` given draws places them as the
    reference's init does (the leaves' normals scaled by d_in^-0.5, the
    conv taps by K^-0.5, A = -(1..N), D = 1, the dt bias the inverse
    softplus of U(1e-3, 1e-1))."""
    cfg_j, cfg_t = model["cfg"]
    base_j, _ = _layer(model["params_j"])
    base_t = TT.tree_lib.index(model["params_t"]["base"]["body"], 0)[0]["mixer"]
    assert set(base_t) == set(base_j) == set(TS._LEAVES) | {"conv_w", "conv_b", "a_log",
                                                            "d_skip", "dt_bias"}
    for name, want in np_tree(base_j).items():
        got = port_np(base_t[name])
        want = want if isinstance(want, dict) else {"": want}
        got = got if isinstance(got, dict) else {"": got}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)
    ssm = cfg_t.ssm
    rng = np.random.default_rng(9)
    draws = {name: t(rng.standard_normal(shape).astype(np.float32))
             for name, shape in TS._leaf_shapes(ssm).items()}
    draws.update({f"{name}/lora_a": t(rng.uniform(size=(d_in, 4)).astype(np.float32))
                  for name, (d_in, _) in TS._leaf_shapes(ssm).items()})
    draws["conv_w"] = t(rng.standard_normal((4, ssm.d_inner)).astype(np.float32))
    draws["dt"] = t(rng.uniform(size=ssm.d_inner).astype(np.float32))
    base, adapters = TS.init_ssm(None, ssm, cfg_t.adapter, torch.float32, draws=draws)
    for name, (d_in, _) in TS._leaf_shapes(ssm).items():
        torch.testing.assert_close(base[name]["w"], draws[name] * d_in ** -0.5, rtol=0, atol=0)
        assert set(adapters[name]) == {"lora_a", "lora_b", "dora_m"}
    torch.testing.assert_close(base["conv_w"], draws["conv_w"] * 0.5, rtol=0, atol=0)
    np.testing.assert_allclose(base["a_log"].numpy(), np.asarray(base_j["a_log"]), rtol=2e-7)
    np.testing.assert_array_equal(base["d_skip"].numpy(), np.ones(ssm.d_inner, np.float32))
    dt = torch.nn.functional.softplus(base["dt_bias"].double()).numpy()
    assert np.all((dt > 1e-3 * 0.999) & (dt < 1e-1 * 1.001))
    np.testing.assert_allclose(dt, 1e-3 + draws["dt"].double().numpy() * (1e-1 - 1e-3),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_prefill_and_decode_loop_match_reference(model):
    """The forward (f32, side-cars on), the fused ``prefill`` (last logits,
    every layer's ``h`` and ``conv``) and a ``decode_step`` loop from it
    against the reference's; the prefill's cache fits the flat buffer
    bitwise (one copy in, one copy out)."""
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
    layers_j = [jax.tree_util.tree_map(lambda x: x[g], cache_j["body"])[0]
                for g in range(cfg_j.n_layers)]
    for got_l, want_l in zip(TT._cache_layers(cache_t, cfg_t), layers_j):
        assert set(got_l) == set(want_l) == {"h", "conv"}
        for name in ("h", "conv"):
            assert rel_err(got_l[name].numpy(), want_l[name]) <= F32_BOUND, name
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
            assert dst.dtype == torch.float32 and torch.equal(dst, src)
    step = jax.jit(lambda p, c, tok, i: JT.decode_step(p, c, tok, i, cfg_j))
    nxt = np.random.default_rng(6).integers(0, cfg_j.vocab, (B, GEN)).astype(np.int32)
    for i in range(GEN):
        lj, cache_j = step(pj, cache_j, jnp.asarray(nxt[:, i:i + 1]), jnp.int32(S + i))
        with torch.no_grad():
            lt, cache_t = TT.decode_step(pt, cache_t, t(nxt[:, i:i + 1]).long(), S + i, cfg_t)
        assert rel_err(lt.numpy(), lj) <= F32_BOUND, i


def test_prefill_matches_token_loop(model):
    """Twin of the reference's ``test_fused_prefill_matches_token_loop``
    for the SSM stack: the fused prefill and a token-by-token decode loop
    give the same last logits and states (within the scan's rounding,
    ``F32_BOUND``) and the same greedy continuation."""
    cfg_j, cfg_t = model["cfg"]
    pt = {"base": model["params_t"]["base"], "adapters": {}}
    toks = t(model["tokens"]).long()
    with torch.no_grad():
        lf, cache_f = TT.prefill(pt, toks, cfg_t, S + 4)
        cache_l = TT.init_cache(cfg_t, B, S + 4, "cpu")
        for i in range(S):
            ll, cache_l = TT.decode_step(pt, cache_l, toks[:, i:i + 1], i, cfg_t)
        assert rel_err(lf.numpy(), ll.numpy()) <= F32_BOUND
        for a, b in zip(TT.tree_lib.tensors(cache_f), TT.tree_lib.tensors(cache_l)):
            assert rel_err(a.numpy(), b.numpy()) <= F32_BOUND
        tf = tl = None
        for i in range(4):
            tf, tl = lf.argmax(-1), ll.argmax(-1)
            assert torch.equal(tf, tl), i
            lf, cache_f = TT.decode_step(pt, cache_f, tf, S + i, cfg_t)
            ll, cache_l = TT.decode_step(pt, cache_l, tl, S + i, cfg_t)


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
    """The fused prefill's logits of the codes deployment's session,
    ``serve()`` (the f32 body over the prepared tree, unfused: each of the
    four leaves one launch), ``serve(accum="int8")`` and a codes_adc
    deployment's (raw codes), against the reference's sessions over the
    same codes and side-cars (its Pallas kernels in interpret mode)."""
    dep_j, dep_t = _deployments(model, "codes_adc" if body == "codes_adc" else "codes")
    opts = {"accum": body} if body != "codes_adc" else {}
    s_j, s_t = dep_j.serve(**opts), dep_t.serve(**opts)
    if body != "codes_adc":
        mixer = TT.tree_lib.index(s_t.params["base"]["body"], 0)[0]["mixer"]
        assert set(k for k in mixer if isinstance(mixer[k], dict)) == set(TS._LEAVES)
    toks = model["tokens"]
    lj, _ = s_j.prefill(jnp.asarray(toks), S)
    lt, _ = s_t.prefill(t(toks).long(), S)
    assert rel_err(lt.numpy(), lj) <= (F32_BOUND if body == "f32" else QUANT_BOUND)


def test_teacher_features_losses_and_calibrate_match_reference(model):
    """On the reference's calibration batch: ``teacher_features`` (every
    block's input and the untied head's), the cached loss and its
    gradients over the side-cars of every SSM leaf and the head (f32, the
    codes read back under ``dequant``; the student blocks recomputed in the
    backward), and the fused ``feature_calibration_loss`` (the same terms)
    against the reference's cached loss; then ``Deployment.calibrate`` over
    3 steps (through ``CompiledCalibStep``) on the programmed codes: its
    losses against the reference's, the calibrated ``logit_mse`` below the
    uncalibrated one."""
    cfg_j, cfg_t = model["cfg"]
    batch_j = j_calibration_batch(cfg_j, 3, 20)
    batch_t = {"tokens": t(batch_j["tokens"]).long()}
    base_j, base_t = model["params"]["base"], model["params_t"]["base"]
    feats_j = jax.jit(lambda b, x: jcal.teacher_features(b, x, cfg_j))(base_j, batch_j)
    feats_t = tcal.teacher_features(base_t, batch_t, cfg_t)
    assert set(feats_t) == set(feats_j) == {"dec", "head_in", "head_out"}
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
    paths = [("body", 0, "mixer", name) for name in TS._LEAVES] + [("lm_head",)]
    for path in paths:
        w, g = gj, gt
        for key in path:
            w, g = w[key], g[key]
        for leaf in w:
            scale = max(np.abs(w[leaf]).max(), 1e-12)
            assert np.abs(g[leaf] - w[leaf]).max() <= 1e-4 * scale, (path, leaf)

    dep_j = JDeployment(cfg_j, "codes", base_j, model["codes"], model["params"]["adapters"],
                        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    dep_t = Deployment.from_arrays(
        cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes), np_tree(dep_j.adapters),
        backend="codes", device="cpu")
    batch_j = j_calibration_batch(cfg_j, 4, 8)
    batch_t = {"tokens": t(batch_j["tokens"]).long()}
    drifted = dep_t.logit_mse(batch_t)
    rj, rt = dep_j.calibrate(batch_j, steps=3), dep_t.calibrate(batch_t, steps=3)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=F32_RTOL)
    assert rt.final_loss < rt.initial_loss and dep_t.logit_mse(batch_t) < drifted


def test_student_block_is_recomputed_in_the_backward(model):
    """Under autograd the SSM block keeps only its input for the backward
    (``torch.utils.checkpoint``): on layer 0's codes read back under
    ``dequant``, its gradients equal those of the block run without
    recompute, bitwise. The recompute binds the forward's backend itself:
    the backward runs here outside the scope (on the card the autograd
    engine runs it on a thread of its own, where no scope is bound), and
    the codes backend's kernels would refuse a leaf that requires grad."""
    _, cfg_t = model["cfg"]
    codes = from_reference(np_tree(model["codes"]), "cpu")
    base_t = TT.tree_lib.index(codes["body"], 0)[0]["mixer"]
    ad = TT.tree_lib.index(model["params_t"]["adapters"]["body"], 0)[0]["mixer"]
    ad = TT.tree_lib.map_tensors(lambda x: x.clone().requires_grad_(True), ad)
    x = torch.randn((2, 20, 64), generator=torch.Generator().manual_seed(3))
    saved = []
    with tsub.use_backend("dequant"), torch.autograd.graph.saved_tensors_hooks(
            lambda v: saved.append(v) or v, lambda v: v):
        out = TS.ssm_block(x, base_t, ad, cfg_t.ssm, cfg_t.adapter)
    assert len(saved) <= 2  # the checkpoint keeps its input, not the scan's levels
    leaves = TT.tree_lib.tensors(ad)
    got = torch.autograd.grad(out.square().sum(), leaves)
    with tsub.use_backend("dequant"):
        plain = TS._ssm_forward(x, base_t, ad, cfg_t.ssm, cfg_t.adapter)[0]
    want = torch.autograd.grad(plain.square().sum(), leaves)
    assert torch.equal(out, plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine: unchunked admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dequant", "codes"])
def test_engine_streams_match_generate_and_reference(model, backend):
    """Ragged, staggered traffic (the reference's ``_ragged_staggered_check``
    shape: 2 slots, max_len 32, prompts of 5, 11 and 3 tokens from its
    keys, 6 greedy tokens each, two steps between submits): every stream
    equals its request's plain ``serving.generate`` loop at batch 1; each
    admission is one fused prefill (no chunk counted); the counters and
    admission ticks are the reference engine's and its tokens equal or
    split at a near-tie; the session compiled its decode tick and one
    fused-prefill step per prompt length."""
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
            reqs.append(engine.submit(p, max_new=GEN))
            engine.step()
            engine.step()
        engine.run()
        assert all(r.done and len(r.tokens) == GEN for r in reqs)
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
                                         gen_len=GEN)
        assert list(alone[0]) == g
    assert {s.key[0] for s in s_t.steps} == {"decode", "prefill"}


def _bitwise(a, b):
    """``test_torch_prefix._bitwise`` over the staged buffer's bytes: the
    f32 state in a bf16 buffer reads as NaNs there, which never compare
    equal as bf16."""
    (ra, (ca, la), rowa), (rb, (cb, lb), rowb) = a, b
    return (ra.tokens == rb.tokens and torch.equal(ca.view(torch.uint8), cb.view(torch.uint8))
            and torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(rowa, rowb)))


def test_prefix_full_hit_is_bitwise_cold_and_no_partial_hit():
    """Twin of the reference's ``test_prefix_cache_full_hit_nonchunked``:
    a prompt resubmitted whole runs no prefill and equals its cold
    admission bitwise (the staged state, the admission logits, the slot's
    cache row after the run, every token); a longer prompt sharing its
    first 7 tokens is not served from the snapshot (no partial hit); a
    recycled slot's state is overwritten by its next admission."""
    cfg = t_arch(ARCH).smoke
    session = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24).serve()
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, (7,))
    longer = np.concatenate([prompt, rng.integers(0, cfg.vocab, (3,))])
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
