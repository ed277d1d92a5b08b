"""Port parity: the dense model (``repro_torch.models``) against
``repro.models.transformer`` on the same carried-across parameters, codes
and adapters, under the ``dequant`` backend (float read-back of the
codes) and the ``codes`` backend (prepared, fused tree -> the crossbar
kernel; the reference runs its Pallas kernels in interpret mode).

The adapters' B factors are random and non-zero on both sides, so the
low-rank path counts. Two bounds, both relative to the reference
logits' absmax:

* float32 config: ``F32_BOUND`` — checks the algorithm (the only
  differences are f32 summation order);
* bfloat16 as shipped: ``BF16_BOUND`` — checks what actually runs; bf16
  rounds at different places in the two frameworks (fused vs unfused
  elementwise chains, matmul accumulation), and those flips compound
  over 4 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.configs import get_arch as j_arch
from repro.core import calibrate as jcal
from repro.core import rram as jr
from repro.deploy.deployment import _dequant_like as j_dequant_like
from repro.models import transformer as JT
from repro_torch import substrate as tsub
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.deploy.deployment import _dequant_like as t_dequant_like
from repro_torch.interop import from_reference
from repro_torch.models import transformer as TT

F32_BOUND = 1e-5
BF16_BOUND = 3e-2

B, S, MAX_LEN = 2, 12, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    """Reference tree -> numpy tree (``CrossbarWeight`` -> its dict)."""
    if isinstance(tree, jr.CrossbarWeight):
        return {k: np.asarray(getattr(tree, k)) for k in ("g_pos", "g_neg", "scale")}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree)


def random_lora_b(adapters, seed):
    """Replace every lora_b by random non-zero values (numpy tree)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05
                        if k == "lora_b" else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(adapters)


def build_pair(dtype):
    """Reference and port param sets for both backends, same numbers."""
    cfg_j = j_arch("qwen3_1_7b").smoke
    cfg_t = t_arch("qwen3_1_7b").smoke
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jcal.program_model(params["base"], cfg_j.rram, jax.random.PRNGKey(1),
                               mode="codes")
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=7)
    adapters_j = jax.tree_util.tree_map(jnp.asarray, adapters_np)
    merged_j = jcal.merge_adapters_for_serve(codes, adapters_j)
    ref = {
        "dequant": {"base": j_dequant_like(codes, params["base"]), "adapters": merged_j},
        "codes": {"base": jsub.prepare_base_for_serve(codes, merged_j, cfg_j),
                  "adapters": merged_j},
    }
    base_t = from_reference(np_tree(params["base"]), "cpu")
    codes_t = from_reference(np_tree(codes), "cpu")
    merged_t = tcal.merge_adapters_for_serve(codes_t, from_reference(adapters_np, "cpu"))
    port = {
        "dequant": {"base": t_dequant_like(codes_t, base_t), "adapters": merged_t},
        "codes": {"base": tsub.prepare_base_for_serve(codes_t, merged_t, cfg_t),
                  "adapters": merged_t},
    }
    return cfg_j, cfg_t, ref, port


def run_reference(cfg, params, backend, tokens, chunk):
    out = {}
    with jsub.use_backend(backend):
        out["forward"] = JT.forward(params, {"tokens": jnp.asarray(tokens)}, cfg)
        logits, cache = JT.prefill(params, jnp.asarray(tokens), cfg, MAX_LEN)
        out["prefill"] = logits
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out["decode_step"], _ = JT.decode_step(params, cache, nxt,
                                               jnp.full((B,), S, jnp.int32), cfg)
        toks, pos0, n_valid = chunk
        c = JT.init_cache(cfg, B, MAX_LEN)
        out["prefill_chunk"], _ = JT.prefill_chunk(
            params, jnp.asarray(toks), c, jnp.asarray(pos0), jnp.asarray(n_valid),
            cfg, MAX_LEN)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}, np.array(nxt)


def run_port(cfg, params, backend, tokens, chunk, nxt):
    out = {}
    with tsub.use_backend(backend), torch.no_grad():
        t = torch.as_tensor(tokens, dtype=torch.int64)
        out["forward"] = TT.forward(params, {"tokens": t}, cfg)
        logits, cache = TT.prefill(params, t, cfg, MAX_LEN)
        out["prefill"] = logits
        out["decode_step"], _ = TT.decode_step(
            params, cache, torch.as_tensor(nxt, dtype=torch.int64),
            torch.full((B,), S, dtype=torch.int64), cfg)
        toks, pos0, n_valid = chunk
        c = TT.init_cache(cfg, B, MAX_LEN, "cpu")
        out["prefill_chunk"], _ = TT.prefill_chunk(
            params, torch.as_tensor(toks, dtype=torch.int64), c,
            torch.as_tensor(pos0), torch.as_tensor(n_valid), cfg, MAX_LEN)
    return {k: v.to(torch.float32).numpy() for k, v in out.items()}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def results(request):
    cfg_j, cfg_t, ref, port = build_pair(request.param)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32)
    chunk = (rng.integers(0, cfg_j.vocab, (B, 8)).astype(np.int32),
             np.zeros((B,), np.int32), np.asarray([8, 5], np.int32))
    out = {}
    for backend in ("dequant", "codes"):
        r, nxt = run_reference(cfg_j, ref[backend], backend, tokens, chunk)
        p = run_port(cfg_t, port[backend], backend, tokens, chunk, nxt)
        out[backend] = (r, p)
    return request.param, out


@pytest.mark.parametrize("fn", ["forward", "prefill", "prefill_chunk", "decode_step"])
@pytest.mark.parametrize("backend", ["dequant", "codes"])
def test_logits_match_reference(results, backend, fn):
    dtype, out = results
    r, p = out[backend]
    ref, got = r[fn], p[fn]
    assert got.shape == ref.shape and np.isfinite(got).all()
    bound = (F32_BOUND if dtype == "float32" else BF16_BOUND) * np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= bound, f"{dtype} {backend} {fn}: max |diff| {err:.3g} > {bound:.3g}"


def test_codes_and_dequant_agree_in_port(results):
    """The kernel path and the float read-back serve the same numbers."""
    dtype, out = results
    bound = (F32_BOUND if dtype == "float32" else BF16_BOUND)
    for fn in ("forward", "prefill", "prefill_chunk", "decode_step"):
        a, b = out["codes"][1][fn], out["dequant"][1][fn]
        assert np.abs(a - b).max() <= bound * np.abs(b).max(), fn


def test_primitives_match_reference():
    """rms/layer norm, rope and the embedding gather, f32 and bf16."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    pos = np.asarray([[0, 3, 7, 8, 100], [1, 2, 3, 4, 5]], np.int32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 1e-2)):
        xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        pairs = [
            (JL.rms_norm(xj, {"scale": jnp.asarray(scale)}),
             TL.rms_norm(xt, {"scale": torch.from_numpy(scale)})),
            (JL.layer_norm(xj, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}),
             TL.layer_norm(xt, {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})),
            (JL.apply_rope(xj, jnp.asarray(pos), 1e6),
             TL.apply_rope(xt, torch.from_numpy(pos).long(), 1e6)),
        ]
        for want, got in pairs:
            assert got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)
    table = rng.standard_normal((11, 4)).astype(np.float32)
    toks = np.asarray([[3, 0, 10]], np.int32)
    np.testing.assert_array_equal(
        TL.embed(torch.from_numpy(toks).long(), {"embedding": torch.from_numpy(table)}).numpy(),
        np.asarray(JL.embed(jnp.asarray(toks), {"embedding": jnp.asarray(table)}, one_hot=True)))


@pytest.mark.parametrize("window", [None, 3])
def test_masks_match_reference(window):
    from repro.models import attention as JA
    from repro_torch.models import attention as TA

    np.testing.assert_array_equal(TA.causal_mask(4, 9, window).numpy(),
                                  np.asarray(JA.causal_mask(4, 9, window)))
    pos = np.asarray([0, 2, 5, 9], np.int32)
    np.testing.assert_array_equal(
        TA._cache_mask(torch.from_numpy(pos).long(), 6, window).numpy(),
        np.asarray(JA._cache_mask(jnp.asarray(pos), 6, window)))


def test_unrolled_layout_forward_matches_reference():
    """``unroll=True`` puts every layer in the prologue list (no stacked
    body): the same forward over a different tree layout."""
    cfg_j = dataclasses.replace(j_arch("qwen3_1_7b").smoke, dtype=jnp.float32, unroll=True)
    cfg_t = dataclasses.replace(t_arch("qwen3_1_7b").smoke, dtype=torch.float32, unroll=True)
    assert cfg_t.body_layout() == cfg_j.body_layout() == (4, 0, 0)
    params = JT.init_params(jax.random.PRNGKey(2), cfg_j)
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=2)
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab, (1, 6)).astype(np.int32)
    want = JT.forward({"base": params["base"],
                       "adapters": jax.tree_util.tree_map(jnp.asarray, adapters_np)},
                      {"tokens": jnp.asarray(toks)}, cfg_j)
    with torch.no_grad():
        got = TT.forward({"base": from_reference(np_tree(params["base"]), "cpu"),
                          "adapters": from_reference(adapters_np, "cpu")},
                         {"tokens": torch.from_numpy(toks).long()}, cfg_t)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= F32_BOUND * np.abs(want).max()
