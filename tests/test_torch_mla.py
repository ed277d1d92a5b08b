"""Port parity: multi-head latent attention (MLA, ``repro_torch.models.
attention``'s ``_mla_*`` paths and its latent cache), the deepseek-v2-lite
config through ``models/transformer.py``, the serve tree's fused
``_q_kvd`` / ``_kup_vup`` leaves, programming, the feature loss, the
engine and the prefix cache, against ``repro`` at the deepseek-v2-lite
smoke config (d 64, 4 layers: a dense prologue layer and three MoE
layers of 4 experts top-2 with one shared expert; 4 heads, kv_lora 32,
nope 16, rope 8, v 16), on numpy inputs made from a seed and params
carried across with ``repro_torch.interop``.

Bounds, relative to the reference's absmax:

* ``F32_BOUND`` (1e-5, ``test_torch_model``'s): f32 tensors whose only
  difference is the summation order (attention paths, caches, the model);
* ``BF16_BOUND`` (3e-2, ``test_torch_model``'s): the attention paths in
  bf16 as shipped;
* the whole bf16 model: ``test_torch_moe``'s rule (median position within
  ``BF16_BOUND``, Frobenius within ``MOE_BF16_FROB``): a token whose
  router has a near-tie may go to another expert;
* the feature loss ``F32_RTOL`` (1e-4) and its gradients 1e-4 of each
  leaf's absmax (``test_torch_moe``'s);
* codes, the cache layout and ``prefill_kv_cache``: bitwise;
* the engine's greedy tokens (f32): equal under codes; under codes_adc
  equal or split at a near-tie (``F32_BOUND``) of the reference's logits.

The reference's threefry draws cannot be reproduced in torch, so
``_init_mla`` and ``program_model`` are given them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.configs import get_arch as j_arch
from repro.core import calibrate as jcal
from repro.core.dora import AdapterConfig as JAdapterConfig
from repro.deploy import Deployment as JDeployment
from repro.deploy import ServeEngine as JEngine
from repro.deploy import serving as jserving
from repro.deploy.deployment import calibration_batch as j_calibration_batch
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import substrate as tsub
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.core.dora import AdapterConfig as TAdapterConfig
from repro_torch.deploy import Deployment, ServeEngine
from repro_torch.interop import from_reference
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.substrate import prepared as tprep

from test_torch_calibrate import F32_RTOL, port_np, to_port_batch
from test_torch_model import BF16_BOUND, F32_BOUND, np_tree, random_lora_b
from test_torch_moe import (MOE_BF16_FROB, _codes_equal, port_np_codes,
                            ref_program_draws)
from test_torch_prefix import _bitwise, _cold, _engine, _serve
from test_torch_serve import assert_streams_match

ARCH = "deepseek_v2_lite_16b"
MAX_LEN = 24
# (pos0 of each row, n_valid of each row, width): chunks in order on one
# batch-2 cache, rows at other clocks, padded tails
CHUNKS = [((0, 0), (5, 8), 8), ((5, 8), (8, 3), 8), ((13, 11), (2, 6), 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(x):
    return torch.from_numpy(np.array(x))


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cfg_pair(dtype="bfloat16"):
    cfg_j, cfg_t = j_arch(ARCH).smoke, t_arch(ARCH).smoke
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def model():
    """The reference's f32 smoke: teacher params (key 0), codes (key 1),
    random non-zero B factors; carried across."""
    cfg_j, cfg_t = cfg_pair("float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jcal.program_model(params["base"], cfg_j.rram, jax.random.PRNGKey(1),
                               mode="codes")
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=3)
    return {"cfg": (cfg_j, cfg_t), "params": params, "codes": codes,
            "adapters_np": adapters_np,
            "base_t": from_reference(np_tree(params["base"]), "cpu"),
            "codes_t": from_reference(np_tree(codes), "cpu"),
            "adapters_t": from_reference(adapters_np, "cpu")}


# ---------------------------------------------------------------------------
# the attention paths
# ---------------------------------------------------------------------------


def _attn_pair(dtype):
    cfg_j, cfg_t = j_arch(ARCH).smoke.attn, t_arch(ARCH).smoke.attn
    acfg_j, acfg_t = JAdapterConfig(rank=4, kind="dora"), TAdapterConfig(rank=4, kind="dora")
    dj, dt = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    base_j, ad_j = JA.init_attention(jax.random.PRNGKey(0), cfg_j, acfg_j, dj)
    ad_np = random_lora_b(np_tree(ad_j), seed=1)
    return ((cfg_j, acfg_j, base_j, jax.tree_util.tree_map(jnp.asarray, ad_np), dj),
            (cfg_t, acfg_t, from_reference(np_tree(base_j), "cpu"),
             from_reference(ad_np, "cpu"), dt))


def _close(got, want, bound, what):
    assert rel_err(got.float().numpy(), want) <= bound, what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["attention", "decode", "chunk"])
def test_mla_paths_match_reference(path, dtype):
    """``_mla_attention`` (with the latents it returns for the cache),
    ``_mla_decode`` (rows at clocks 7 and 12 of a prefilled cache) and
    ``_mla_chunk`` (``CHUNKS`` in order), with unmerged side-cars whose B
    are non-zero; the decode and chunk caches are written in place."""
    (cj, aj, bj, adj, dj), (ct, at, bt, adt, dt) = _attn_pair(dtype)
    assert ct.scale == cj.scale == 24 ** -0.5
    bound = F32_BOUND if dtype == "float32" else BF16_BOUND
    rng = np.random.default_rng(7)
    if path == "attention":
        x = rng.standard_normal((2, 12, 64)).astype(np.float32)
        y_j, kv_j = jax.jit(lambda x: JA.attention(x, bj, adj, cj, aj, return_kv=True))(
            jnp.asarray(x, dj))
        with torch.no_grad():
            y_t, kv_t = TA.attention(t(x).to(dt), bt, adt, ct, at, return_kv=True)
        assert set(kv_t) == {"c_kv", "k_rope"} and kv_t["c_kv"].shape == (2, 12, 32)
        _close(y_t, y_j, bound, "y")
        for name in kv_t:
            _close(kv_t[name], kv_j[name], bound, name)
        return
    cache_j = JA.init_kv_cache(2, MAX_LEN, cj, dj)
    cache_t = TA.init_kv_cache(2, MAX_LEN, ct, "cpu", dt)
    if path == "decode":
        pre = rng.standard_normal((2, 12, 64)).astype(np.float32)
        _, kv_j = jax.jit(lambda x: JA.attention(x, bj, adj, cj, aj, return_kv=True))(
            jnp.asarray(pre, dj))
        cache_j = JA.prefill_kv_cache(kv_j, 2, MAX_LEN, cj, dj)
        cache_t = TA.prefill_kv_cache({k: t(np.asarray(v, np.float32)).to(dt)
                                       for k, v in kv_j.items()}, 2, MAX_LEN, ct, dt)
        steps = [((7, 12), 1)]
    else:
        steps = [(pos0, (n, w)) for pos0, n, w in CHUNKS]
        ref_chunk = jax.jit(lambda x, c, p, n: JA.chunk_attention(
            x, c, p, n, bj, adj, cj, aj, max_len=MAX_LEN))
    for pos, shape in steps:
        width = 1 if path == "decode" else shape[1]
        x = rng.standard_normal((2, width, 64)).astype(np.float32)
        if path == "chunk":
            for b, n in enumerate(shape[0]):
                x[b, n:] = 0.0
        before = cache_t["c_kv"]
        if path == "decode":
            y_j, cache_j = jax.jit(lambda x, c, p: JA.decode_attention(
                x, c, p, bj, adj, cj, aj))(jnp.asarray(x, dj), cache_j, jnp.asarray(pos))
            with torch.no_grad():
                y_t, new = TA.decode_attention(t(x).to(dt), cache_t, torch.tensor(pos), bt,
                                               adt, ct, at)
            valid = [slice(None)] * 2
        else:
            n = shape[0]
            y_j, cache_j = ref_chunk(jnp.asarray(x, dj), cache_j, jnp.asarray(pos),
                                     jnp.asarray(n))
            with torch.no_grad():
                y_t, new = TA.chunk_attention(t(x).to(dt), cache_t, torch.tensor(pos),
                                              torch.tensor(n), bt, adt, ct, at,
                                              max_len=MAX_LEN)
            valid = [slice(0, k) for k in n]
        assert new["c_kv"] is before  # written in place
        for b in range(2):
            _close(y_t[b, valid[b]], np.asarray(y_j, np.float32)[b, valid[b]], bound,
                   f"y row {b} at {pos}")
        for name in ("c_kv", "k_rope"):
            _close(new[name], np.asarray(cache_j[name], np.float32), bound, name)


def test_init_mla_given_the_reference_draws():
    """``init_attention(draws=)`` under MLA: the reference's normals and A's
    uniforms give its base bitwise (bf16) and its side-cars."""
    cfg_j, cfg_t = j_arch(ARCH).smoke.attn, t_arch(ARCH).smoke.attn
    acfg_j, acfg_t = JAdapterConfig(rank=4, kind="dora"), TAdapterConfig(rank=4, kind="dora")
    key = jax.random.PRNGKey(3)
    base_j, ad_j = JA.init_attention(key, cfg_j, acfg_j)
    keys = jax.random.split(key, 6)
    draws = {}
    for i, name in enumerate(("q", "kv_down", "k_up", "v_up", "o")):
        d_in, d_out = base_j[name]["w"].shape
        kw, ka = jax.random.split(keys[i])
        draws[name] = t(jax.random.normal(kw, (d_in, d_out)))
        draws[f"{name}/lora_a"] = t(jax.random.uniform(ka, (d_in, 4)))
    base_t, ad_t = TA.init_attention(None, cfg_t, acfg_t, draws=draws)
    assert set(base_t) == set(base_j) == {"q", "kv_down", "kv_norm", "k_up", "v_up", "o"}
    np.testing.assert_array_equal(base_t["kv_norm"]["scale"].numpy(),
                                  np.asarray(base_j["kv_norm"]["scale"]))
    for name in ("q", "kv_down", "k_up", "v_up", "o"):
        assert base_t[name]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(base_t[name]["w"].float().numpy(),
                                      np.asarray(base_j[name]["w"], np.float32))
        np.testing.assert_array_equal(ad_t[name]["lora_a"].float().numpy(),
                                      np.asarray(ad_j[name]["lora_a"], np.float32))
        np.testing.assert_allclose(ad_t[name]["dora_m"].float().numpy(),
                                   np.asarray(ad_j[name]["dora_m"], np.float32), rtol=1e-6)


def test_cache_layout_and_prefill_kv_cache_bitwise():
    """The model's decode cache has the reference's tree and shapes (the
    latent and the rope key, stacked over the body's scan groups);
    ``prefill_kv_cache`` of the same latents is bitwise the reference's;
    a windowed MLA cache is refused."""
    cfg_j, cfg_t = cfg_pair()
    want = jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype.name),
                                  JT.init_cache(cfg_j, 2, MAX_LEN))
    got = TT.init_cache(cfg_t, 2, MAX_LEN, "cpu")
    assert tuple(got["body"][0]["c_kv"].shape) == (3, 2, MAX_LEN, 32)
    assert jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype).removeprefix(
        "torch.")), got) == want
    rng = np.random.default_rng(2)
    kv = {"c_kv": rng.standard_normal((2, 10, 32)).astype(np.float32),
          "k_rope": rng.standard_normal((2, 10, 8)).astype(np.float32)}
    ref = JA.prefill_kv_cache({k: jnp.asarray(v) for k, v in kv.items()}, 2, MAX_LEN,
                              cfg_j.attn)
    out = TA.prefill_kv_cache({k: t(v) for k, v in kv.items()}, 2, MAX_LEN, cfg_t.attn)
    for name in kv:
        np.testing.assert_array_equal(out[name].float().numpy(),
                                      np.asarray(ref[name], np.float32))
    with pytest.raises(NotImplementedError, match="window"):
        TA.init_kv_cache(1, 8, dataclasses.replace(cfg_t.attn, window=4), "cpu")
    with pytest.raises(NotImplementedError, match="window"):
        TT._check_supported(dataclasses.replace(cfg_t, mixer_pattern=("swa",)))


def test_chunks_match_the_fused_prefill():
    """A prompt admitted chunk by chunk (padded tails) gives the fused
    prefill's logits at each chunk's last position and, after the last
    chunk, its latent cache (f32, the port alone)."""
    cfg = dataclasses.replace(t_arch(ARCH).smoke, dtype=torch.float32)
    params = TT.init_params(torch.Generator().manual_seed(2), cfg)
    tokens = torch.randint(0, cfg.vocab, (1, 19), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full = TT.forward(params, {"tokens": tokens}, cfg)
        _, fused = TT.prefill(params, tokens, cfg, MAX_LEN)
        cache = TT.init_cache(cfg, 1, MAX_LEN, "cpu")
        for a, b in ((0, 6), (6, 14), (14, 19)):
            chunk = torch.zeros((1, 8), dtype=torch.int64)
            chunk[0, :b - a] = tokens[0, a:b]
            logits, _ = TT.prefill_chunk(params, chunk, cache, a, b - a, cfg, MAX_LEN)
            err = (logits[0, 0] - full[0, b - 1]).abs().max()
            assert err <= F32_BOUND * full[0, b - 1].abs().max(), (a, b)
    for got, want in zip(TT._cache_layers(cache, cfg), TT._cache_layers(fused, cfg)):
        for name in ("c_kv", "k_rope"):
            assert rel_err(got[name].numpy(), want[name].numpy()) <= F32_BOUND, name


# ---------------------------------------------------------------------------
# the serve tree, programming, calibration
# ---------------------------------------------------------------------------


def _structure(tree, prepared_cls):
    if isinstance(tree, prepared_cls):
        return ("prepared", tree.k, tree.n, tuple(tree.splits), tuple(tree.g_pos.shape),
                tuple(tree.lora_a.shape), tuple(tree.lora_b.shape))
    if isinstance(tree, dict):
        return {k: _structure(v, prepared_cls) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v, prepared_cls) for v in tree]
    return "leaf"


@pytest.fixture(scope="module")
def served(model):
    """The merged side-cars and the prepared serve trees of both packages
    (the reference's under one jit: its operands move data only, and its
    merged magnitudes are compared within ``NORM_RTOL`` elsewhere)."""
    cfg_j, cfg_t = model["cfg"]

    def prepare(codes, adapters):
        merged = jcal.merge_adapters_for_serve(codes, adapters)
        return merged, jsub.prepare_base_for_serve(codes, merged, cfg_j)

    merged_j, prep_j = jax.jit(prepare)(
        model["codes"], jax.tree_util.tree_map(jnp.asarray, model["adapters_np"]))
    merged_t = tcal.merge_adapters_for_serve(model["codes_t"], model["adapters_t"])
    prep_t = tsub.prepare_base_for_serve(model["codes_t"], merged_t, cfg_t)
    return merged_j, prep_j, merged_t, prep_t


def test_fused_tree_matches_reference(served):
    """``prepare_base_for_serve``: the MLA pairs fuse as the reference's
    (``_q_kvd``, ``_kup_vup``; no ``_qkv``), on the prologue's 2-D leaves
    and the body's scan-stacked 3-D ones; every key, width, split and
    operand shape equal, and the fused operands bitwise."""
    _, prep_j, _, prep_t = served
    assert _structure(prep_t, tprep.PreparedCrossbar) == _structure(prep_j, jsub.PreparedCrossbar)
    for layer in (prep_t["prologue"][0], prep_t["body"][0]):
        assert set(layer["mixer"]) == {"_q_kvd", "_kup_vup", "kv_norm", "o"}
    kup = prep_t["body"][0]["mixer"]["_kup_vup"]["w"]
    assert tuple(kup.g_pos.shape) == (3, 32, 128) and kup.splits == (64, 64)
    for where in (("prologue", 0), ("body", 0)):
        for name in ("_q_kvd", "_kup_vup"):
            pj = prep_j[where[0]][where[1]]["mixer"][name]["w"]
            pt = prep_t[where[0]][where[1]]["mixer"][name]["w"]
            for field in ("g_pos", "g_neg", "scale", "lora_a", "lora_b"):
                np.testing.assert_array_equal(getattr(pt, field).numpy(),
                                              np.asarray(getattr(pj, field)))


def test_program_model_bitwise_given_draws(model):
    """Every leaf (MLA's, the dense prologue's, the (G, E, d, k) expert
    stacks, the shared experts', the router, the head) bitwise the
    reference's codes, and the dequantized tree too."""
    cfg_j, cfg_t = model["cfg"]
    noise = ref_program_draws(model["params"]["base"], jax.random.PRNGKey(1))
    got = tcal.program_model(model["base_t"], cfg_t.rram, 0, mode="codes", noise=noise)
    assert got["body"][0]["mixer"]["k_up"]["w"].g_pos.shape == (3, 32, 64)
    _codes_equal(np_tree(model["codes"]), port_np_codes(got))
    deq = tcal.program_model(model["base_t"], cfg_t.rram, 0, mode="dequant", noise=noise)
    want = jcal.program_model(model["params"]["base"], cfg_j.rram, jax.random.PRNGKey(1),
                              mode="dequant")
    _codes_equal(np_tree(want), port_np(deq))


def test_feature_loss_and_gradients_match_reference(model):
    """``feature_calibration_loss`` over the codes (read back under
    ``dequant``) and its gradients w.r.t. every side-car, MLA's and the
    shared experts' included, against ``jax.grad`` (f32)."""
    cfg_j, cfg_t = model["cfg"]
    adapters_j = jax.tree_util.tree_map(jnp.asarray, model["adapters_np"])
    batch_j = j_calibration_batch(cfg_j, 2, 12)
    with jsub.use_backend("dequant"):
        (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
            lambda ad: JT.feature_calibration_loss(model["params"]["base"], model["codes"],
                                                   ad, batch_j, cfg_j), has_aux=True))(adapters_j)
    with tsub.use_backend("dequant"):
        loss_t, grads_t = tcal.value_and_grad(
            lambda ad: TT.feature_calibration_loss(model["base_t"], model["codes_t"], ad,
                                                   to_port_batch(batch_j), cfg_t)[0],
            model["adapters_t"])
    assert float(loss_t) == pytest.approx(float(loss_j), rel=F32_RTOL)
    gj, gt = np_tree(grads_j), port_np(grads_t)
    assert gt["body"][0]["mixer"]["k_up"]["lora_b"].shape == (3, 4, 64)
    assert gt["body"][0]["ffn"]["shared"]["gate"]["lora_b"].shape == (3, 4, 32)

    def walk(w, g, path=""):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                walk(w[k], g[k], f"{path}/{k}")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(w, g)):
                walk(a, b, f"{path}/{i}")
        else:
            scale = max(np.abs(w).max(), 1e-12)
            assert np.abs(g - w).max() <= 1e-4 * scale, path

    walk(gj, gt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(model, served, dtype):
    """The teacher's forward and (f32) the codes deployment's forward
    under the dequant and codes backends (merged side-cars, the fused
    serve tree)."""
    cfg_j, cfg_t = cfg_pair(dtype)
    params = model["params"]
    if dtype == "bfloat16":  # the f32 teacher in the bf16 config's leaf dtypes
        like = jax.eval_shape(lambda k: JT.init_params(k, cfg_j), jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(lambda x, s: x.astype(s.dtype), params, like)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg_j.vocab, (2, 16)).astype(np.int32)
    forward = jax.jit(lambda p, x: JT.forward(p, {"tokens": x}, cfg_j))
    want = forward(params, jnp.asarray(tokens))
    with torch.no_grad():
        got = TT.forward({"base": from_reference(np_tree(params["base"]), "cpu"),
                          "adapters": from_reference(np_tree(params["adapters"]), "cpu")},
                         {"tokens": t(tokens).long()}, cfg_t)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        per_position = np.abs(got - want).max(-1) / np.abs(want).max()
        assert np.median(per_position) <= BF16_BOUND
        assert np.linalg.norm(got - want) <= MOE_BF16_FROB * np.linalg.norm(want)
        return
    assert rel_err(got, want) <= F32_BOUND
    merged_j, prep_j, merged_t, prep_t = served
    for backend in ("dequant", "codes"):
        pj = {"base": model["codes"], "adapters": merged_j}
        pt = {"base": model["codes_t"], "adapters": merged_t}
        if backend == "codes":
            pj["base"], pt["base"] = prep_j, prep_t
        with jsub.use_backend(backend):  # the backend is chosen at trace time
            forward = jax.jit(lambda p, x: JT.forward(p, {"tokens": x}, cfg_j))
            want = forward(pj, jnp.asarray(tokens))
        with tsub.use_backend(backend), torch.no_grad():
            got = TT.forward(pt, {"tokens": t(tokens).long()}, cfg_t)
        assert rel_err(got.numpy(), want) <= F32_BOUND, backend


# ---------------------------------------------------------------------------
# the engine and the prefix cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["codes", "codes_adc"])
def test_engine_ragged_parity_mla_matches_reference(model, served, backend):
    """The reference's ``test_engine.py::test_ragged_parity_mla`` traffic
    (max_len 32, prompts of 9 and 4 tokens from its keys, 5 tokens each,
    two slots, staggered submits), greedy, on the f32 smoke's codes and
    side-cars: the port engine on the reference deployment carried across
    gives the reference engine's tokens. Under codes the reference's
    session is bound over the ``served`` fixture's prepared tree, as its
    ``serve()`` binds it; codes_adc serves the raw codes, whose ADC couples
    each position's up-projection to the other cached rows of its tile, so
    both engines run the same traffic in the same slot order and a split
    is allowed only at a near-tie of the reference's logits
    (``assert_streams_match``; in f32 both packages' codes_adc logits agree
    to ~1e-6)."""
    cfg_j, cfg_t = model["cfg"]
    dep_j = JDeployment(cfg_j, backend, model["params"]["base"], model["codes"],
                        jax.tree_util.tree_map(jnp.asarray, model["adapters_np"]),
                        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    dep_t = Deployment.from_arrays(cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes),
                                   np_tree(dep_j.adapters), backend=backend,
                                   drift_hours=dep_j.drift_hours, device="cpu")
    if backend == "codes":
        merged_j, prep_j, _, _ = served
        s_j = jserving.ServeSession(dep_j, {"base": prep_j, "adapters": merged_j},
                                    options={"accum": "f32"})
    else:
        s_j = dep_j.serve()
    s_t = dep_t.serve()
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(50 + i), (n,), 0,
                                             cfg_j.vocab)) for i, n in enumerate((9, 4))]
    streams = []
    for engine_cls, session in ((JEngine, s_j), (ServeEngine, s_t)):
        engine = engine_cls(session, max_slots=2, max_len=32)
        reqs = []
        for p in prompts:
            reqs.append(engine.submit(p, max_new=5))
            engine.step()
            engine.step()
        engine.run()
        assert all(r.done and len(r.tokens) == 5 for r in reqs)
        streams.append([list(r.tokens) for r in reqs])
    if backend == "codes":
        assert streams[1] == streams[0]
    for p, ref, got in zip(prompts, *streams):
        assert_streams_match(s_j, p, ref, got)


def test_prefix_cache_full_hit_is_bitwise_cold_admission():
    """A prompt resubmitted whole runs no chunk and equals its cold
    admission bitwise: the staged latent cache, the admission logits, the
    slot's cache row after the run, every token (4-token chunks)."""
    cfg = t_arch(ARCH).smoke
    session = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24).serve()
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (10,))
    cold = _cold(session, prompt)
    engine = _engine(session)
    first = _serve(engine, prompt)
    chunks = engine.prefill_chunks
    full = _serve(engine, prompt)
    assert full[0].prefix_hit_tokens == len(prompt) and engine.prefill_chunks == chunks
    assert _bitwise(first, cold) and _bitwise(full, cold)
    staged = engine._staging_flat.numel() * engine._staging_flat.element_size()
    assert engine.prefix_cache_bytes() > len(engine._prefix_cache) * staged > 0
