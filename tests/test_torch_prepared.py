"""Port parity: the serve-time prepared tree (``repro_torch.substrate.
prepared``) and the DoRA merge (``core.calibrate.merge_adapters_for_
serve``) against the reference on carried-across smoke codes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.configs import get_arch as j_arch
from repro.core import calibrate as jcal
from repro.models import transformer as JT
from repro_torch import substrate as tsub
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.core import dora as tdora
from repro_torch.core.rram import program
from repro_torch.interop import from_reference
from repro_torch.substrate import prepared as tprep

from test_torch_model import np_tree, random_lora_b


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trees():
    cfg_j = j_arch("qwen3_1_7b").smoke
    cfg_t = t_arch("qwen3_1_7b").smoke
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jcal.program_model(params["base"], cfg_j.rram, jax.random.PRNGKey(1),
                               mode="codes")
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=1)
    merged_j = jcal.merge_adapters_for_serve(
        codes, jax.tree_util.tree_map(jnp.asarray, adapters_np))
    prep_j = jsub.prepare_base_for_serve(codes, merged_j, cfg_j)
    codes_t = from_reference(np_tree(codes), "cpu")
    merged_t = tcal.merge_adapters_for_serve(codes_t, from_reference(adapters_np, "cpu"))
    prep_t = tsub.prepare_base_for_serve(codes_t, merged_t, cfg_t)
    return merged_j, prep_j, merged_t, prep_t


def _structure(tree, prepared_cls):
    if isinstance(tree, prepared_cls):
        return ("prepared", tree.k, tree.n, tuple(tree.splits))
    if isinstance(tree, dict):
        return {k: _structure(v, prepared_cls) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v, prepared_cls) for v in tree]
    return "leaf"


def test_prepared_tree_has_reference_keys(trees):
    _, prep_j, _, prep_t = trees
    want = _structure(prep_j, jsub.PreparedCrossbar)
    assert _structure(prep_t, tprep.PreparedCrossbar) == want
    layer = prep_t["body"][0]
    assert set(layer["mixer"]) == {"_qkv", "o", "q_norm", "k_norm"}
    assert set(layer["ffn"]) == {"_gate_up", "down"}
    assert tprep.serve_alignment() == (1, 1)


def test_prepared_operands_match_reference(trees):
    _, prep_j, _, prep_t = trees
    for key, sub in (("mixer", "_qkv"), ("mixer", "o"), ("ffn", "_gate_up"),
                     ("ffn", "down")):
        pj = prep_j["body"][0][key][sub]["w"]
        pt = prep_t["body"][0][key][sub]["w"]
        for field in ("g_pos", "g_neg", "scale", "lora_a", "lora_b"):
            np.testing.assert_array_equal(getattr(pt, field).numpy(),
                                          np.asarray(getattr(pj, field)))
        np.testing.assert_allclose(pt.gamma.numpy(), np.asarray(pj.gamma),
                                   rtol=1e-5, atol=0)


def test_merged_gamma_matches_reference_stacked(trees):
    """Scan-stacked leaves (4 smoke layers on axis 0) take the stacked
    column norm; every merged magnitude matches the reference."""
    merged_j, _, merged_t, _ = trees
    j = np_tree(merged_j)
    for key, names in (("mixer", "qkvo"), ("ffn", ("gate", "up", "down"))):
        for name in names:
            mj = j["body"][0][key][name]["dora_m_merged"]
            mt = merged_t["body"][0][key][name]["dora_m_merged"].numpy()
            assert mt.shape == mj.shape and mj.ndim == 2
            assert "dora_m" not in merged_t["body"][0][key][name]
            np.testing.assert_allclose(mt, mj, rtol=1e-5, atol=0)


def test_merge_plain_leaf_matches_column_norm():
    """A 2-D (unstacked) leaf takes ``column_norm``."""
    g = torch.Generator().manual_seed(0)
    xw = program(torch.randn((24, 16), generator=g))
    ad = tdora.init_adapter(g, 24, 16, tdora.AdapterConfig(rank=3))
    ad["lora_b"] = torch.randn((3, 16), generator=g)
    merged = tcal.merge_adapters_for_serve({"q": {"w": xw}}, {"q": ad})["q"]
    want = ad["dora_m"] / tdora.column_norm(tsub.exec.dequantize(xw),
                                            ad["lora_a"], ad["lora_b"])
    torch.testing.assert_close(merged["dora_m_merged"], want, rtol=0, atol=0)


@pytest.mark.parametrize("lead", [(5,), (2, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_equals_unfused_exactly(lead, dtype):
    acfg = t_arch("qwen3_1_7b").smoke.adapter
    g = torch.Generator().manual_seed(3)
    leaves = []
    for n in (64, 32, 32):
        xw = program(torch.randn((64, n), generator=g))
        ad = {"lora_a": torch.randn((64, 4), generator=g),
              "lora_b": torch.randn((4, n), generator=g),
              "dora_m_merged": torch.rand((n,), generator=g)}
        leaves.append((xw, ad))
    x = torch.randn(lead + (64,), generator=g).to(dtype)
    fused = tprep.fuse_crossbars(leaves, acfg)
    assert fused.splits == (64, 32, 32) and fused.lora_b.shape == (12, 128)
    y = tprep.rimc_linear_prepared(x, fused)
    parts = torch.cat([tprep.rimc_linear_prepared(x, tprep.prepare_crossbar(xw, ad, acfg))
                       for xw, ad in leaves], dim=-1)
    assert torch.equal(y, parts)
    # the dequant backend's view of the same prepared leaf
    torch.testing.assert_close(tprep.prepared_ref_forward(x, fused), y)


def test_prepare_rejects_unmerged_adapters():
    g = torch.Generator().manual_seed(0)
    xw = program(torch.randn((8, 4), generator=g))
    ad = tdora.init_adapter(g, 8, 4, tdora.AdapterConfig(rank=2))
    with pytest.raises(ValueError, match="merged"):
        tprep.prepare_crossbar(xw, ad, tdora.AdapterConfig(rank=2))


def test_cross_attention_subtree_never_fuses():
    cfg = t_arch("qwen3_1_7b").smoke

    def leaf():
        return {"w": program(torch.ones((8, 8)))}

    base = {"xattn": {"q": leaf(), "k": leaf(), "v": leaf(), "o": leaf()},
            "mixer": {"q": leaf(), "k": leaf(), "v": leaf(), "o": leaf()}}
    out = tprep.prepare_base_for_serve(base, {}, cfg)
    assert set(out["xattn"]) == {"q", "k", "v", "o"}
    assert set(out["mixer"]) == {"_qkv", "o"}


def _leaf_pair(k=40, n=24, r=3, seed=0):
    """One reference leaf with an unmerged DoRA adapter (random non-zero
    B) and its port twin."""
    from repro.core import dora as jdora
    from repro.core import rram as jr

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    cfg = jr.RramConfig(relative_drift=0.1)
    xw = jr.apply_drift(jr.program(jnp.asarray(w), cfg), cfg, jax.random.PRNGKey(seed))
    ad = jdora.init_adapter(jax.random.PRNGKey(seed + 1), k, n,
                            jdora.AdapterConfig(rank=r), w_base=jr.dequantize(xw))
    ad["lora_b"] = jnp.asarray(rng.standard_normal((r, n)).astype(np.float32) * 0.1)
    return xw, ad, from_reference(np_tree(xw), "cpu"), from_reference(np_tree(ad), "cpu")


@pytest.mark.parametrize("backend", ["codes", "dequant"])
def test_raw_leaf_backends_match_reference(backend):
    """An unprepared CrossbarWeight with an unmerged adapter: the codes
    backend derives gamma (``dora_gamma``) and runs ``rimc_linear``."""
    from repro.core.dora import AdapterConfig as JCfg

    xw_j, ad_j, xw_t, ad_t = _leaf_pair()
    x = np.random.default_rng(2).standard_normal((5, 40)).astype(np.float32)
    want = jsub.crossbar_linear(jnp.asarray(x), xw_j, ad_j, JCfg(rank=3), backend=backend)
    got = tsub.crossbar_linear(torch.from_numpy(x), xw_t, ad_t, tdora.AdapterConfig(rank=3),
                               backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_codes_backend_without_adapter_is_plain_crossbar():
    xw_j, _, xw_t, _ = _leaf_pair(seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 40)).astype(np.float32))
    got = tsub.crossbar_linear(x, xw_t, {}, tdora.AdapterConfig(rank=3), backend="codes")
    torch.testing.assert_close(got, x @ tsub.exec.dequantize(xw_t), rtol=1e-5, atol=1e-5)


def test_code_column_norms_and_gamma_match_reference():
    from repro.substrate import exec as jexec

    xw_j, ad_j, xw_t, ad_t = _leaf_pair(seed=5)
    np.testing.assert_allclose(tsub.code_column_norms(xw_t).numpy(),
                               np.asarray(jexec.code_column_norms(xw_j)), rtol=1e-6)
    np.testing.assert_allclose(tsub.dora_gamma(xw_t, ad_t).numpy(),
                               np.asarray(jexec.dora_gamma(xw_j, ad_j)), rtol=1e-5)


def test_byte_accounting_matches_reference():
    cfg_j = j_arch("qwen3_1_7b").smoke
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jcal.program_model(params["base"], cfg_j.rram, jax.random.PRNGKey(1), mode="codes")
    codes_t = from_reference(np_tree(codes), "cpu")
    base_t = from_reference(np_tree(params["base"]), "cpu")
    adapters_t = from_reference(np_tree(params["adapters"]), "cpu")
    assert tcal.rram_bytes(codes_t) == jcal.rram_bytes(codes)
    assert tcal.rram_bytes(base_t) == jcal.rram_bytes(params["base"])
    assert tcal.sram_bytes(adapters_t) == jcal.sram_bytes(params["adapters"])
    assert tcal.calibrated_fraction(codes_t, adapters_t) == pytest.approx(
        jcal.calibrated_fraction(codes, params["adapters"]), rel=1e-12)


def test_backend_registry_and_scope():
    assert tsub.available_backends() == ("codes", "codes_adc", "dequant")
    assert tsub.active_backend_name() == tsub.DEFAULT_BACKEND == "codes"
    assert tsub.active_options() == {}
    with tsub.use_backend("dequant"):
        assert tsub.active_backend_name() == "dequant"
        assert tsub.active_options() == {}
        with tsub.use_backend("codes", accum="int8"):
            assert tsub.active_backend_name() == "codes"
            assert tsub.active_options() == {"accum": "int8"}
            with tsub.use_backend("codes_adc", code_max=255, adc_bits=6):
                assert tsub.active_backend_name() == "codes_adc"
                assert tsub.active_options() == {"code_max": 255, "adc_bits": 6}
            assert tsub.active_options() == {"accum": "int8"}
        assert tsub.active_backend_name() == "dequant"
        assert tsub.active_options() == {}
    assert tsub.active_backend_name() == "codes"
    assert tsub.active_options() == {}
    with pytest.raises(KeyError, match="unknown substrate backend"):
        with tsub.use_backend("codes_int4"):
            pass
