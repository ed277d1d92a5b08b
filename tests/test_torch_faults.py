"""Port parity: device faults (``repro_torch.faults``, ``Deployment.inject``,
``substrate.faulted_codes`` and ``prepare_base_for_serve(faults=)``)
against ``repro`` at the smoke config, on a reference deployment
programmed and drifted 50 h and carried across through numpy.

The reference draws each leaf's uniforms from threefry, which the port
cannot reproduce; its draws ``(up, un)`` are passed in
(``build_map(..., draws=)``, ``inject(..., draws=)``). Given them, fault
maps, faulty views and dequant bases are held bitwise, field by field,
for every kind and for the four-class composite, as is the spec JSON.

Bounds: codes vs dequant logits on the faulty view within
``CODES_DEQUANT_REL`` = 0.05 (relative Frobenius norm, the reference
test's bound: the weights are shared bitwise, only the summation order
differs); greedy f32 streams equal, or split at a reference near-tie
(``test_torch_serve.assert_streams_match``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.faults.generators as JG
import repro.faults.map as JM
from repro.configs import get_arch as j_arch
from repro.deploy import Deployment as JDeployment
from repro_torch import substrate as tsub
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import rram as tr
from repro_torch.core.calibrate import merge_adapters_for_serve
from repro_torch.deploy import Deployment, serving
from repro_torch.deploy.deployment import _device_batch, calibration_batch
from repro_torch.faults import generators as TG
from repro_torch.faults import map as TM
from repro_torch.interop import from_reference
from repro_torch.models import transformer as TT

from test_torch_model import np_tree, random_lora_b
from test_torch_serve import EMBED_SCALE, assert_streams_match

KINDS = TG.FAULT_KINDS
FIELDS = TM._FIELDS
CODES_DEQUANT_REL = 0.05
HOURS = 50.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_spec(G, kind, seed=3):
    """The reference test's severities, built by either package's ``G``."""
    return {
        "stuck_at": lambda: G.stuck_at(seed, rate=0.03),
        "saturated": lambda: G.saturated(seed, rate=0.10, cap_fraction=0.6),
        "retention": lambda: G.retention(seed, rate=0.10, retain=0.5),
        "iv_nonlinearity": lambda: G.iv_nonlinearity(1.5),
    }[kind]()


def ref_draws(codes_j, spec_j):
    """The reference's per-leaf uniforms for ``spec_j``: ``(up, un)`` from
    ``split(fold_in(spec key, crc32(path)))``, as ``_leaf_fault`` draws
    them; ``None`` for a keyless spec."""
    if spec_j.key_data is None:
        return None
    out = {}
    for path, xw in JG._rram_leaves(codes_j):
        kp, kn = jax.random.split(JG._path_key(spec_j, path))
        out[path] = (np.asarray(jax.random.uniform(kp, xw.g_pos.shape)),
                     np.asarray(jax.random.uniform(kn, xw.g_pos.shape)))
    return out


def np_t(t):
    return t.detach().cpu().numpy()


def assert_leaf_faults_equal(want, got, where=""):
    """A reference ``LeafFaults`` and a port one: the same fields set, each
    bitwise with the same dtype."""
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), (where, f)
        if a is not None:
            a = np.asarray(a)
            b = np_t(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (where, f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{where}/{f}")


def assert_maps_equal(want, got):
    assert sorted(want.leaves) == sorted(got.leaves)
    for path in want.leaves:
        assert_leaf_faults_equal(want.leaves[path], got.leaves[path], path)


def assert_codes_equal(want_np, got):
    """A numpy reference tree (``np_tree``) and a port tree, bitwise."""
    if isinstance(got, tr.CrossbarWeight):
        for k in ("g_pos", "g_neg", "scale"):
            np.testing.assert_array_equal(want_np[k], np_t(getattr(got, k)), err_msg=k)
    elif isinstance(got, dict):
        assert set(want_np) == set(got)
        for k in got:
            assert_codes_equal(want_np[k], got[k])
    elif isinstance(got, list):
        for w, g in zip(want_np, got):
            assert_codes_equal(w, g)
    else:
        np.testing.assert_array_equal(np.asarray(want_np, np.float32),
                                      got.detach().float().numpy())


def assert_port_trees_equal(a, b):
    ta, tb = tree_lib.tensors(a), tree_lib.tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def world():
    """The reference deployment (codes, 50 h), its trees in numpy, each
    kind's reference spec, draws and map, and the port's config."""
    cfg_j = j_arch("qwen3_1_7b").smoke
    cfg_t = t_arch("qwen3_1_7b").smoke
    dep_j = JDeployment.program(cfg_j, 0, backend="codes").advance(HOURS)
    specs_j = {k: make_spec(JG, k) for k in KINDS}
    return dict(
        cfg_j=cfg_j, cfg_t=cfg_t, dep_j=dep_j, specs_j=specs_j,
        teacher=np_tree(dep_j.teacher_base), codes=np_tree(dep_j.codes),
        adapters=np_tree(dep_j.adapters),
        draws={k: ref_draws(dep_j.codes, s) for k, s in specs_j.items()},
        maps_j={k: JG.build_map(dep_j.codes, s, cfg_j.rram) for k, s in specs_j.items()},
    )


def port_codes(world):
    return from_reference(world["codes"], "cpu")


def port_deployment(world, backend="codes"):
    return Deployment.from_arrays(world["cfg_t"], world["teacher"], world["codes"],
                                  world["adapters"], backend=backend,
                                  drift_hours=[HOURS], device="cpu")


def port_map(world, kind):
    return TG.build_map(port_codes(world), make_spec(TG, kind), world["cfg_t"].rram,
                        draws=world["draws"][kind])


# -- specs ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 3, 2 ** 31])
@pytest.mark.parametrize("kind", KINDS)
def test_spec_json_is_the_reference(kind, seed):
    want, got = make_spec(JG, kind, seed), make_spec(TG, kind, seed)
    assert json.dumps(got.to_dict(), sort_keys=True) == json.dumps(want.to_dict(),
                                                                   sort_keys=True)
    again = TG.FaultSpec.from_dict(json.loads(json.dumps(got.to_dict())))
    assert again == got and hash(again) == hash(got)
    from repro.faults import default_spec as j_default
    from repro_torch.faults import default_spec as t_default

    assert t_default(kind, seed).to_dict() == j_default(kind, seed).to_dict()


INVALID = {
    "stuck_rate": lambda G: G.stuck_at(0, rate=1.5),
    "stuck_lrs": lambda G: G.stuck_at(0, rate=0.1, lrs_fraction=1.2),
    "saturated_cap": lambda G: G.saturated(0, rate=0.1, cap_fraction=0.0),
    "saturated_rate": lambda G: G.saturated(0, rate=-0.5),
    "retention_rate": lambda G: G.retention(0, rate=-0.1),
    "retention_retain": lambda G: G.retention(0, rate=0.1, retain=1.5),
    "iv_strength": lambda G: G.iv_nonlinearity(-1.0),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_generator_validation(case):
    for G in (JG, TG):
        with pytest.raises(ValueError):
            INVALID[case](G)


def test_unknown_kind_and_seeds_out_of_range_raise(world):
    bad = dict(kind="nope", params=(("rate", 0.1),), key_data=(0, 1))
    with pytest.raises(ValueError):
        JG.build_map(world["dep_j"].codes, JG.FaultSpec(**bad), world["cfg_j"].rram)
    with pytest.raises(ValueError):
        TG.build_map(port_codes(world), TG.FaultSpec(**bad), world["cfg_t"].rram)
    for seed in (-1, 2 ** 32):  # the reference spells these otherwise: refused
        with pytest.raises(ValueError):
            TG.stuck_at(seed, rate=0.1)
    assert TG.stuck_at((7, 9), rate=0.1).key_data == (7, 9)


# -- maps and views --------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_build_map_is_the_reference(world, kind):
    assert_maps_equal(world["maps_j"][kind], port_map(world, kind))


@pytest.mark.parametrize("kind", KINDS + ("composite",))
def test_apply_fault_map_is_the_reference(world, kind):
    kinds = KINDS if kind == "composite" else (kind,)
    map_j = JM.compose_maps(world["maps_j"][k] for k in kinds)
    map_t = TM.compose_maps(port_map(world, k) for k in kinds)
    assert_maps_equal(map_j, map_t)
    codes_t = port_codes(world)
    view_t = TM.apply_fault_map(codes_t, map_t, world["cfg_t"].rram)
    assert_codes_equal(np_tree(JM.apply_fault_map(world["dep_j"].codes, map_j,
                                                  world["cfg_j"].rram)), view_t)
    assert_codes_equal(world["codes"], codes_t)  # the input is not written
    # the scale is the same tensor; the codes differ somewhere
    for (_, a), (_, b) in zip(TG.rram_leaves(codes_t), TG.rram_leaves(view_t)):
        assert a.scale is b.scale
    assert any(not torch.equal(a.g_pos, b.g_pos) for (_, a), (_, b) in
               zip(TG.rram_leaves(codes_t), TG.rram_leaves(view_t)))


@pytest.mark.parametrize("strength", [0.0, 0.1, 0.25, 0.5, 0.9, 1.0, 1.5, 2.0, 3.0,
                                      4.5, 6.0, 8.0])
def test_iv_bend_is_the_reference_on_every_code(strength):
    """The port's 256-entry table against the reference's ``sinh`` chain
    over every code, alone and after a retention stage."""
    codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    retain = np.where(np.arange(256).reshape(16, 16) % 3 == 0, 0.6, 1.0).astype(np.float32)
    lf_j = JM.LeafFaults(iv_strength=jnp.float32(strength))
    lf_t = TM.LeafFaults(iv_strength=torch.tensor(strength, dtype=torch.float32))
    for r in (None, retain):
        want = lf_j._apply_device(jnp.asarray(codes), None, None, None,
                                  None if r is None else jnp.asarray(r), 255)
        got = lf_t._apply_device(torch.from_numpy(codes), None, None, None,
                                 None if r is None else torch.from_numpy(r), 255)
        np.testing.assert_array_equal(np.asarray(want), np_t(got))


@pytest.mark.parametrize("pair", [("stuck_at", "saturated"), ("retention", "iv_nonlinearity"),
                                  ("stuck_at", "retention")])
def test_composition_is_a_join_and_the_reference(world, pair):
    a, b = (port_map(world, k) for k in pair)
    ab, ba = a | b, b | a
    assert_port_trees_equal([lf.fields() for lf in ab.leaves.values()],
                            [ba.leaves[p].fields() for p in ab.leaves])
    aa = a | a
    assert_port_trees_equal([lf.fields() for lf in aa.leaves.values()],
                            [a.leaves[p].fields() for p in aa.leaves])
    assert_maps_equal(world["maps_j"][pair[0]] | world["maps_j"][pair[1]], ab)
    assert TM.compose_maps([None, a, None]) is a and TM.compose_maps([]) is None


def test_incremental_inject_is_the_reference_rebuild(world):
    """``inject([s1, s2]); inject(s1)`` composes each new map into the
    current one; the reference rebuilds every recorded spec's map."""
    cfg_j, codes_j = world["cfg_j"], world["dep_j"].codes
    s1, s2 = make_spec(JG, "stuck_at"), make_spec(JG, "saturated", seed=9)
    d1, d2 = ref_draws(codes_j, s1), ref_draws(codes_j, s2)
    dep = port_deployment(world)
    dep.inject([make_spec(TG, "stuck_at"), make_spec(TG, "saturated", seed=9)],
               draws=[d1, d2])
    first = dep.codes_view
    with pytest.raises(ValueError):  # one draw for two specs
        dep.inject([make_spec(TG, "stuck_at"), make_spec(TG, "retention")], draws=[d1])
    dep.inject(make_spec(TG, "stuck_at"), draws=d1)
    rebuilt = JM.compose_maps(JG.build_map(codes_j, s, cfg_j.rram) for s in (s1, s2, s1))
    assert_maps_equal(rebuilt, dep._fault_map)
    assert_codes_equal(np_tree(JM.apply_fault_map(codes_j, rebuilt, cfg_j.rram)),
                       dep.codes_view)
    assert_port_trees_equal(first, dep.codes_view)  # re-injection changed nothing
    assert [s.to_dict() for s in dep.fault_specs] == [s.to_dict() for s in (s1, s2, s1)]
    assert_codes_equal(world["codes"], dep.codes)  # pristine


@pytest.mark.parametrize("kind", KINDS)
def test_views_bitwise_across_backends(world, kind):
    """All three backends read one faulty view; the dequant base is its
    float read-back, bitwise the reference's."""
    deps = {b: port_deployment(world, b).inject(make_spec(TG, kind),
                                                draws=world["draws"][kind])
            for b in ("codes", "dequant", "codes_adc")}
    for b in ("dequant", "codes_adc"):
        assert_port_trees_equal(deps["codes"].codes_view, deps[b].codes_view)
    map_j = world["maps_j"][kind]
    view_j = JM.apply_fault_map(world["dep_j"].codes, map_j, world["cfg_j"].rram)
    assert_codes_equal(np_tree(view_j), deps["codes"].codes_view)
    assert deps["codes_adc"].base is deps["codes_adc"].codes_view
    w_view = deps["codes"].codes_view["body"][0]["mixer"]["q"]["w"]
    w_deq = deps["dequant"].base["body"][0]["mixer"]["q"]["w"]
    assert torch.equal(tr.dequantize(w_view, dtype=w_deq.dtype), w_deq)
    from repro.core import rram as jr

    want = jr.dequantize(view_j["body"][0]["mixer"]["q"]["w"], dtype=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(want, np.float32), w_deq.float().numpy())
    assert_codes_equal(world["codes"], deps["dequant"].codes)


@pytest.mark.parametrize("kind", KINDS)
def test_codes_vs_dequant_logits_under_faults(world, kind):
    cfg = world["cfg_t"]
    batch = _device_batch(calibration_batch(cfg, 2, 8), "cpu")
    outs = {}
    for backend in ("codes", "dequant", "codes_adc"):
        dep = port_deployment(world, backend).inject(make_spec(TG, kind),
                                                     draws=world["draws"][kind])
        with serving.backend_scope(backend, cfg), torch.no_grad():
            outs[backend] = TT.forward({"base": dep.base, "adapters": dep.adapters},
                                       batch, cfg).float()
    rel = torch.linalg.norm(outs["codes"] - outs["dequant"]) / torch.linalg.norm(
        outs["dequant"])
    assert rel < CODES_DEQUANT_REL, rel
    assert torch.isfinite(outs["codes_adc"]).all()


def test_greedy_f32_stream_under_stuck_at(world):
    cfg_j = dataclasses.replace(world["cfg_j"], dtype=jnp.float32)
    cfg_t = dataclasses.replace(world["cfg_t"], dtype=torch.float32)
    dep_j = JDeployment.program(cfg_j, 0, backend="codes").advance(24)
    emb = dep_j.teacher_base["embed"]["embedding"] * EMBED_SCALE
    dep_j.teacher_base["embed"]["embedding"] = emb
    dep_j.codes["embed"]["embedding"] = emb
    adapters_np = random_lora_b(np_tree(dep_j.adapters), seed=5)
    dep_j.adapters = jax.tree_util.tree_map(jnp.asarray, adapters_np)
    spec_j = make_spec(JG, "stuck_at")
    draws = ref_draws(dep_j.codes, spec_j)
    dep_j.inject(spec_j)
    dep_t = Deployment.from_arrays(
        cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes), adapters_np,
        backend="codes", drift_hours=dep_j.drift_hours, device="cpu",
    ).inject(make_spec(TG, "stuck_at"), draws=draws)
    assert_codes_equal(np_tree(dep_j.codes_view), dep_t.codes_view)
    s_j, s_t = dep_j.serve(), dep_t.serve()
    prompt = np.random.default_rng(4).integers(0, cfg_j.vocab, (2, 6)).astype(np.int32)
    ref, _ = s_j.generate(jnp.asarray(prompt), gen_len=6)
    got, _ = s_t.generate(torch.as_tensor(prompt), gen_len=6)
    for i in range(2):
        assert_streams_match(s_j, prompt[i], np.asarray(ref)[i], got[i])


@pytest.mark.parametrize("kind", ["stuck_at", "iv_nonlinearity"])
def test_prepared_serve_tree_under_faults(world, kind):
    """The tree ``serve`` prepares from the faulty base is bitwise the one
    prepared from pristine codes through ``faults=``; the session serves."""
    cfg = world["cfg_t"]
    dep = port_deployment(world).inject(make_spec(TG, kind), draws=world["draws"][kind])
    merged = merge_adapters_for_serve(dep.base, dep.adapters)
    applied = tsub.prepare_base_for_serve(dep.base, merged, cfg)
    routed = tsub.prepare_base_for_serve(dep.codes, merged, cfg, faults=dep._fault_map)
    assert_port_trees_equal(applied, routed)
    session = dep.serve()
    assert_port_trees_equal(session.params["base"], applied)
    logits, _ = session.prefill(torch.randint(0, cfg.vocab, (1, 4)), 6)
    assert torch.isfinite(logits.float()).all()


# -- lifecycle on the port's own streams ------------------------------------------


def test_stuck_cells_stay_pinned_through_drift():
    cfg = t_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device="cpu")
    dep.inject(TG.stuck_at(5, rate=0.05, lrs_fraction=1.0))  # all stuck at LRS
    path, lf = sorted(dep._fault_map.leaves.items())[0]
    mask = lf.stuck_mask_pos
    assert mask.any()

    def pinned(tree):
        return dict(TG.rram_leaves(tree))[path].g_pos[mask]

    cm = cfg.rram.code_max
    assert (pinned(dep.codes_view) == cm).all()
    before = pinned(dep.codes).clone()
    dep.advance(200.0)
    assert (pinned(dep.codes_view) == cm).all()
    assert not torch.equal(pinned(dep.codes), before)  # the pristine codes drifted
    assert not (pinned(dep.codes) == cm).all()


def test_draws_replay_from_the_spec_in_any_order():
    """Without draws each leaf draws from its spec's stream: the same map
    every time, whatever else was injected first."""
    cfg = t_arch("qwen3_1_7b").smoke
    s1, s2 = TG.stuck_at(3, rate=0.03), TG.retention(9, rate=0.1, retain=0.5)
    a = Deployment.program(cfg, 0, backend="codes", device="cpu").inject([s1, s2])
    b = Deployment.program(cfg, 0, backend="codes", device="cpu").inject(s2).inject(s1)
    assert_port_trees_equal(a.codes_view, b.codes_view)
    path, xw = TG.rram_leaves(a.codes)[2]
    up, un = TG.leaf_draws(s1, path, xw.g_pos.shape, "cpu")
    rate = torch.tensor(0.03, dtype=torch.float32)
    lf = a._fault_map.leaves[path]
    assert torch.equal(lf.stuck_mask_pos, up < rate)
    assert torch.equal(lf.stuck_mask_neg, un < rate)
    assert not torch.equal(up, un)


def test_session_made_before_inject_keeps_its_params():
    cfg = t_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device="cpu")
    session = dep.serve()
    before = [t.clone() for t in tree_lib.tensors(session.params)]
    dep.inject(TG.stuck_at(3, rate=0.2))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_lib.tensors(session.params)))
    after = tree_lib.tensors(dep.serve().params["base"])
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_lib.tensors(session.params["base"]), after))


def test_fault_recovery_study_at_smoke():
    from repro_torch.faults import fault_recovery_study

    res = fault_recovery_study(smoke=True, samples=2, steps=8, seq_len=8, hours=300.0,
                               classes=["stuck_at"], device="cpu")["stuck_at"]
    assert res["faulted_mse"] > res["clean_mse"]
    assert res["calibrated_mse"] < res["faulted_mse"]
    assert res["recovered_fraction"] > 0


# -- a saturation cap against drift ---------------------------------------------


@pytest.mark.parametrize("rows,hours", [(64, 24.0), (64, 300.0), (2048, 24.0), (2048, 300.0)])
def test_saturation_cap_against_drift_is_the_reference(rows, hours):
    """The study's saturation fault on a drifted Gaussian matrix, the port
    given the reference's normals and uniforms: the faulty view bitwise
    the reference's. Drift is multiplicative, so the cap at 153 also clips
    the drift of codes programmed near it; in both packages the weights'
    squared error rises with the cap except at full column height (2048
    rows, the full model's) after 300 h, where it falls."""
    import repro.core.rram as jr

    w = np.random.default_rng(rows).standard_normal((rows, 256)).astype(np.float32)
    cj, ct = jr.RramConfig(relative_drift=0.10), tr.RramConfig(relative_drift=0.10)
    spec_j = JG.saturated(2, rate=0.10, cap_fraction=0.6)
    key_d, key_f = jax.random.PRNGKey(11), jax.random.PRNGKey(7)
    dj = jr.apply_drift(jr.program(jnp.asarray(w), cj), cj, key_d, hours=hours)
    fj = JG._leaf_fault(spec_j, key_f, w.shape, cj).apply(dj, cj)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, w.shape)))
                  for k in jax.random.split(key_d))
    draws = tuple(np.asarray(jax.random.uniform(k, w.shape)) for k in jax.random.split(key_f))
    dt = tr.apply_drift(tr.program(torch.from_numpy(w), ct), ct, hours=hours, noise=noise)
    ft = TG.leaf_fault(make_spec(TG, "saturated", 2), draws, w.shape, ct, "cpu").apply(dt, ct)
    for a, b in ((dj, dt), (fj, ft)):
        np.testing.assert_array_equal(np.asarray(a.g_pos), np_t(b.g_pos))
        np.testing.assert_array_equal(np.asarray(a.g_neg), np_t(b.g_neg))
    assert int((ft.g_pos != dt.g_pos).sum() + (ft.g_neg != dt.g_neg).sum()) > 0

    def sq_err(read_back):
        return float(np.sum((np.asarray(read_back, np.float64) - w) ** 2))

    clean_j, faulted_j = sq_err(jr.dequantize(dj)), sq_err(jr.dequantize(fj))
    clean_t, faulted_t = sq_err(np_t(tr.dequantize(dt))), sq_err(np_t(tr.dequantize(ft)))
    worse = not (rows == 2048 and hours == 300.0)
    assert (faulted_j > clean_j) == (faulted_t > clean_t) == worse, (
        clean_j, faulted_j, clean_t, faulted_t)


@pytest.mark.parametrize("kind", KINDS + ("healthy",))
def test_faulted_view_is_the_reference(world, kind):
    import repro.substrate as JS

    path, xj = JG._rram_leaves(world["dep_j"].codes)[0]
    xt = dict(TG.rram_leaves(port_codes(world)))[path]
    lj = None if kind == "healthy" else world["maps_j"][kind].leaves[path]
    lt = None if kind == "healthy" else port_map(world, kind).leaves[path]
    want = JS.faulted_view(xj, lj, world["cfg_j"].rram)
    got = tsub.faulted_view(xt, lt, world["cfg_t"].rram)
    for k in ("g_pos", "g_neg", "scale"):
        np.testing.assert_array_equal(np.asarray(getattr(want, k)), np_t(getattr(got, k)))
    assert (got is xt) == (kind == "healthy")
