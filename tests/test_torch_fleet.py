"""The port's fleet (``repro_torch/fleet``: ``Fleet``,
``RecalibrationScheduler``; ``faults.build_fleet_map``) at qwen3-1.7b's
smoke config on the CPU, with 2-3 chips.

* Port fleet chip ``i`` is bitwise the port's solo ``Deployment`` with chip
  ``i``'s seeds: program, heterogeneous ``advance``, ``calibrate`` (losses,
  adapters, AdamW state, step), ``chip(i)`` and ``serve(i)``'s prefill,
  faults (``inject(spec.for_chip(i))``); advancing disjoint chips commutes.
* A reference ``Fleet`` built once for the module (its codes and jitted
  steps), adopted by ``Fleet.from_arrays``: per-chip calibrate losses and
  adapters, ``logit_mse``, and ``drift_proxy`` / ``hard_fault_proxy`` on
  the same codes and baselines; ``build_fleet_map`` given the reference's
  per-chip draws bitwise the reference's map rows.
* The scheduler: it fires iff the proxy crosses the threshold, it tells
  hard faults from drift, and it raises the reference's errors.
* Snapshot and restore bitwise; one calibration step built a call,
  whatever the chip count; each chip's session captures as many steps as
  chip 0's.

Tolerances are ``test_torch_calibrate.py``'s: ``F32_RTOL`` (and
``F32_ADAPTER_ATOL`` for adapters) on the f32 config.
"""
import dataclasses
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core import rram as JR
from repro.deploy.deployment import calibration_batch as j_calibration_batch
from repro.faults import build_fleet_map as j_build_fleet_map
from repro.faults import generators as JG
from repro.fleet import Fleet as JFleet
from repro.fleet import chip_keys as j_chip_keys
from repro.models import transformer as JT
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch
from repro_torch.core import calibrate as tcal
from repro_torch.core import rram
from repro_torch.deploy import Deployment
from repro_torch.faults import generators as TG
from repro_torch.faults import iv_nonlinearity, saturated, stuck_at
from repro_torch.fleet import (
    Fleet,
    RecalibrationScheduler,
    chip_axes,
    chip_seeds,
    fleet_compile_count,
)
from repro_torch.fleet import fleet as F
from repro_torch.interop import from_reference

from test_torch_calibrate import (
    F32_ADAPTER_ATOL,
    F32_RTOL,
    assert_trees_close,
    port_np,
    to_port_batch,
)
from test_torch_faults import FIELDS
from test_torch_model import np_tree

CALIB = dict(batch_or_samples=4, steps=3, seq_len=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(dtype=None):
    cfg = get_arch("qwen3_1_7b").smoke
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _bits(t):
    t = t.detach().contiguous().reshape(-1)
    return t.view(torch.uint8) if t.dtype != torch.bool else t


def assert_bitwise(a, b):
    """Every tensor of ``a`` and ``b`` (trees, ``CrossbarWeight`` leaves and
    ``AdamState`` fields included) with the same dtype, shape and bytes."""
    ta, tb = tree_lib.tensors(list(a) if isinstance(a, tuple) else a), \
        tree_lib.tensors(list(b) if isinstance(b, tuple) else b)
    assert len(ta) == len(tb) and ta
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        assert torch.equal(_bits(x), _bits(y))


def _solo(fleet, i, backend=None):
    return Deployment.program(fleet.cfg, (fleet.teacher_seed, fleet.chip_seed(i)),
                              backend=backend or fleet.backend, device="cpu")


# ---------------------------------------------------------------------------
# chip i of the port's fleet is the port's solo deployment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dequant", "codes"])
def test_fleet_chip_bitwise_solo_deployment(backend):
    """Program, heterogeneous drift, one calibration over the fleet, and the
    served prefill: chip ``i`` is the solo deployment with its seeds, to the
    bit (codes, base, per-step losses, adapters, AdamW state, step)."""
    cfg = _cfg()
    fleet = Fleet.program(cfg, 0, n_chips=3, backend=backend, device="cpu")
    deps = [_solo(fleet, i) for i in range(3)]
    for i, dep in enumerate(deps):
        assert_bitwise(dep.codes, fleet.chip(i).codes)
        assert_bitwise(dep.base, fleet.chip(i).base)
    hours = [24.0, 168.0, 6.0]
    fleet.advance(hours)
    for dep, h in zip(deps, hours):
        dep.advance(h)
    report = fleet.calibrate(**CALIB)
    assert report.losses.shape == (3, 3) and report.losses.dtype == np.float32
    for i, dep in enumerate(deps):
        solo = dep.calibrate(**CALIB)
        np.testing.assert_array_equal(np.asarray(solo.losses, np.float32),
                                      report.losses[:, i])
        chip = fleet.chip(i)
        assert_bitwise(dep.codes, chip.codes)
        assert_bitwise(dep.adapters, chip.adapters)
        assert_bitwise(dep.opt_state, chip.opt_state)
        assert chip.step == dep.step == 3 and chip.drift_hours == dep.drift_hours
    tokens = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(2))
    for i in (0, 2):
        want, _ = deps[i].serve().prefill(tokens, 7)
        got, _ = fleet.serve(i).prefill(tokens, 7)
        assert_bitwise(want, got)


def test_fleet_shares_teacher_and_peripherals():
    fleet = Fleet.program(_cfg(), 0, n_chips=4, device="cpu")
    assert fleet.base["embed"]["embedding"] is fleet.teacher_base["embed"]["embedding"]
    w = fleet.codes["body"][0]["mixer"]["q"]["w"]
    assert isinstance(w, rram.CrossbarWeight) and w.g_pos.shape[0] == 4
    axes = chip_axes(fleet.codes)
    assert axes["body"][0]["mixer"]["q"]["w"] == 0 and axes["embed"]["embedding"] is None
    # under dequant the stacked read-back carries the chip axis too
    assert fleet.base["body"][0]["mixer"]["q"]["w"].shape[0] == 4
    chip = fleet.chip(1)
    assert chip.teacher_base is fleet.teacher_base
    assert chip.codes["embed"]["embedding"] is fleet.codes["embed"]["embedding"]
    assert chip.codes["body"][0]["mixer"]["q"]["w"].g_pos.data_ptr() != w.g_pos[1].data_ptr()


def test_chip_seeds_are_distinct_and_deterministic():
    seeds = chip_seeds(1, 6)
    assert seeds == chip_seeds(1, 6) and len(set(seeds)) == 6
    assert seeds != chip_seeds(2, 6)
    assert all(0 <= s < 2 ** 63 for s in seeds)
    fleet = Fleet.program(_cfg(), 0, n_chips=2, device="cpu")
    assert (fleet.teacher_seed, fleet.program_seed) == (0, 1)
    assert [fleet.chip_seed(i) for i in range(2)] == chip_seeds(1, 2)


def test_advance_commutes_across_chips_and_replays():
    cfg = _cfg()
    a = Fleet.program(cfg, 0, n_chips=3, backend="codes", device="cpu")
    b = Fleet.program(cfg, 0, n_chips=3, backend="codes", device="cpu")
    a.advance([24.0, 48.0, 6.0])
    a.advance(12.0, chips=[1])
    b.advance(6.0, chips=[2])
    b.advance(48.0, chips=[1])
    b.advance(12.0, chips=[1])
    b.advance(24.0, chips=[0])
    assert a.drift_hours == b.drift_hours == [[24.0], [48.0, 12.0], [6.0]]
    assert_bitwise(a.codes, b.codes)
    c = Fleet.program(cfg, 0, n_chips=3, backend="codes", device="cpu")
    c.advance([24.0, 48.0, 6.0])
    c.advance(12.0, chips=[1])
    assert_bitwise(a.codes, c.codes)


def test_dequant_advance_refreshes_the_affected_rows():
    """Under ``dequant`` a tick re-reads only the rows it drifted, and the
    result is the whole read-back's."""
    fleet = Fleet.program(_cfg(), 0, n_chips=3, backend="dequant", device="cpu")
    before = [t.clone() for t in tree_lib.tensors(F._take(fleet.base, 2))]
    fleet.advance(30.0, chips=[1])
    assert_bitwise(before, tree_lib.tensors(F._take(fleet.base, 2)))
    full = F._dequant_like(fleet.codes, fleet.teacher_base)
    assert_bitwise(full, fleet.base)


def test_advance_validation():
    fleet = Fleet.program(_cfg(), 0, n_chips=2, device="cpu")
    ref = [t.clone() for t in tree_lib.tensors(fleet.codes)]
    for hours, chips in ((-1.0, None), ([1.0], [0, 1]), (1.0, [0, 0]), (1.0, [5])):
        with pytest.raises(ValueError):
            fleet.advance(hours, chips=chips)
    fleet.advance(0.0)
    fleet.advance([0.0, 0.0])
    assert fleet.drift_hours == [[], []]
    assert_bitwise(ref, tree_lib.tensors(fleet.codes))
    with pytest.raises(ValueError, match="out of range"):
        fleet.chip(2)
    with pytest.raises(ValueError, match="n_chips"):
        Fleet(fleet.cfg, "codes", fleet.teacher_base, fleet.codes, fleet.adapters, 0, 1, 0)
    with pytest.raises(ValueError, match="unknown backend"):
        Fleet(fleet.cfg, "analog", fleet.teacher_base, fleet.codes, fleet.adapters, 0, 1, 2)


def test_fault_views_are_the_solo_injections():
    """``inject`` on chip subsets: each chip's view, and its map rows, are
    bitwise its solo deployment's ``inject(spec.for_chip(i))`` from the
    streams; the chips left out keep the healthy view; a repeated
    injection changes nothing; ``for_chip`` keeps a keyless spec."""
    cfg = _cfg()
    fleet = Fleet.program(cfg, 0, n_chips=3, backend="codes", device="cpu")
    fleet.inject([stuck_at(7, rate=0.05), iv_nonlinearity(2.0)], chips=[0, 2])
    fleet.inject(saturated(3, rate=0.1), chips=[2])
    view = [t.clone() for t in tree_lib.tensors(fleet.codes_view)]
    fleet.inject(stuck_at(7, rate=0.05), chips=[0])
    assert_bitwise(view, tree_lib.tensors(fleet.codes_view))
    assert iv_nonlinearity(2.0).for_chip(3) == iv_nonlinearity(2.0)
    assert stuck_at(7, rate=0.05).for_chip(0) != stuck_at(7, rate=0.05).for_chip(1)
    for i in range(3):
        dep = _solo(fleet, i)
        specs = [s.for_chip(i) for s, chips in fleet.fault_events if i in chips]
        if specs:
            dep.inject(specs)
        assert_bitwise(dep.codes_view, fleet.chip(i).codes_view)
        assert fleet.chip(i).fault_specs == dep.fault_specs
        assert fleet.chip_signature(i)[4] == len(specs)
    healthy = _solo(fleet, 1)
    assert_bitwise(healthy.codes, F._take(fleet.codes_view, 1))
    assert fleet.fault_map_bytes() > 0


def test_drift_proxy_zero_after_program_and_grows_with_age():
    fleet = Fleet.program(_cfg(), 0, n_chips=2, device="cpu")
    np.testing.assert_array_equal(fleet.drift_proxy(), np.zeros(2, np.float32))
    fleet.advance([100.0, 0.0])
    p = fleet.drift_proxy()
    assert p[0] > 0 and p[1] == 0
    fleet.calibrate(2, steps=1, seq_len=8, chips=[0])
    np.testing.assert_array_equal(fleet.drift_proxy(), np.zeros(2, np.float32))


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def test_scheduler_fires_iff_proxy_crosses_threshold():
    fleet = Fleet.program(_cfg(), 0, n_chips=4, device="cpu")
    sched = RecalibrationScheduler(fleet, threshold=0.01,
                                   calib_args={"batch_or_samples": 4, "steps": 2,
                                               "seq_len": 16})
    rec = sched.tick([300.0, 300.0, 0.5, 0.5])
    over = {int(c) for c in np.flatnonzero(rec.proxy > 0.01)}
    assert set(rec.recalibrated) == over == {0, 1}
    assert rec.report is not None and rec.report.chips == [0, 1]
    rec2 = sched.tick(0.25)
    assert rec2.recalibrated == [] and np.all(rec2.proxy <= 0.01) and rec2.report is None
    report = sched.report()
    assert (report.recalibrations, report.naive_recalibrations,
            report.recalibrations_avoided) == (2, 8, 6)
    assert report.per_chip_recalibrations == [1, 1, 0, 0]
    assert report.per_chip_field_hours == [300.25, 300.25, 0.75, 0.75]
    assert report.sram_lifespan_calibrations > report.rram_lifespan_calibrations
    assert "avoided" in report.summary()
    assert json.loads(report.to_json())["n_chips"] == 4


@pytest.mark.parametrize("kwargs,match", [
    ({"threshold": 0.0}, "threshold must be > 0"),
    ({"threshold": -1.0}, "threshold must be > 0"),
    ({"threshold": 0.02, "hard_threshold": 0.01}, "hard_threshold"),
    ({"threshold": 0.02, "hard_threshold": 0.02}, "hard_threshold"),
])
def test_scheduler_raises_the_reference_errors(kwargs, match):
    fleet = Fleet.program(_cfg(), 0, n_chips=1, device="cpu")
    with pytest.raises(ValueError, match=match):
        RecalibrationScheduler(fleet, **kwargs)


def test_scheduler_discriminates_hard_faults_from_drift():
    """A stuck-at chip takes the hard path (double the steps, flagged for
    life), a drifted healthy one the drift path, a fresh one neither."""
    fleet = Fleet.program(_cfg(), 0, n_chips=3, device="cpu")
    fleet.inject(stuck_at(7, rate=0.05), chips=[0])
    sched = RecalibrationScheduler(
        fleet, threshold=0.02, hard_threshold=0.3,
        calib_args={"batch_or_samples": 4, "steps": 2, "seq_len": 16})
    assert sched.hard_calib_args["steps"] == 4
    rec = sched.tick([50.0, 300.0, 0.0])
    assert rec.hard_faulted == [0] and rec.recalibrated == [1]
    assert rec.hard_proxy[0] > 0.3 > rec.hard_proxy[1] and rec.hard_proxy[2] == 0.0
    assert rec.report.chips == [1] and rec.hard_report.chips == [0]
    assert rec.hard_report.epochs_run == 2 * rec.report.epochs_run
    rec2 = sched.tick(0.25)
    assert rec2.hard_faulted == [] and rec2.recalibrated == []
    report = sched.report()
    assert (report.recalibrations, report.drift_recalibrations,
            report.hard_recalibrations) == (2, 1, 1)
    assert report.per_chip_hard_recalibrations == [1, 0, 0]
    assert report.hard_faulted_chips == [0] and report.per_chip_recalibrations == [0, 1, 0]
    assert report.calibration_chip_epochs == report.calibration_chip_epoch_budget == 2 + 4
    assert "hard-faulted" in report.summary()
    json.loads(report.to_json())


# ---------------------------------------------------------------------------
# snapshot, restore, steps built, sessions
# ---------------------------------------------------------------------------


def test_snapshot_restore_bitwise(tmp_path):
    cfg = _cfg()
    fleet = Fleet.program(cfg, 0, n_chips=3, backend="codes", device="cpu")
    fleet.advance([24.0, 168.0, 6.0])
    fleet.calibrate(4, steps=2, seq_len=16, chips=[0, 2])
    fleet.advance(12.0, chips=[1])
    fleet.inject(stuck_at(5, rate=0.02), chips=[1])
    step = fleet.snapshot(str(tmp_path))
    assert step == sum(fleet.steps) + sum(len(h) for h in fleet.drift_hours) == 8
    restored = Fleet.restore(cfg, str(tmp_path), device="cpu")
    assert (restored.backend, restored.n_chips, restored.steps) == ("codes", 3, [2, 0, 2])
    assert restored.drift_hours == fleet.drift_hours
    assert restored.fault_events == fleet.fault_events
    for name in ("codes", "codes_view", "adapters", "_proxy_ref"):
        assert_bitwise(getattr(fleet, name), getattr(restored, name))
    assert_bitwise(fleet.opt_state, restored.opt_state)
    np.testing.assert_array_equal(fleet.drift_proxy(), restored.drift_proxy())
    fleet.advance(1.0, chips=[0])
    assert fleet.snapshot(str(tmp_path)) == step + 1
    tokens = torch.randint(0, cfg.vocab, (1, 4), generator=torch.Generator().manual_seed(5))
    assert_bitwise(Fleet.restore(cfg, str(tmp_path), device="cpu").serve(1).prefill(tokens, 6)[0],
                   fleet.serve(1).prefill(tokens, 6)[0])
    assert Fleet.restore(cfg, str(tmp_path), backend="dequant", device="cpu").backend == "dequant"


def test_snapshot_refusals(tmp_path):
    cfg = _cfg()
    fleet = Fleet.program(cfg, 0, n_chips=2, backend="codes", device="cpu")
    fleet.snapshot(str(tmp_path / "ok"))
    meta_path = tmp_path / "ok" / "fleet.json"
    meta = json.loads(meta_path.read_text())
    meta["codes_digest"] = "0" + meta["codes_digest"][1:]
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="differ from the snapshot"):
        Fleet.restore(cfg, str(tmp_path / "ok"), device="cpu")
    meta["device_type"], meta["device_name"] = "cuda", "some card"
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="taken on some card"):
        Fleet.restore(cfg, str(tmp_path / "ok"), device="cpu")
    fleet.inject(stuck_at(3, rate=0.1), chips=[0], draws={0: {
        p: TG.leaf_draws(stuck_at(3, rate=0.1).for_chip(0), p, xw.g_pos.shape, "cpu")
        for p, xw in TG.rram_leaves(F._take(fleet.codes, 0))}})
    with pytest.raises(ValueError, match="draws"):
        fleet.snapshot(str(tmp_path / "draws"))
    with pytest.raises(ValueError, match="draws"):
        fleet.chip(0).snapshot(str(tmp_path / "chip"))


def test_one_calibration_step_per_call(monkeypatch):
    """A calibrate call builds one step over its chips, whatever their
    number (the reference's one compile per fleet shape), and a second
    call of the same size builds exactly one more."""
    cfg = _cfg()
    built = []

    class Recorded(tcal.CompiledCalibStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(len(self.members))

    monkeypatch.setattr(F, "CompiledCalibStep", Recorded)
    fleet = Fleet.program(cfg, 0, n_chips=3, backend="codes", device="cpu")
    fleet.advance(24.0)
    base = fleet_compile_count(cfg)
    fleet.calibrate(4, steps=3, seq_len=16, lr=2e-3)
    assert fleet_compile_count(cfg) == base + 1 and built == [3]
    fleet.calibrate(4, steps=3, seq_len=16, lr=2e-3)
    fleet.calibrate(4, steps=2, seq_len=16, lr=2e-3, chips=[0, 1])
    assert fleet_compile_count(cfg) == base + 3 and built == [3, 3, 2]


def test_each_chip_session_captures_as_many_steps_as_chip_0():
    """Sessions are per chip (a session's steps are bound to its params):
    serving chip after chip builds each session the same step set."""
    fleet = Fleet.program(_cfg(), 0, n_chips=3, backend="codes", device="cpu")
    fleet.advance([6.0, 12.0, 24.0])
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    counts = []
    for i in range(3):
        session = fleet.serve(i)
        session.generate(prompt, gen_len=3)
        counts.append(session.compile_count())
    assert counts[0] > 0 and counts == [counts[0]] * 3


# ---------------------------------------------------------------------------
# against the reference's fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_fleet():
    """A reference fleet of 3 chips at the f32 smoke config, its teacher and
    codes made once (jitted: the codes are adopted, whatever their bits),
    then aged 24, 168 and 6 h by its own ``advance``: the programmed and the
    drifted codes both packages read; its proxies, logit MSEs and
    calibration computed once."""
    cfg_j = dataclasses.replace(j_arch("qwen3_1_7b").smoke, dtype=jnp.float32)
    cfg_t = _cfg(torch.float32)
    tk, pk = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    params = jax.jit(lambda k: JT.init_params(k, cfg_j))(tk)
    from repro.fleet.fleet import fleet_program_model as j_program

    codes = jax.jit(lambda b, k: j_program(b, cfg_j.rram, k))(params["base"],
                                                             j_chip_keys(pk, 3))
    adapters = jax.tree_util.tree_map(lambda x: jnp.stack([x] * 3), params["adapters"])
    fleet_j = JFleet(cfg_j, "codes", params["base"], codes, adapters, tk, pk, 3)
    programmed = np_tree(fleet_j.codes)
    fleet_j.advance([24.0, 168.0, 6.0])
    drifted = np_tree(fleet_j.codes)
    proxy_j = (np.asarray(fleet_j.drift_proxy()), np.asarray(fleet_j.hard_fault_proxy()))
    batch_j = j_calibration_batch(cfg_j, 4, 16)
    mse_j = {use: np.asarray(fleet_j.logit_mse(batch_j, use_adapters=use))
             for use in (False, True)}
    report_j = fleet_j.calibrate(batch_j, steps=3)
    mse_j["calibrated"] = np.asarray(fleet_j.logit_mse(batch_j))
    return {"cfg_j": cfg_j, "cfg_t": cfg_t, "params": params, "programmed": programmed,
            "drifted": drifted, "adapters": np_tree(adapters), "fleet_j": fleet_j,
            "proxy_j": proxy_j, "mse_j": mse_j, "report_j": report_j, "batch_j": batch_j}


def _to_jax(t):
    """A numpy codes tree (``CrossbarWeight`` as its dict) -> the reference's."""
    if isinstance(t, dict) and set(t) == {"g_pos", "g_neg", "scale"}:
        return JR.CrossbarWeight(*(jnp.asarray(t[k]) for k in ("g_pos", "g_neg", "scale")))
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_jax(v) for v in t]
    return jnp.asarray(t)


def _adopted(ref, codes):
    return Fleet.from_arrays(ref["cfg_t"], np_tree(ref["params"]["base"]), codes,
                             ref["adapters"], backend="codes", device="cpu")


def test_proxies_match_reference_on_the_same_codes_and_baselines(ref_fleet):
    """The baselines from the programmed codes, the proxies over the
    drifted ones: ``drift_proxy`` and ``hard_fault_proxy`` within
    ``F32_RTOL`` of the reference's."""
    fleet = _adopted(ref_fleet, ref_fleet["programmed"])
    fleet.codes = from_reference(ref_fleet["drifted"], "cpu")
    fleet._refresh_base()
    for got, want in zip((fleet.drift_proxy(), fleet.hard_fault_proxy()), ref_fleet["proxy_j"]):
        assert got.shape == want.shape == (3,) and np.all(want > 0)
        np.testing.assert_allclose(got, want, rtol=F32_RTOL)


def test_calibrate_and_logit_mse_match_reference(ref_fleet):
    """From the reference's drifted codes and adapters: each chip's
    per-step losses and trained adapters, and ``logit_mse`` with and
    without the side-cars before and after, against the reference's."""
    fleet = _adopted(ref_fleet, ref_fleet["drifted"])
    batch_t = to_port_batch(ref_fleet["batch_j"])
    for use in (False, True):
        np.testing.assert_allclose(fleet.logit_mse(batch_t, use_adapters=use),
                                   ref_fleet["mse_j"][use], rtol=F32_RTOL)
    report = fleet.calibrate(batch_t, steps=3)
    want = ref_fleet["report_j"]
    assert report.chips == want.chips == [0, 1, 2] and report.epochs_run == want.epochs_run
    np.testing.assert_allclose(report.losses, np.asarray(want.losses), rtol=F32_RTOL)
    assert_trees_close(np_tree(ref_fleet["fleet_j"].adapters), port_np(fleet.adapters),
                       F32_RTOL, F32_ADAPTER_ATOL)
    for field in ("sram_bytes", "sram_bytes_per_chip", "rram_bytes", "base_params",
                  "adapter_params", "backend"):
        assert getattr(report, field) == getattr(want, field), field
    np.testing.assert_allclose(fleet.logit_mse(batch_t), ref_fleet["mse_j"]["calibrated"],
                               rtol=F32_RTOL)
    assert np.all(report.final_loss < report.initial_loss)


def _ref_fleet_draws(codes_j, spec_j, chips):
    """The reference's per-chip uniforms: ``(up, un)`` from
    ``split(fold_in(fold_in(spec key, chip), crc32(path)))``."""
    out = {}
    for c in chips:
        chip_key = jax.random.fold_in(spec_j.key(), c)
        out[c] = {}
        for path, xw in JG._rram_leaves(codes_j):
            h = jnp.uint32(zlib.crc32(path.encode()))
            kp, kn = jax.random.split(jax.random.fold_in(chip_key, h))
            shape = xw.g_pos.shape[1:]
            out[c][path] = (np.asarray(jax.random.uniform(kp, shape)),
                            np.asarray(jax.random.uniform(kn, shape)))
    return out


@pytest.mark.parametrize("kind", ["stuck_at", "saturated", "retention", "iv_nonlinearity"])
def test_build_fleet_map_given_reference_draws_is_the_reference(ref_fleet, kind):
    """Every field of every leaf of the stacked map, the identity rows of
    the chips left out included, bitwise the reference's; and the
    injected fleet's hard-fault proxy against the reference's."""
    import repro.faults as JF
    import repro_torch.faults as TF

    make = {"stuck_at": lambda G: G.stuck_at(4, rate=0.05),
            "saturated": lambda G: G.saturated(4, rate=0.1, cap_fraction=0.6),
            "retention": lambda G: G.retention(4, rate=0.1, retain=0.5),
            "iv_nonlinearity": lambda G: G.iv_nonlinearity(1.5)}[kind]
    spec_j, spec_t = make(JF), make(TF)
    assert spec_j.to_dict() == spec_t.to_dict()
    chips = [0, 2]
    fleet_j = ref_fleet["fleet_j"]
    per_chip_j = jax.tree_util.tree_map(lambda x: x[0], fleet_j.codes)
    want = j_build_fleet_map(per_chip_j, spec_j, ref_fleet["cfg_j"].rram, chips, 3)
    draws = None if spec_j.key_data is None else _ref_fleet_draws(fleet_j.codes, spec_j, chips)
    fleet = _adopted(ref_fleet, ref_fleet["programmed"])
    got = TG.build_fleet_map(F._take(fleet.codes, 0), spec_t, fleet.cfg.rram, chips, 3,
                             draws=draws)
    assert sorted(want.leaves) == sorted(got.leaves)
    for path, lf in want.leaves.items():
        for f in FIELDS:
            a, b = getattr(lf, f), getattr(got.leaves[path], f)
            assert (a is None) == (b is None), (path, f)
            if a is not None:
                a, b = np.asarray(a), b.numpy()
                assert a.dtype == b.dtype and a.shape == b.shape, (path, f)
                np.testing.assert_array_equal(a, b, err_msg=f"{path}/{f}")
    if kind == "stuck_at":
        # the same stuck cells over the same codes and baselines: the
        # hard-fault proxy flags exactly the injected chips, as the reference's
        ref = JFleet(ref_fleet["cfg_j"], "codes", ref_fleet["params"]["base"],
                     _to_jax(ref_fleet["drifted"]), fleet_j.adapters, fleet_j.teacher_key,
                     fleet_j.program_key, 3).inject(spec_j, chips=chips)
        fleet = _adopted(ref_fleet, ref_fleet["drifted"]).inject(spec_t, chips=chips,
                                                                 draws=draws)
        np.testing.assert_allclose(fleet.hard_fault_proxy(), np.asarray(ref.hard_fault_proxy()),
                                   rtol=F32_RTOL)
        assert list(np.flatnonzero(fleet.hard_fault_proxy() > 0)) == chips
