"""The port's calibration registry (``repro_torch/registry``) and the
deployment's ``registry=`` / ``warm_start=`` / ``record=`` at qwen3-1.7b's
smoke config on the CPU.

* Against the reference on the same numpy inputs: ``stability_metrics``,
  ``jensen_shannon``, ``adapter_samples`` (bitwise, the reference's leaf
  order), the promotion decisions and their metrics over a sequence of
  adapters recorded into both registries, and components 1-4 of the drift
  signature (sigma, log-time, events, faults) to the last bit. The device
  feature hashes the port's integer seed, and ``cfg_fingerprint`` the
  port's config ``repr``: the port's keys are its own.
* The reference's registry behaviours on the port: the artifact round
  trip bitwise, versions monotone, the sidecar, the first run promotes,
  promotion only on instability, the nearest reference deterministic
  (own history first) and empty (cold), key quantization, a deployment's
  warm start below its cold start, fleet warm-start parity, a virgin chip
  seeded from a sibling, ``loss_threshold`` stopping a fleet early, the
  scheduler's epoch savings, and ``CalibrationReport``'s JSON round trip.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.models import transformer as JT
from repro.registry import CalibrationRegistry as JRegistry
from repro.registry import metrics as JM
from repro.registry import store as JS
from repro.registry import warmstart as JW
from repro_torch.configs import get_arch
from repro_torch.deploy import CalibrationReport, Deployment
from repro_torch.fleet import Fleet, RecalibrationScheduler
from repro_torch.interop import from_reference
from repro_torch.optim.adam import adamw_init
from repro_torch.registry import (
    DEFAULT_THRESHOLDS,
    CalibrationRegistry,
    PromotionPolicy,
    StabilityThresholds,
    adapter_samples,
    cfg_fingerprint,
    drift_signature,
    jensen_shannon,
    nearest_reference,
    signature_key,
    stability_metrics,
)
from repro_torch.registry import warmstart as TW

from test_torch_fleet import assert_bitwise
from test_torch_model import np_tree

CALIB = dict(steps=4, seq_len=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg():
    return get_arch("qwen3_1_7b").smoke


def _sample_pairs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    return {
        "self": (x, x),
        "shifted": (x + 0.3, x),
        "scaled": (1.5 * x, x),
        "small_noise": (x + 1e-3 * rng.standard_normal(4096).astype(np.float32), x),
        "heavy_tail": (rng.standard_t(2, 3000).astype(np.float32), x[:2000]),
        "degenerate": (np.zeros(64, np.float32), np.zeros(64, np.float32)),
    }


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(_sample_pairs()))
def test_stability_metrics_match_reference(name):
    cur, ref = _sample_pairs()[name]
    for thr in (DEFAULT_THRESHOLDS, StabilityThresholds(1e9, 1e9, 1e9, 1e9, 1e9)):
        got = stability_metrics(cur, ref, thresholds=thr)
        want = JM.stability_metrics(cur, ref, thresholds=JM.StabilityThresholds(**thr.to_dict()))
        assert got.to_dict() == want.to_dict()
    if name == "self":
        assert all(v == 0.0 for v in got.drifts().values())


@pytest.mark.parametrize("bins", [8, 64, 257])
def test_jensen_shannon_matches_reference(bins):
    for cur, ref in _sample_pairs().values():
        got = jensen_shannon(cur, ref, bins=bins)
        assert got == JM.jensen_shannon(cur, ref, bins=bins)
        assert 0.0 <= got <= 1.0


@functools.lru_cache(maxsize=None)
def _ref_adapters():
    """The reference's smoke adapters (bf16 and f32 leaves), moved off the
    init by seeded noise, as a numpy tree."""
    params = jax.jit(lambda k: JT.init_params(k, j_arch("qwen3_1_7b").smoke))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.01).astype(a.dtype),
        np_tree(params["adapters"]))


@pytest.mark.parametrize("cap", [65536, 1000, 7])
def test_adapter_samples_match_reference(cap):
    """The port's tree (dict insertion order) sampled in the reference's
    leaf order (keys sorted): bitwise the reference's vector, bf16 leaves
    included, stride-subsampled alike."""
    adapters_np = _ref_adapters()
    want = JM.adapter_samples(adapters_np, cap=cap)
    got = adapter_samples(from_reference(adapters_np, "cpu"), cap=cap)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert adapter_samples({}).tolist() == [0.0]


def test_promotion_decisions_match_reference_over_a_sequence(tmp_path):
    """Six runs recorded under one signature into both registries, each a
    drift further from the first: the same versions, references, decisions,
    reasons and metrics."""
    rng = np.random.default_rng(2)
    base = {"blk": {"lora_a": rng.standard_normal((32, 8)).astype(np.float32),
                    "lora_b": rng.standard_normal((8, 16)).astype(np.float32),
                    "dora_m": rng.random(16).astype(np.float32)}}
    sig = np.asarray([0.1, 0.02, 0.2, 0.03, 0.0])
    reg_t = CalibrationRegistry(str(tmp_path / "port"))
    reg_j = JRegistry(str(tmp_path / "ref"))
    cfg_t, cfg_j = _cfg(), j_arch("qwen3_1_7b").smoke
    for i, scale in enumerate((0.0, 1e-4, 1e-3, 0.05, 0.06, 0.3)):
        ad = jax.tree_util.tree_map(
            lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32), base)
        opt_j = {"step": np.asarray(i, np.int32)}
        rec_j = reg_j.record(cfg_j, "codes", sig, adapters=ad, opt_state=opt_j)
        ad_t = from_reference(ad, "cpu")
        rec_t = reg_t.record(cfg_t, "codes", sig, adapters=ad_t, opt_state=adamw_init(ad_t))
        assert rec_t.version == rec_j.version == i + 1
        for field in ("promotion", "metrics", "reference_version", "signature", "thresholds"):
            assert rec_t.meta[field] == rec_j.meta[field], (i, field)
        assert rec_t.promoted == rec_j.promoted
    key_t = reg_t.key_for(cfg_t, "codes", sig)
    key_j = reg_j.key_for(cfg_j, "codes", sig)
    assert reg_t.reference(key_t).version == reg_j.reference(key_j).version
    assert key_t.sig_key == key_j.sig_key and key_t.cfg_fp != key_j.cfg_fp


@pytest.mark.parametrize("hours,events,faults", [
    (0.0, 0, 0), (24.0, 1, 0), (192.0, 2, 1), (3.5, 4, 2), (1e4, 30, 0)])
def test_signature_components_match_reference(hours, events, faults):
    cfg_t, cfg_j = _cfg(), j_arch("qwen3_1_7b").smoke
    got = drift_signature(cfg_t.rram, 12345, field_hours=hours, drift_events=events,
                          fault_events=faults)
    want = JW.drift_signature(cfg_j.rram, jax.random.PRNGKey(1), field_hours=hours,
                              drift_events=events, fault_events=faults)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (5,)
    assert got[1:].tobytes() == want[1:].tobytes()
    assert 0.0 <= got[0] < TW.DEVICE_WEIGHT
    assert TW.device_feature(12345) != TW.device_feature(12346)
    assert TW.DEVICE_WEIGHT == JW.DEVICE_WEIGHT


def test_keys_quantize_as_the_reference():
    a = np.array([0.1, 0.2, 0.3])
    assert signature_key(a) == signature_key(a + 1e-9) == JS.signature_key(a)
    assert signature_key(a) != signature_key(a + 1e-3)
    assert cfg_fingerprint(_cfg()) == cfg_fingerprint(get_arch("qwen3_1_7b").smoke)
    assert cfg_fingerprint(_cfg()) != JS.cfg_fingerprint(j_arch("qwen3_1_7b").smoke)


def test_promotion_policy_reasons():
    policy = PromotionPolicy()
    assert policy.decide(has_reference=False, metrics=None).reason == "first run for key"
    assert policy.decide(has_reference=True, metrics=None).promote
    x = np.linspace(-1.0, 1.0, 512)
    stable = stability_metrics(x, x)
    assert stable.is_stable and not policy.decide(has_reference=True, metrics=stable).promote
    shifted = stability_metrics(x + 0.5, x)
    decision = policy.decide(has_reference=True, metrics=shifted)
    assert not shifted.is_stable and decision.promote
    assert decision.reason.startswith("reference unstable (apd_p5=")


# ---------------------------------------------------------------------------
# the registry's behaviours on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    """One deployment calibrated twice through a registry (24 h, then 48 h
    of drift)."""
    reg = CalibrationRegistry(str(tmp_path_factory.mktemp("registry")))
    dep = Deployment.program(_cfg(), 0, device="cpu")
    dep.advance(24.0)
    r1 = dep.calibrate(4, registry=reg, **CALIB)
    dep.advance(24.0)
    r2 = dep.calibrate(4, registry=reg, **CALIB)
    return reg, dep, r1, r2


def test_artifact_round_trip_bitwise(calibrated):
    reg, dep, _, _ = calibrated
    key = reg.key_for(dep.cfg, dep.backend, dep.drift_signature())
    rec = reg.artifact(key, reg.versions(key)[-1])
    trees = reg.load(rec, {"adapters": dep.adapters, "opt": dep.opt_state})
    assert_bitwise(trees["adapters"], dep.adapters)
    assert_bitwise(trees["opt"], dep.opt_state)


def test_versions_monotone_per_key(calibrated):
    reg, dep, _, _ = calibrated
    key = reg.key_for(dep.cfg, dep.backend, dep.drift_signature())
    twin = Deployment.program(_cfg(), 0, device="cpu")
    twin.advance(24.0)
    twin.advance(24.0)
    report = twin.calibrate(4, registry=reg, steps=2, seq_len=16)
    assert reg.versions(key) == [1, 2] and report.losses
    assert reg.key_for(dep.cfg, dep.backend, dep.drift_signature()).name == key.name


def test_sidecar_metadata(calibrated):
    reg, dep, _, r2 = calibrated
    key = reg.key_for(dep.cfg, dep.backend, dep.drift_signature())
    rec = reg.artifact(key, 1)
    assert rec.meta["backend"] == dep.backend and rec.meta["format"] == 1
    assert rec.meta["report"] == r2.to_dict()
    assert rec.meta["metrics"] is None and rec.meta["promotion"]["promote"]
    assert reg.samples(rec) is not None and rec.name == f"{key.name}@v1"
    assert rec.signature.tolist() == list(key.signature)


def test_first_run_always_promotes(calibrated):
    reg, dep, _, _ = calibrated
    sig1 = drift_signature(dep.cfg.rram, dep.program_seed, field_hours=24.0, drift_events=1)
    ref = reg.reference(reg.key_for(dep.cfg, dep.backend, sig1))
    assert ref is not None and ref.version == 1 and ref.promoted
    assert ref.meta["promotion"]["reason"] == "first run for key"


@pytest.mark.parametrize("name,thr,want_ref", [
    ("lenient", StabilityThresholds(1e9, 1e9, 1e9, 1e9, 1e9), 1),
    ("strict", StabilityThresholds(0.0, 0.0, 0.0, 0.0, 0.0), 2)])
def test_promotes_only_when_unstable(tmp_path, name, thr, want_ref):
    reg = CalibrationRegistry(str(tmp_path / name), thresholds=thr)
    dep = Deployment.program(_cfg(), 0, device="cpu")
    dep.advance(24.0)
    dep.calibrate(4, registry=reg, steps=2, seq_len=16)
    dep.calibrate(4, registry=reg, steps=2, seq_len=16)
    key = reg.key_for(dep.cfg, dep.backend, dep.drift_signature())
    assert reg.versions(key) == [1, 2] and reg.reference(key).version == want_ref


def test_nearest_reference_deterministic(calibrated):
    reg, dep, _, _ = calibrated
    sig = dep.drift_signature()
    recs = [nearest_reference(reg, dep.cfg, dep.backend, sig) for _ in range(3)]
    assert len({(r.key.name, r.version) for r in recs}) == 1
    assert recs[0].signature[0] == pytest.approx(float(sig[0]), abs=1e-6)
    assert nearest_reference(reg, dep.cfg, dep.backend, np.zeros(3)) is None  # other shape


def test_nearest_reference_empty_falls_back_cold(tmp_path):
    reg = CalibrationRegistry(str(tmp_path))
    dep = Deployment.program(_cfg(), 0, device="cpu")
    assert nearest_reference(reg, dep.cfg, dep.backend, dep.drift_signature()) is None
    rep = dep.calibrate(2, steps=1, seq_len=16, warm_start=True, registry=reg, record=False)
    assert rep.warm_started is False and rep.warm_source is None
    assert reg.references(dep.cfg, dep.backend) == []


def test_deployment_warm_start_lowers_the_initial_loss(tmp_path):
    cfg = _cfg()
    reg = CalibrationRegistry(str(tmp_path))
    dep = Deployment.program(cfg, 0, device="cpu")
    dep.advance(24.0)
    dep.calibrate(4, registry=reg, steps=6, seq_len=16)
    dep.advance(24.0)
    dep.reset_adapters()
    warm = dep.calibrate(4, registry=reg, warm_start=True, steps=3, seq_len=16)
    cold_dep = Deployment.program(cfg, 0, device="cpu")
    cold_dep.advance(24.0)
    cold_dep.advance(24.0)
    cold = cold_dep.calibrate(4, steps=3, seq_len=16)
    assert warm.warm_started and warm.warm_source.endswith("@v1") and not cold.warm_started
    assert warm.initial_loss < cold.initial_loss and warm.final_loss <= cold.final_loss


def test_fleet_warm_start_parity(tmp_path):
    cfg = _cfg()
    reg = CalibrationRegistry(str(tmp_path))
    fleet = Fleet.program(cfg, 0, n_chips=2, device="cpu")
    fleet.advance(24.0)
    first = fleet.calibrate(4, registry=reg, steps=6, seq_len=16)
    assert all(reg.reference(reg.key_for(cfg, fleet.backend, fleet.chip_signature(c)))
               .meta["chip"] == c for c in (0, 1))
    assert first.warm_started_chips == []
    fleet.advance(24.0)
    fleet.reset_adapters()
    warm = fleet.calibrate(4, registry=reg, warm_start=True, steps=3, seq_len=16)
    cold_fleet = Fleet.program(cfg, 0, n_chips=2, device="cpu")
    cold_fleet.advance(24.0)
    cold_fleet.advance(24.0)
    cold = cold_fleet.calibrate(4, steps=3, seq_len=16)
    assert warm.warm_started_chips == [0, 1] and len(warm.warm_sources) == 2
    assert np.all(warm.final_loss <= cold.final_loss)
    assert np.all(warm.initial_loss < cold.initial_loss)


def test_fleet_warm_start_is_the_solo_warm_start(tmp_path):
    """Fleet chip ``i`` seeded from the registry is bitwise its solo
    deployment seeded from the same registry."""
    cfg = _cfg()
    reg = CalibrationRegistry(str(tmp_path))
    fleet = Fleet.program(cfg, 0, n_chips=2, device="cpu")
    fleet.advance([24.0, 48.0])
    fleet.calibrate(4, registry=reg, steps=2, seq_len=16)
    fleet.reset_adapters()
    warm = fleet.calibrate(4, registry=reg, warm_start=True, record=False, steps=2,
                           seq_len=16)
    dep = Deployment.program(cfg, (fleet.teacher_seed, fleet.chip_seed(1)), device="cpu")
    dep.advance(48.0)
    solo = dep.calibrate(4, registry=reg, warm_start=True, record=False, steps=2, seq_len=16)
    assert solo.warm_source == warm.warm_sources[1]
    np.testing.assert_array_equal(np.asarray(solo.losses, np.float32), warm.losses[:, 1])
    assert_bitwise(dep.adapters, fleet.chip(1).adapters)


def test_fleet_virgin_chip_seeds_from_a_sibling(tmp_path):
    cfg = _cfg()
    reg = CalibrationRegistry(str(tmp_path))
    fleet = Fleet.program(cfg, 0, n_chips=2, device="cpu")
    fleet.advance(24.0)
    fleet.calibrate(4, registry=reg, chips=[0], steps=4, seq_len=16)
    fleet.advance(24.0)
    fleet.reset_adapters()
    warm = fleet.calibrate(4, registry=reg, chips=[1], warm_start=True, steps=1, seq_len=16)
    assert warm.warm_started_chips == [1]
    assert warm.warm_sources[0].startswith(reg.key_for(cfg, fleet.backend,
                                                       fleet.chip_signature(0)).cfg_fp)


def test_fleet_loss_threshold_stops_early():
    cfg = _cfg()
    fleet = Fleet.program(cfg, 0, n_chips=2, device="cpu")
    fleet.advance(24.0)
    full = fleet.calibrate(4, steps=6, seq_len=16)
    assert full.epochs_run == 6
    again = Fleet.program(cfg, 0, n_chips=2, device="cpu")
    again.advance(24.0)
    early = again.calibrate(4, steps=6, seq_len=16,
                            loss_threshold=float(np.max(full.losses[0])) + 1.0)
    assert early.epochs_run == 1 and again.steps == [1, 1]
    np.testing.assert_array_equal(early.losses[0], full.losses[0])


def test_scheduler_reports_epoch_savings(tmp_path):
    reg = CalibrationRegistry(str(tmp_path))
    fleet = Fleet.program(_cfg(), 0, n_chips=2, device="cpu")
    sched = RecalibrationScheduler(
        fleet, threshold=1e-4, registry=reg,
        calib_args=dict(batch_or_samples=4, steps=6, seq_len=16, loss_threshold=0.04))
    report = sched.run([24.0, 24.0])
    assert report.warm_started_recalibrations > 0
    assert report.calibration_chip_epoch_budget >= report.calibration_chip_epochs
    assert report.calibration_epochs_saved == (report.calibration_chip_epoch_budget
                                               - report.calibration_chip_epochs)
    json.loads(report.to_json())


def test_calibration_report_json_round_trip():
    rep = CalibrationReport(
        losses=[0.5, 0.25], epochs_run=2, sram_bytes=64, rram_bytes=256, base_params=1024,
        adapter_params=24, calibrated_fraction=0.0234, backend="dequant", drift_events=3,
        warm_started=True, warm_source="abc/dequant/def@v2")
    assert rep.initial_loss == 0.5 and rep.final_loss == 0.25
    back = CalibrationReport.from_json(rep.to_json())
    assert back == rep and back.to_dict() == rep.to_dict()


def test_key_pair_program_and_drift_signature():
    cfg = _cfg()
    a = Deployment.program(cfg, 3, device="cpu")
    b = Deployment.program(cfg, (3, 4), device="cpu")
    assert (a.teacher_seed, a.program_seed) == (b.teacher_seed, b.program_seed) == (3, 4)
    assert_bitwise(a.codes, b.codes)
    a.advance(24.0)
    sig = a.drift_signature()
    assert sig.tolist() == drift_signature(cfg.rram, 4, field_hours=24.0, drift_events=1).tolist()
