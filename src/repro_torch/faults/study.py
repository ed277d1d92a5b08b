"""Fault-recovery study: the paper's "calibrate, don't reprogram" claim
against every fault class. Port of ``repro/faults/study.py``.

For each class: program a deployment, age it in the field, inject the
fault, then run DoRA calibration (SRAM side-cars only, no RRAM write),
recording the teacher/student logit MSE at each point:

    clean      programmed + drifted, before the fault
    faulted    after injection, before any recovery
    calibrated after calibration on the faulty base

``recovered_fraction`` is the share of the faulted error calibration
removed. The defaults are the paper's calibration scale (10 samples, 20
steps).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

FAULT_CLASSES = ("stuck_at", "saturated", "retention", "iv_nonlinearity")


def default_spec(kind: str, seed: int = 1):
    """The study's severity per fault class: strong enough to degrade the
    logits measurably, mild enough for a rank-8 side-car to compensate."""
    from repro_torch.faults import generators as G

    if kind == "stuck_at":
        return G.stuck_at(seed, rate=0.02, lrs_fraction=0.5)
    if kind == "saturated":
        return G.saturated(seed, rate=0.10, cap_fraction=0.6)
    if kind == "retention":
        return G.retention(seed, rate=0.10, retain=0.6)
    if kind == "iv_nonlinearity":
        return G.iv_nonlinearity(1.5)
    raise ValueError(f"unknown fault class {kind!r}; known: {FAULT_CLASSES}")


def fault_recovery_study(
    arch: str = "qwen3_1_7b", *, smoke: bool = True, samples: int = 10,
    steps: int = 20, seq_len: int = 32, hours: float = 300.0, seed: int = 0,
    classes: Optional[Sequence[str]] = None, backend: str = "dequant",
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Run the study on ``device``; per-class metric dicts. Deterministic
    in every argument (batch, programming, drift and fault draws all come
    from seeds)."""
    import time

    from repro_torch.configs import get_arch
    from repro_torch.deploy.deployment import Deployment, calibration_batch

    spec = get_arch(arch)
    cfg = spec.smoke if smoke else spec.full
    batch = calibration_batch(cfg, samples, seq_len)
    results: Dict[str, Dict[str, float]] = {}
    for kind in classes or FAULT_CLASSES:
        t0 = time.perf_counter()
        dep = Deployment.program(cfg, seed, backend=backend, device=device)
        dep.advance(hours)
        clean = dep.logit_mse(batch)
        dep.inject(default_spec(kind, seed + 1))
        faulted = dep.logit_mse(batch)
        report = dep.calibrate(batch, steps=steps)
        calibrated = dep.logit_mse(batch)
        del dep  # one deployment at a time on the card
        results[kind] = {
            "clean_mse": float(clean),
            "faulted_mse": float(faulted),
            "calibrated_mse": float(calibrated),
            "recovered_fraction": (
                float((faulted - calibrated) / faulted) if faulted > 0 else 0.0
            ),
            "calib_final_feature_mse": float(report.final_loss),
            "calib_epochs": int(report.epochs_run),
            "hours": float(hours),
            "seconds": time.perf_counter() - t0,
        }
    return results
