"""Nearest-stable-reference warm start for DoRA calibration. Port of
``repro/registry/warmstart.py``.

Calibration is otherwise paid from the fresh (output-preserving) adapters
every time. But a chip recalibrating after one more drift epoch starts a
small step from its last optimum, and a chip that just joined starts
closer to a sibling's compensation than to the fresh adapters. This
module makes the registry's promoted references those starting points:

* ``drift_signature``: a small float vector of a device's drift and fault
  state: a device feature (a crc32 of the programming seed, scaled by
  ``DEVICE_WEIGHT``), the drift sigma over the elapsed field hours, a
  log-time feature, the drift-event count and the fault-event count.
  Components 1-4 are the reference's arithmetic; the device feature hashes
  the port's integer seed where the reference hashes its key words. The
  device feature dominates distances between devices, so a chip's own
  history wins the lookup whenever it exists, and a chip without one
  falls back to the nearest sibling.
* ``nearest_reference``: the Euclidean nearest promoted reference under
  ``(cfg, backend)``, ties broken by signature key: a pure function of the
  registry's contents.
* ``seed_deployment`` / ``seed_fleet``: adapters and AdamW state from the
  reference instead of the fresh ones; the fleet form loads each distinct
  artifact once and writes the chips' rows with one index copy per leaf.
"""
from __future__ import annotations

import zlib
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import rram
from repro_torch.registry.store import ArtifactRecord, CalibrationRegistry

Pytree = Any

# Scale of the device-identity component beside the drift-state ones:
# drift-state distances per cycle are ~1e-2, two devices differ by up to
# DEVICE_WEIGHT, so a device's own references win whenever they exist.
DEVICE_WEIGHT = 0.25

# keep the time and event components commensurate with sigma (~1e-1)
_LOG_TIME_SCALE = 1.0 / 16.0
_EVENT_SCALE = 1.0 / 32.0


def device_feature(program_seed: int) -> float:
    """A device-identity feature in ``[0, DEVICE_WEIGHT)``: a crc32 of the
    programming seed's 64-bit word. An identity separator, not a metric."""
    words = np.asarray([int(program_seed) & 0xFFFFFFFFFFFFFFFF], np.uint64)
    return DEVICE_WEIGHT * (zlib.crc32(words.tobytes()) / 2.0 ** 32)


def drift_signature(rcfg: rram.RramConfig, program_seed: int, *, field_hours: float,
                    drift_events: int, fault_events: int = 0) -> np.ndarray:
    """The registry signature of one device's drift and fault state: the
    same lifecycle (seed and history) gives the same vector, and hence the
    same key; nearby drift states land nearby. A fault event weighs 1.0,
    so a faulted chip's compensation never seeds a healthy one unnoticed."""
    return np.asarray([
        device_feature(program_seed),
        rram.drift_sigma(rcfg, float(field_hours)),
        np.log1p(float(field_hours)) * _LOG_TIME_SCALE,
        float(drift_events) * _EVENT_SCALE,
        float(fault_events),
    ], np.float64)


def signature_distance(a, b) -> float:
    """Euclidean distance between two signature vectors."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.shape != b.shape:
        return float("inf")
    return float(np.sqrt(np.sum((a - b) ** 2)))


def nearest_reference(registry: CalibrationRegistry, cfg, backend: str,
                      signature) -> Optional[ArtifactRecord]:
    """The promoted reference nearest ``signature`` under ``(cfg,
    backend)``, ranked by ``(distance, signature key)``: repeated lookups
    against the same registry return the same record."""
    refs = registry.references(cfg, backend)
    if not refs:
        return None
    best = min(refs, key=lambda r: (signature_distance(signature, r.signature),
                                    r.key.sig_key))
    if signature_distance(signature, best.signature) == float("inf"):
        return None
    return best


def seed_deployment(dep, registry: CalibrationRegistry) -> Optional[ArtifactRecord]:
    """Warm-start one deployment: its adapters and AdamW state from the
    nearest stable reference to its drift signature, bitwise as recorded.
    Returns the record, or None when the registry has nothing usable (the
    caller starts cold)."""
    from repro_torch.optim.adam import adamw_init

    rec = nearest_reference(registry, dep.cfg, dep.backend, dep.drift_signature())
    if rec is None:
        return None
    like = {"adapters": dep.adapters,
            "opt": dep.opt_state if dep.opt_state is not None else adamw_init(dep.adapters)}
    trees = registry.load(rec, like, device=dep.device)
    dep.adapters, dep.opt_state = trees["adapters"], trees["opt"]
    return rec


def seed_fleet(fleet, registry: CalibrationRegistry,
               chips: Sequence[int]) -> List[Optional[ArtifactRecord]]:
    """Warm-start ``chips`` of a fleet: each chip's nearest stable
    reference to its own signature, every distinct artifact loaded once,
    then one ``index_copy_`` per leaf of the stacked adapters and AdamW
    state. A chip without a usable reference keeps its state. Returns the
    per-chip records (None: cold)."""
    recs: List[Optional[ArtifactRecord]] = [
        nearest_reference(registry, fleet.cfg, fleet.backend, fleet.chip_signature(c))
        for c in chips]
    hits = [(c, r) for c, r in zip(chips, recs) if r is not None]
    if not hits:
        return recs
    from repro_torch.optim.adam import AdamState

    def flat(trees):  # the adapters, then the AdamState's step, mu and nu
        return tree_lib.tensors([trees["adapters"], *trees["opt"]])

    stacked = {"adapters": fleet.adapters, "opt": fleet.optimizer_state()}
    like = {"adapters": tree_lib.map_tensors(lambda t: t[0], stacked["adapters"]),
            "opt": AdamState(*(tree_lib.map_tensors(lambda t: t[0], s)
                               for s in stacked["opt"]))}
    cache = {}
    rows = []
    for _, rec in hits:
        k = (rec.key.name, rec.version)
        if k not in cache:
            cache[k] = flat(registry.load(rec, like, device=fleet.device))
        rows.append(cache[k])
    idx = torch.tensor([c for c, _ in hits], dtype=torch.long, device=fleet.device)
    with torch.no_grad():
        for i, full in enumerate(flat(stacked)):
            full.index_copy_(0, idx, torch.stack([r[i] for r in rows]))
    return recs
