"""Versioned, content-addressed calibration artifact store. Port of
``repro/registry/store.py``, on the reference's on-disk layout:

    <root>/<cfg_fp>/<backend>/<sig_key>/
        store/step_0000000001/         # CheckpointManager payload: the
        store/step_0000000002/         #   adapters and the AdamW state
        v0000001.json                  # metadata sidecar per version
        v0000001_samples.npy           # adapter sample vector (metrics)
        reference.json                 # the promoted stable reference

* the payload rides on ``checkpoint.CheckpointManager`` (atomic
  temporary-then-rename commits; the version number is the manager's
  step) with unbounded retention: a registry is an archive;
* the JSON sidecar holds what a reader needs without loading arrays: the
  signature, the serialized ``CalibrationReport`` and the stability
  metrics measured against the reference when the version was recorded;
* the sample vector (``metrics.adapter_samples``) lies beside it, so a
  drift check never reads a whole adapter tree;
* ``reference.json`` names the key's promoted version and is replaced
  atomically, only when the promotion policy says so.

A version exists once its sidecar is on disk: the sidecar is written
last, so a crash mid-record leaves at worst a payload the next record
overwrites.

``cfg_fingerprint`` hashes the port's config ``repr``, which spells its
dtypes as torch's, so the port's keys differ from the reference's for the
same architecture: no artifact crosses packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import tree as tree_lib
from repro_torch.checkpoint.manager import CheckpointManager, as_manager
from repro_torch.registry.metrics import (
    DEFAULT_THRESHOLDS,
    StabilityMetrics,
    StabilityThresholds,
    adapter_samples,
    stability_metrics,
)
from repro_torch.registry.policy import PromotionDecision, PromotionPolicy

Pytree = Any

_SIG_DECIMALS = 6          # signature quantization for key identity
_FP_CHARS = 12             # hex chars kept from content hashes
_REFERENCE = "reference.json"
_STORE_DIR = "store"


def _short_hash(payload: str) -> str:
    return hashlib.sha1(payload.encode()).hexdigest()[:_FP_CHARS]


def cfg_fingerprint(cfg) -> str:
    """Content fingerprint of a model config: the frozen dataclass's
    ``repr`` hashed, stable across processes; any field change changes it,
    so artifacts never cross configs."""
    return _short_hash(repr(cfg))


def quantized_signature(signature) -> List[float]:
    """The signature rounded to key precision: drift states that agree to
    1e-6 share a key; farther ones are found by nearest-reference lookup."""
    return [float(round(float(v), _SIG_DECIMALS))
            for v in np.asarray(signature, np.float64).ravel()]


def signature_key(signature) -> str:
    return _short_hash(json.dumps(quantized_signature(signature)))


def _atomic_json(path: str, payload: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _atomic_npy(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


@dataclasses.dataclass(frozen=True)
class RegistryKey:
    """One registry key: the identity an artifact is filed under."""

    cfg_fp: str
    backend: str
    sig_key: str
    signature: tuple  # quantized signature values

    @property
    def name(self) -> str:
        return f"{self.cfg_fp}/{self.backend}/{self.sig_key}"


@dataclasses.dataclass(frozen=True)
class ArtifactRecord:
    """One immutable recorded calibration (key, version, sidecar)."""

    key: RegistryKey
    version: int
    signature: np.ndarray
    meta: Dict
    promoted: bool

    @property
    def name(self) -> str:
        return f"{self.key.name}@v{self.version}"


class CalibrationRegistry:
    """A fleet-wide archive of versioned calibration artifacts (see the
    module docstring); ``registry/warmstart.py`` builds the
    nearest-stable-reference lookup on it."""

    def __init__(self, root: str, *, thresholds: StabilityThresholds = DEFAULT_THRESHOLDS,
                 policy: Optional[PromotionPolicy] = None, sample_cap: int = 65536):
        self.root = str(root)
        self.thresholds = thresholds
        self.policy = policy if policy is not None else PromotionPolicy()
        self.sample_cap = int(sample_cap)
        os.makedirs(self.root, exist_ok=True)

    # -- keys -----------------------------------------------------------------

    def key_for(self, cfg, backend: str, signature) -> RegistryKey:
        return RegistryKey(cfg_fp=cfg_fingerprint(cfg), backend=str(backend),
                           sig_key=signature_key(signature),
                           signature=tuple(quantized_signature(signature)))

    def _key_dir(self, key: RegistryKey) -> str:
        return os.path.join(self.root, key.cfg_fp, key.backend, key.sig_key)

    def _manager(self, key: RegistryKey) -> CheckpointManager:
        # a key archives every version: retention is unbounded
        return as_manager(os.path.join(self._key_dir(key), _STORE_DIR), keep=10 ** 9)

    # -- introspection ----------------------------------------------------------

    def versions(self, key: RegistryKey) -> List[int]:
        """Every recorded version under ``key``, ascending (a version exists
        iff its sidecar does)."""
        d = self._key_dir(key)
        if not os.path.isdir(d):
            return []
        out = []
        for name in os.listdir(d):
            if name.startswith("v") and name.endswith(".json"):
                try:
                    out.append(int(name[1:-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def artifact(self, key: RegistryKey, version: int) -> ArtifactRecord:
        meta = self._read_meta(key, version)
        return ArtifactRecord(key=key, version=version,
                              signature=np.asarray(meta["signature"], np.float64),
                              meta=meta, promoted=(self._read_reference(key) == version))

    def _meta_path(self, key: RegistryKey, version: int) -> str:
        return os.path.join(self._key_dir(key), f"v{version:07d}.json")

    def _samples_path(self, key: RegistryKey, version: int) -> str:
        return os.path.join(self._key_dir(key), f"v{version:07d}_samples.npy")

    def _read_meta(self, key: RegistryKey, version: int) -> Dict:
        with open(self._meta_path(key, version)) as f:
            return json.load(f)

    def _read_reference(self, key: RegistryKey) -> Optional[int]:
        path = os.path.join(self._key_dir(key), _REFERENCE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(json.load(f)["version"])

    def reference(self, key: RegistryKey) -> Optional[ArtifactRecord]:
        """The promoted stable reference for ``key`` (None: a virgin key)."""
        version = self._read_reference(key)
        return None if version is None else self.artifact(key, version)

    def references(self, cfg, backend: str) -> List[ArtifactRecord]:
        """Every key's promoted reference under ``(cfg, backend)``, ordered
        by signature key: the candidates of a warm-start lookup."""
        base = os.path.join(self.root, cfg_fingerprint(cfg), str(backend))
        if not os.path.isdir(base):
            return []
        out: List[ArtifactRecord] = []
        for sig_key in sorted(os.listdir(base)):
            ref_path = os.path.join(base, sig_key, _REFERENCE)
            if not os.path.exists(ref_path):
                continue
            with open(ref_path) as f:
                version = int(json.load(f)["version"])
            meta_path = os.path.join(base, sig_key, f"v{version:07d}.json")
            if not os.path.exists(meta_path):
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            key = RegistryKey(cfg_fp=cfg_fingerprint(cfg), backend=str(backend),
                              sig_key=sig_key, signature=tuple(meta["signature"]))
            out.append(ArtifactRecord(key=key, version=version,
                                      signature=np.asarray(meta["signature"], np.float64),
                                      meta=meta, promoted=True))
        return out

    def samples(self, record: ArtifactRecord) -> Optional[np.ndarray]:
        path = self._samples_path(record.key, record.version)
        return np.load(path) if os.path.exists(path) else None

    # -- record -----------------------------------------------------------------

    def record(self, cfg, backend: str, signature, *, adapters: Pytree, opt_state: Pytree,
               report=None, extra_meta: Optional[Dict] = None) -> ArtifactRecord:
        """Persist one calibration run as its key's next version, measure
        its stability against the key's reference and, as the promotion
        policy decides, promote it atomically. ``meta['metrics']`` holds the
        measured drift, ``meta['promotion']`` the decision."""
        key = self.key_for(cfg, backend, signature)
        os.makedirs(self._key_dir(key), exist_ok=True)
        existing = self.versions(key)
        version = (existing[-1] + 1) if existing else 1

        samples = adapter_samples(adapters, cap=self.sample_cap)
        ref_version = self._read_reference(key)
        metrics: Optional[StabilityMetrics] = None
        if ref_version is not None:
            ref_samples = self.samples(ArtifactRecord(key, ref_version, np.zeros(0), {}, True))
            if ref_samples is not None:
                metrics = stability_metrics(samples, ref_samples, thresholds=self.thresholds)
        decision: PromotionDecision = self.policy.decide(
            has_reference=ref_version is not None, metrics=metrics)

        if report is not None and hasattr(report, "to_dict"):
            report = report.to_dict()
        meta = {
            "format": 1,
            "version": version,
            "cfg_fp": key.cfg_fp,
            "backend": key.backend,
            "signature": list(key.signature),
            "reference_version": ref_version,
            "report": report,
            "metrics": None if metrics is None else metrics.to_dict(),
            "promotion": {"promote": decision.promote, "reason": decision.reason},
            "thresholds": self.thresholds.to_dict(),
        }
        if extra_meta:
            meta.update(extra_meta)

        # payload first, samples second, the sidecar last (a version exists
        # iff its sidecar does), the promotion once the version is whole
        self._manager(key).save(version, {"adapters": adapters, "opt": opt_state})
        _atomic_npy(self._samples_path(key, version), samples)
        _atomic_json(self._meta_path(key, version), meta)
        if decision.promote:
            _atomic_json(os.path.join(self._key_dir(key), _REFERENCE),
                         {"version": version, "reason": decision.reason})
        return ArtifactRecord(key=key, version=version,
                              signature=np.asarray(key.signature, np.float64),
                              meta=meta, promoted=decision.promote)

    # -- load -------------------------------------------------------------------

    def load(self, record: ArtifactRecord, like: Dict[str, Pytree], *, device=None) -> Dict:
        """A record's payload trees, bitwise as recorded. ``like`` gives
        structure, dtypes and shapes (``{"adapters": dep.adapters, "opt":
        adamw_init(dep.adapters)}``); the tensors land on ``device``, by
        default ``like``'s."""
        if device is None:
            leaves = tree_lib.tensors(like["adapters"] if "adapters" in like else like)
            device = leaves[0].device if leaves else "cpu"
        return self._manager(record.key).restore(record.version, like, device=device)
