"""Stability metrics over calibration-artifact distributions. Port of
``repro/registry/metrics.py``; numpy arithmetic, so the numbers equal the
reference's on the same inputs.

A calibration run is summarized by a 1-D sample vector (``adapter_samples``:
the adapter values, or any logit or score distribution), and two runs are
compared with the drift metrics the nomarr calibration system tracks:

* **absolute percentile drift** (``apd_p5`` / ``apd_p95``): movement of the
  5th / 95th percentile over the reference's p5-p95 range;
* **scale-range drift** (``srd``): relative change of that range;
* **Jensen-Shannon divergence** (``jsd``): symmetric, in [0, 1] in base 2,
  zero iff the binned distributions coincide;
* **median / IQR drift**, over the same range.

``is_stable`` holds iff every metric is at or below its threshold, so the
decision is monotone in the thresholds. Defaults: percentile, median and
IQR drift within 2 % / 2 % / 5 % of the reference range, range drift 5 %,
JSD 0.05 bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

Pytree = Any

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class StabilityThresholds:
    """Per-metric upper bounds for the ``is_stable`` decision."""

    apd: float = 0.02      # p5/p95 drift, in units of the reference range
    srd: float = 0.05      # relative p95-p5 range drift
    jsd: float = 0.05      # Jensen-Shannon divergence (base-2 bits)
    median: float = 0.02   # median drift, in units of the reference range
    iqr: float = 0.05      # IQR drift, in units of the reference range

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


DEFAULT_THRESHOLDS = StabilityThresholds()


@dataclasses.dataclass
class StabilityMetrics:
    """One run's drift metrics against a reference run (nomarr schema)."""

    p5: float              # current 5th percentile
    p95: float             # current 95th percentile
    range: float           # p95 - p5
    apd_p5: float          # |p5 - ref_p5| / ref_range
    apd_p95: float         # |p95 - ref_p95| / ref_range
    srd: float             # |range - ref_range| / ref_range
    jsd: float             # Jensen-Shannon divergence, base-2
    median_drift: float    # |median - ref_median| / ref_range
    iqr_drift: float       # |iqr - ref_iqr| / ref_range
    is_stable: bool

    def drifts(self) -> Dict[str, float]:
        """The drift metrics the stability decision reads (name -> value)."""
        return {
            "apd_p5": self.apd_p5, "apd_p95": self.apd_p95,
            "srd": self.srd, "jsd": self.jsd,
            "median_drift": self.median_drift, "iqr_drift": self.iqr_drift,
        }

    def to_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["is_stable"] = bool(self.is_stable)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "StabilityMetrics":
        return cls(**d)


def is_stable_under(metrics: StabilityMetrics, thresholds: StabilityThresholds) -> bool:
    """Stable iff every drift metric is at or below its bound; monotone in
    the thresholds."""
    return bool(
        metrics.apd_p5 <= thresholds.apd
        and metrics.apd_p95 <= thresholds.apd
        and metrics.srd <= thresholds.srd
        and metrics.jsd <= thresholds.jsd
        and metrics.median_drift <= thresholds.median
        and metrics.iqr_drift <= thresholds.iqr
    )


def jensen_shannon(current: np.ndarray, reference: np.ndarray, *, bins: int = 64) -> float:
    """Jensen-Shannon divergence between two sample vectors, binned over
    their joint range; base-2, in [0, 1], exactly 0 when both bin alike."""
    cur = np.asarray(current, np.float64).ravel()
    ref = np.asarray(reference, np.float64).ravel()
    lo = min(cur.min(), ref.min())
    hi = max(cur.max(), ref.max())
    if hi <= lo:  # both degenerate at one point
        hi = lo + 1.0
    edges = np.linspace(lo, hi, bins + 1)
    p, _ = np.histogram(cur, bins=edges)
    q, _ = np.histogram(ref, bins=edges)
    p = p / max(p.sum(), 1)
    q = q / max(q.sum(), 1)
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

    return max(0.0, 0.5 * kl(p, m) + 0.5 * kl(q, m))


def stability_metrics(current: np.ndarray, reference: np.ndarray, *,
                      thresholds: StabilityThresholds = DEFAULT_THRESHOLDS,
                      bins: int = 64) -> StabilityMetrics:
    """A fresh run's sample distribution against the reference's, with the
    stability decision. Location and spread drifts are over the
    reference's p5-p95 range (floored at ``1e-12``); a run against itself
    is exactly zero on every drift metric."""
    cur = np.asarray(current, np.float64).ravel()
    ref = np.asarray(reference, np.float64).ravel()
    c5, c25, c50, c75, c95 = np.percentile(cur, [5, 25, 50, 75, 95])
    r5, r25, r50, r75, r95 = np.percentile(ref, [5, 25, 50, 75, 95])
    ref_range = max(abs(r95 - r5), _EPS)
    m = StabilityMetrics(
        p5=float(c5),
        p95=float(c95),
        range=float(c95 - c5),
        apd_p5=abs(c5 - r5) / ref_range,
        apd_p95=abs(c95 - r95) / ref_range,
        srd=abs((c95 - c5) - (r95 - r5)) / ref_range,
        jsd=jensen_shannon(cur, ref, bins=bins),
        median_drift=abs(c50 - r50) / ref_range,
        iqr_drift=abs((c75 - c25) - (r75 - r25)) / ref_range,
        is_stable=False,
    )
    m.is_stable = is_stable_under(m, thresholds)
    return m


def adapter_samples(adapters: Pytree, *, cap: int = 65536) -> np.ndarray:
    """A deterministic 1-D f32 sample vector over an adapter tree: every
    float tensor, flattened, in the reference's leaf order (JAX's: dict
    keys sorted), copied to the host as f32 and stride-subsampled to at
    most ``cap`` values (the same stride for the same tree shape)."""
    from repro_torch.checkpoint.manager import flatten_with_names

    leaves = [t.detach().to("cpu", torch.float32).reshape(-1).numpy()
              for _, t in flatten_with_names(adapters)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return np.zeros((1,), np.float32)
    flat = np.concatenate(leaves)
    if flat.size > cap:
        stride = int(np.ceil(flat.size / cap))
        flat = flat[::stride]
    return flat
