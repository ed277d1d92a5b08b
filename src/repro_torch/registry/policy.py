"""Reference-promotion rules for the calibration registry. Port of
``repro/registry/policy.py``.

Every recorded calibration is a new immutable version under its ``(cfg
fingerprint, backend, drift signature)`` key; at most one version per key
is the promoted reference, the artifact warm starts seed from and fresh
runs are checked against:

* **the first run always promotes**: a key without a reference has
  nothing to compare against and nothing to warm-start from;
* **later runs promote only on instability**: a fresh run whose
  distribution still matches the reference (``metrics.is_stable``) leaves
  it in place; one that drifted away replaces it.

The store applies a promotion atomically (a temporary file and
``os.replace`` of the pointer), so no reader sees half of one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.registry.metrics import StabilityMetrics


@dataclasses.dataclass(frozen=True)
class PromotionDecision:
    promote: bool
    reason: str


class PromotionPolicy:
    """Promote on instability (see the module docstring). Subclass and
    override ``decide`` for another economy (always promote, for a
    rolling cache; never, for a frozen registry)."""

    def decide(self, *, has_reference: bool,
               metrics: Optional[StabilityMetrics]) -> PromotionDecision:
        if not has_reference:
            return PromotionDecision(True, "first run for key")
        if metrics is None:
            # a reference exists but could not be compared (its samples
            # were lost): promote so the key heals itself
            return PromotionDecision(True, "reference unreadable")
        if metrics.is_stable:
            return PromotionDecision(False, "reference stable")
        drifted = ", ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.drifts().items()))
        return PromotionDecision(True, f"reference unstable ({drifted})")
