"""Versioned calibration registry: stability metrics, reference
promotion and fleet-wide DoRA warm start. Port of ``repro/registry``.

Every ``Deployment.calibrate`` / ``Fleet.calibrate`` run can be kept as a
versioned artifact keyed by ``(cfg fingerprint, backend, drift/fault
signature)``; stability metrics (percentile drift, JSD, ``is_stable``)
decide when a key's promoted reference is replaced; and new or
recalibrating chips start their adapters and AdamW state from the nearest
stable reference instead of the fresh ones:

    from repro_torch.registry import CalibrationRegistry

    registry = CalibrationRegistry("/var/cal-registry")
    dep.calibrate(10, registry=registry)                   # record v1
    dep.advance(hours=168)
    dep.calibrate(10, registry=registry, warm_start=True)  # seeded

``registry/store.py`` holds the artifact layout, ``metrics`` the drift
metrics, ``policy`` the promotion rules and ``warmstart`` the lookup.
"""
from repro_torch.registry.metrics import (  # noqa: F401
    DEFAULT_THRESHOLDS,
    StabilityMetrics,
    StabilityThresholds,
    adapter_samples,
    is_stable_under,
    jensen_shannon,
    stability_metrics,
)
from repro_torch.registry.policy import PromotionDecision, PromotionPolicy  # noqa: F401
from repro_torch.registry.store import (  # noqa: F401
    ArtifactRecord,
    CalibrationRegistry,
    RegistryKey,
    cfg_fingerprint,
    signature_key,
)
from repro_torch.registry.warmstart import (  # noqa: F401
    drift_signature,
    nearest_reference,
    seed_deployment,
    seed_fleet,
    signature_distance,
)
