"""Device non-ideality suite: composable fault injection on the crossbar
substrate. Port of ``repro/faults`` (the fleet's ``for_chip`` and
``build_fleet_map`` wait for the fleet).

``faults/map.py``: ``LeafFaults`` per RRAM leaf and ``FaultMap`` per
model, composed by a commutative, idempotent join.
``faults/generators.py``: serializable ``FaultSpec`` events
(``stuck_at``, ``saturated``, ``retention``, ``iv_nonlinearity``) that
materialize into maps, per leaf from ``crc32(path)``-keyed streams or
from draws passed in. ``Deployment.inject(faults)`` records them; they
apply at code read-back through ``substrate.faulted_codes``, so every
backend and the prepared serving tree read the same faulty codes.
``faults/study.py``: the accuracy-recovery experiment.
"""
from repro_torch.faults.generators import (  # noqa: F401
    FAULT_KINDS,
    FaultSpec,
    build_map,
    iv_nonlinearity,
    retention,
    saturated,
    stuck_at,
)
from repro_torch.faults.map import (  # noqa: F401
    FaultMap,
    LeafFaults,
    apply_fault_map,
    compose_maps,
)
from repro_torch.faults.study import (  # noqa: F401
    FAULT_CLASSES,
    default_spec,
    fault_recovery_study,
)
