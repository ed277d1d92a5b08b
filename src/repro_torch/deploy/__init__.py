"""Deployment lifecycle API of the port (``repro.deploy``'s counterpart):

    from repro_torch.deploy import Deployment

    dep = Deployment.program(cfg, seed, backend="codes")  # on the card
    dep.advance(hours=24)          # drift clock: field time passes
    report = dep.calibrate(10)     # feature-KD DoRA, codes never written
    session = dep.serve()          # merged adapters + backend scope
    toks, dt = session.generate(prompt)

the fleet (``repro_torch.fleet``: ``Fleet``, ``RecalibrationScheduler``,
also importable from here),

and the paper's CNN experiment, one cell at a time:

    r = resnet_cell(method="dora", rank=2, drift=0.20, samples=10)
"""
from repro_torch.deploy.deployment import (  # noqa: F401
    CalibrationReport,
    Deployment,
    calibration_batch,
)
from repro_torch.deploy.engine import Request, ServeEngine  # noqa: F401
from repro_torch.deploy.serving import (  # noqa: F401
    BACKENDS,
    ServeSession,
    backend_scope,
    generate,
    prefill_and_cache,
)


_FLEET_EXPORTS = (
    "Fleet", "FleetCalibrationReport", "FleetReport",
    "RecalibrationScheduler", "fleet_compile_count",
)


def __getattr__(name):
    # the fleet imports this package: its names resolve on first use
    if name in _FLEET_EXPORTS:
        import repro_torch.fleet as _fleet

        return getattr(_fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resnet_cell(**kwargs):
    """CNN-lifecycle entry (paper §IV, the Fig. 4/6 protocol): teacher ->
    drift -> calibrate -> evaluate for the ResNet reproduction, on the
    card unless ``device=`` says otherwise; see
    ``core/repro_experiments.run_cell``."""
    from repro_torch.core.repro_experiments import run_cell

    return run_cell(**kwargs)
