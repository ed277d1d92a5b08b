"""Fleet subsystem: N chips, one model, stacked trees. Port of
``repro/fleet``.

    from repro_torch.fleet import Fleet, RecalibrationScheduler

    fleet = Fleet.program(cfg, 0, n_chips=64, backend="codes")
    fleet.advance([6 * (i % 5) for i in range(64)])   # heterogeneous aging
    sched = RecalibrationScheduler(fleet, threshold=0.02,
                                   calib_args={"steps": 8})
    report = sched.run([24.0] * 12)    # a year of maintenance ticks
    print(report.summary())            # recalibrations avoided vs naive
    session = fleet.serve(7)           # any chip

Chip ``i`` is bitwise an independent ``Deployment.program(cfg,
(fleet.teacher_seed, fleet.chip_seed(i)))`` at every point of its life:
the fleet is an execution strategy (stacked state, one teacher pass, one
calibration step a call), not a different model.
"""
from repro_torch.fleet.fleet import (  # noqa: F401
    Fleet,
    FleetCalibrationReport,
    chip_axes,
    chip_seeds,
    fleet_compile_count,
    fleet_program_model,
)
from repro_torch.fleet.scheduler import (  # noqa: F401
    FleetReport,
    RecalibrationScheduler,
    TickRecord,
)
