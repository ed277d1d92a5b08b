"""Drift-driven recalibration scheduling over a ``Fleet``. Port of
``repro/fleet/scheduler.py`` (its mesh and compressed-gradient options
wait for the port's distributed slice).

A fixed-interval policy recalibrates every chip at every maintenance
tick whether it needs it or not. But drift is log-time
(``rram.drift_sigma``) and heterogeneous: a chip that just recalibrated,
or one that barely aged this tick, has nothing to recover. The
``RecalibrationScheduler`` advances the fleet's per-chip clocks, reads
the forward-free drift proxy (``Fleet.drift_proxy``: the relative
movement of the code column norms the merged DoRA gamma divides by), and
calibrates only the chips whose proxy crossed the threshold.

``FleetReport`` carries the economics: recalibrations done against the
fixed-interval count (the avoided ones are pure savings: calibration
writes SRAM only, so they are compute and energy, not endurance), per-chip
losses and proxies, the resident SRAM and RRAM bytes, and the paper's
``lifespan_calibrations`` (Table I): even the scheduled recalibrations
never write the array, so lifetime stays bound by SRAM's 1e16 writes, not
RRAM's 1e8.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import rram
from repro_torch.fleet.fleet import Fleet, FleetCalibrationReport


@dataclasses.dataclass
class TickRecord:
    """One maintenance tick: what aged, what the proxies read, who was
    recalibrated on which path (empty lists: nobody crossed a
    threshold). ``hard_faulted`` chips took the hard-fault path
    (``hard_calib_args``); ``recalibrated`` lists the drift path only."""

    tick: int
    hours: List[float]            # per-chip elapsed hours this tick
    proxy: np.ndarray             # (n_chips,) drift proxy AFTER aging
    recalibrated: List[int]
    report: Optional[FleetCalibrationReport]
    hard_proxy: Optional[np.ndarray] = None   # (n_chips,) max-column jump
    hard_faulted: List[int] = dataclasses.field(default_factory=list)
    hard_report: Optional[FleetCalibrationReport] = None


@dataclasses.dataclass
class FleetReport:
    """Fleet-lifetime accounting emitted by the scheduler."""

    n_chips: int
    ticks: int
    threshold: float
    recalibrations: int              # proxy-triggered, summed over ticks
    naive_recalibrations: int        # fixed-interval: n_chips per tick
    recalibrations_avoided: int
    per_chip_recalibrations: List[int]
    per_chip_field_hours: List[float]
    per_chip_proxy: List[float]      # proxy at the last tick
    per_chip_loss: List[float]       # last calibration's final feature MSE
                                     # per chip (nan: never recalibrated)
    sram_bytes: int                  # fleet-total resident side-car bytes
    rram_bytes: int                  # fleet-total resident code bytes
    calib_samples: int
    calib_epochs: int
    # paper Table I: calibrations until the written storage wears out.
    # DoRA writes SRAM only, so even the scheduled recalibrations leave
    # lifetime at 1e16-endurance scale; backprop-on-RRAM would burn
    # array endurance with every one of them.
    sram_lifespan_calibrations: float
    rram_lifespan_calibrations: float
    # hard-fault accounting (non-ideality suite): drift-path vs
    # hard-fault-path recalibrations sum to ``recalibrations``;
    # ``hard_faulted_chips`` stay flagged for the fleet's lifetime —
    # DoRA recovers their accuracy without an RRAM rewrite, but the
    # damage is physical and the operator should schedule replacement.
    hard_threshold: Optional[float] = None
    drift_recalibrations: int = 0
    hard_recalibrations: int = 0
    per_chip_hard_recalibrations: List[int] = dataclasses.field(
        default_factory=list
    )
    hard_faulted_chips: List[int] = dataclasses.field(default_factory=list)
    per_chip_hard_proxy: List[float] = dataclasses.field(default_factory=list)
    # registry warm-start accounting (steps-to-converge economics): a
    # chip-epoch is one chip trained for one epoch; the budget is what
    # running every triggered recalibration to its full configured step
    # count would have spent, so ``calibration_epochs_saved`` is the
    # concrete convergence saving the warm-started references bought
    # (0 without a registry or a ``loss_threshold`` to converge against).
    warm_started_recalibrations: int = 0
    calibration_chip_epochs: int = 0
    calibration_chip_epoch_budget: int = 0
    calibration_epochs_saved: int = 0

    def summary(self) -> str:
        avoided_pct = (
            100.0 * self.recalibrations_avoided
            / max(self.naive_recalibrations, 1)
        )
        hard = (
            f" | hard-faulted chips {self.hard_faulted_chips} "
            f"({self.hard_recalibrations} hard-path recalibrations)"
            if self.hard_faulted_chips else ""
        )
        return (
            f"fleet of {self.n_chips}: {self.ticks} ticks, "
            f"{self.recalibrations} recalibrations "
            f"({self.recalibrations_avoided} avoided vs naive "
            f"fixed-interval = {avoided_pct:.0f}%){hard} | "
            f"sram_bytes={self.sram_bytes} rram_bytes={self.rram_bytes} | "
            f"lifespan: {self.sram_lifespan_calibrations:.2e} SRAM "
            f"calibrations vs {self.rram_lifespan_calibrations:.2e} "
            f"if backprop wrote RRAM"
        )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, sort_keys=True, default=float)


class RecalibrationScheduler:
    """Advance heterogeneous chip clocks; recalibrate only past-threshold
    chips. See module docstring.

    ``calib_args`` are forwarded to ``Fleet.calibrate`` for the
    triggered chips (``batch_or_samples``, ``steps``, ``lr``,
    ``seq_len``, ...).

    Hard-fault discrimination (``hard_threshold``): the scheduler also
    reads ``Fleet.hard_fault_proxy`` — the MAX single-column norm jump,
    a signature drift's distributed diffusion cannot produce — and
    routes chips crossing it down a separate path: recalibrate with
    ``hard_calib_args`` (default: ``calib_args`` with DOUBLE the steps —
    the stacked fleet shares one adapter shape, so the extra capacity
    comes from calibration effort, not a rank change) and flag the chip
    in ``FleetReport.hard_faulted_chips``. A hard-faulted chip is
    excluded from the drift path that tick. ``hard_threshold=None``
    disables the hard path entirely (legacy behaviour)."""

    def __init__(
        self, fleet: Fleet, *, threshold: float,
        calib_args: Optional[Dict[str, Any]] = None,
        hard_threshold: Optional[float] = None,
        hard_calib_args: Optional[Dict[str, Any]] = None,
        registry=None, warm_start: bool = True,
    ):
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if hard_threshold is not None and hard_threshold <= threshold:
            raise ValueError(
                f"hard_threshold ({hard_threshold}) must exceed the drift "
                f"threshold ({threshold}) — the hard signal is a max over "
                f"columns and dominates the mean the drift proxy reads"
            )
        self.fleet = fleet
        self.threshold = float(threshold)
        self.calib_args = dict(calib_args or {})
        self.hard_threshold = (
            None if hard_threshold is None else float(hard_threshold)
        )
        if hard_calib_args is None:
            hard_calib_args = dict(self.calib_args)
            hard_calib_args["steps"] = 2 * int(
                self.calib_args.get("steps", 20)
            )
        self.hard_calib_args = dict(hard_calib_args)
        # registry: both recalibration paths warm-start from (and record
        # back into) the versioned calibration registry when one is given
        self.registry = registry
        self.warm_start = bool(warm_start) and registry is not None
        self.history: List[TickRecord] = []
        self._last_loss = np.full(fleet.n_chips, np.nan, np.float64)
        self._per_chip_recals = [0] * fleet.n_chips
        self._per_chip_hard_recals = [0] * fleet.n_chips
        self._hard_flagged: set = set()
        self._warm_recals = 0
        self._chip_epochs = 0
        self._chip_epoch_budget = 0

    @property
    def ticks(self) -> int:
        return len(self.history)

    @property
    def recalibrations(self) -> int:
        """Total recalibrations, both paths."""
        return sum(self._per_chip_recals) + sum(self._per_chip_hard_recals)

    @property
    def naive_recalibrations(self) -> int:
        """What a fixed-interval policy would have spent by now: every
        chip recalibrated at every maintenance tick."""
        return self.ticks * self.fleet.n_chips

    def tick(
        self, hours: Union[float, Sequence[float]], chips=None,
    ) -> TickRecord:
        """One maintenance interval: age ``chips`` (default all) by
        ``hours`` (scalar or per-chip), read the proxies, and
        recalibrate exactly the chips whose proxy exceeds a threshold —
        hard-faulted chips down the hard path, merely drifted ones down
        the drift path, healthy ones not at all."""
        fleet = self.fleet
        fleet.advance(hours, chips=chips)
        chip_list = fleet._chip_list(chips)
        if isinstance(hours, (int, float)):
            hlist = [float(hours)] * len(chip_list)
        else:
            hlist = [float(h) for h in hours]
        per_chip_hours = [0.0] * fleet.n_chips
        for c, h in zip(chip_list, hlist):
            per_chip_hours[c] = h
        proxy = fleet.drift_proxy()
        hard_proxy = None
        hard_due: List[int] = []
        if self.hard_threshold is not None:
            hard_proxy = fleet.hard_fault_proxy()
            hard_due = [
                int(c) for c in np.flatnonzero(hard_proxy > self.hard_threshold)
            ]
        due = [
            int(c) for c in np.flatnonzero(proxy > self.threshold)
            if int(c) not in hard_due
        ]
        registry_args = (
            {"registry": self.registry, "warm_start": self.warm_start}
            if self.registry is not None else {}
        )
        report = None
        if due:
            report = fleet.calibrate(
                chips=due, **self.calib_args, **registry_args,
            )
            for j, c in enumerate(due):
                self._per_chip_recals[c] += 1
                self._last_loss[c] = float(report.final_loss[j])
            self._account_epochs(report, self.calib_args)
        hard_report = None
        if hard_due:
            hard_report = fleet.calibrate(
                chips=hard_due, **self.hard_calib_args, **registry_args,
            )
            for j, c in enumerate(hard_due):
                self._per_chip_hard_recals[c] += 1
                self._last_loss[c] = float(hard_report.final_loss[j])
                self._hard_flagged.add(c)
            self._account_epochs(hard_report, self.hard_calib_args)
        record = TickRecord(
            tick=len(self.history), hours=per_chip_hours,
            proxy=proxy, recalibrated=due, report=report,
            hard_proxy=hard_proxy, hard_faulted=hard_due,
            hard_report=hard_report,
        )
        self.history.append(record)
        return record

    def _account_epochs(self, report, args: Dict[str, Any]) -> None:
        """Steps-to-converge accounting for one batched calibrate call:
        actual chip-epochs spent vs the full configured step budget (the
        two differ when ``loss_threshold`` stops a warm-started loop
        early)."""
        n = len(report.chips)
        self._chip_epochs += report.epochs_run * n
        self._chip_epoch_budget += int(args.get("steps", 20)) * n
        self._warm_recals += len(report.warm_started_chips)

    def run(
        self, schedule: Sequence[Union[float, Sequence[float]]],
    ) -> FleetReport:
        """Drive a whole maintenance timeline (one ``tick`` per entry;
        entries are scalar hours or per-chip sequences) and emit the
        final ``FleetReport``."""
        for hours in schedule:
            self.tick(hours)
        return self.report()

    def report(self) -> FleetReport:
        fleet = self.fleet
        samples = self.calib_args.get("batch_or_samples", 10)
        if isinstance(samples, dict):
            samples = int(next(iter(samples.values())).shape[0])
        epochs = int(self.calib_args.get("steps", 20))
        proxy = (
            self.history[-1].proxy if self.history else fleet.drift_proxy()
        )
        if self.hard_threshold is None:
            hard_proxy = [float("nan")] * fleet.n_chips
        elif self.history and self.history[-1].hard_proxy is not None:
            hard_proxy = [float(p) for p in self.history[-1].hard_proxy]
        else:
            hard_proxy = [float(p) for p in fleet.hard_fault_proxy()]
        return FleetReport(
            n_chips=fleet.n_chips,
            ticks=self.ticks,
            threshold=self.threshold,
            recalibrations=self.recalibrations,
            naive_recalibrations=self.naive_recalibrations,
            recalibrations_avoided=(
                self.naive_recalibrations - self.recalibrations
            ),
            per_chip_recalibrations=list(self._per_chip_recals),
            per_chip_field_hours=[
                fleet.field_hours(c) for c in range(fleet.n_chips)
            ],
            per_chip_proxy=[float(p) for p in proxy],
            per_chip_loss=[float(x) for x in self._last_loss],
            sram_bytes=fleet.sram_bytes(),
            rram_bytes=fleet.rram_bytes(),
            calib_samples=int(samples),
            calib_epochs=epochs,
            sram_lifespan_calibrations=rram.lifespan_calibrations(
                samples=int(samples), epochs=epochs, on_rram=False
            ),
            rram_lifespan_calibrations=rram.lifespan_calibrations(
                samples=int(samples), epochs=epochs, on_rram=True
            ),
            hard_threshold=self.hard_threshold,
            drift_recalibrations=sum(self._per_chip_recals),
            hard_recalibrations=sum(self._per_chip_hard_recals),
            per_chip_hard_recalibrations=list(self._per_chip_hard_recals),
            hard_faulted_chips=sorted(self._hard_flagged),
            per_chip_hard_proxy=hard_proxy,
            warm_started_recalibrations=self._warm_recals,
            calibration_chip_epochs=self._chip_epochs,
            calibration_chip_epoch_budget=self._chip_epoch_budget,
            calibration_epochs_saved=(
                self._chip_epoch_budget - self._chip_epochs
            ),
        )
