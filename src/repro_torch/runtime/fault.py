"""Fault tolerance and scale runtime: preemption handling, straggler
detection, elastic re-meshing. Port of ``repro/runtime/fault.py``: plain
Python and numpy, value for value the reference's.

* ``PreemptionGuard`` — converts SIGTERM/SIGINT into a "checkpoint now,
  then exit cleanly" flag checked each step.
* ``StragglerDetector`` — per-step wall-time ring buffer with a robust
  z-score; a slow host shows up as a persistent step-time outlier long
  before it fails. The policy acts on ``persistent()``.
* ``ElasticPlan`` — given a failed-host count, the degraded mesh's shape
  (``launch/mesh.py::make_elastic_mesh`` builds the mesh itself) and the
  step to resume from; ``ServeEngine.remesh`` returns one.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import threading
import time
from typing import Callable, Deque, List, Optional

import numpy as np


class PreemptionGuard:
    """Flag-based graceful shutdown. Use as context manager around the
    training loop; ``should_stop`` flips on SIGTERM/SIGINT."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._stop = threading.Event()
        self._prev = {}

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # non-main thread (tests)
                pass
        return self

    def _handler(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self):
        self._stop.set()

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    median: float
    mad: float
    z: float

    @property
    def is_straggler(self) -> bool:
        return self.z > 4.0


class StragglerDetector:
    """Robust (median/MAD) outlier detection over recent step times.

    A single flagged step is noise (GC pause, one slow collective); the
    re-mesh policy acts on ``persistent()`` — at least ``k`` of the most
    recent ``horizon`` steps flagged — which a one-off spike can never
    satisfy but a thermally-throttled host does within ``k`` steps."""

    def __init__(self, window: int = 64, min_samples: int = 16):
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.min_samples = min_samples
        self.reports: List[StragglerReport] = []
        self._flags: Deque[bool] = collections.deque(maxlen=window)

    def record(self, step: int, step_time: float) -> Optional[StragglerReport]:
        self.times.append(step_time)
        if len(self.times) < self.min_samples:
            self._flags.append(False)
            return None
        arr = np.asarray(self.times)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med))) + 1e-9
        z = 0.6745 * (step_time - med) / mad
        report = StragglerReport(step, step_time, med, mad, float(z))
        self._flags.append(report.is_straggler)
        if report.is_straggler:
            self.reports.append(report)
        return report

    def persistent(self, k: int = 3, horizon: int = 8) -> bool:
        """True when >= ``k`` of the last ``horizon`` recorded steps were
        flagged — the signal that justifies excluding the host."""
        recent = list(self._flags)[-horizon:]
        return sum(recent) >= k


@dataclasses.dataclass
class ElasticPlan:
    """Recipe for recovering onto a degraded mesh."""

    failed_hosts: int
    new_mesh_shape: tuple
    restore_step: int
    notes: str = ""

    @staticmethod
    def plan(
        failed_hosts: int, latest_step: Optional[int], *,
        rows: int = 16, cols: int = 16,
    ):
        """``rows``/``cols`` are the current ("data", "model") extents —
        the production 16x16 by default; serve engines pass their actual
        mesh shape. Only the data axis shrinks."""
        new_rows = rows - failed_hosts
        if new_rows < 1:
            raise RuntimeError("insufficient healthy capacity for re-mesh")
        return ElasticPlan(
            failed_hosts=failed_hosts,
            new_mesh_shape=(new_rows, cols),
            restore_step=latest_step or 0,
            notes=(
                "model axis preserved (param shardings stable); data axis "
                f"shrunk {rows}->{new_rows}; global batch kept — per-device "
                "batch grows, data pipeline replays deterministically"
            ),
        )


class StepTimer:
    """Context timer used by the train loop for the straggler detector."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
