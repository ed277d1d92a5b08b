"""CUDA-graph capture of the port's compiled steps: the serving steps
(``deploy/serving.py::CompiledStep``) and the calibration step
(``core/calibrate.py::CompiledCalibStep``).

The kernels' launch counters count Python calls of their wrappers, so a
capture would count launches that never ran and a replay none of those
it runs. ``capture`` takes a capture's launches back off the counters
and returns them; the caller adds them per replay (``add_launch_counts``).
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Tuple

import torch


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter (``dora_linear`` and ``crossbar_mvm``),
    and their f32-x tallies."""
    from repro_torch.kernels import crossbar_mvm, dora_linear

    return {**dora_linear.launch_counts(), **crossbar_mvm.launch_counts(),
            **dora_linear.f32x_launch_counts(), **crossbar_mvm.f32x_launch_counts()}


def add_launch_counts(counts: Dict[str, int]) -> None:
    from repro_torch.kernels import crossbar_mvm, dora_linear

    for module in (dora_linear, crossbar_mvm):
        keys = {**module.launch_counts(), **module.f32x_launch_counts()}
        module.add_launch_counts({k: n for k, n in counts.items() if k in keys})


def capture(fn: Callable, stream: torch.cuda.Stream, pool=None
            ) -> Tuple[torch.cuda.CUDAGraph, object, Dict[str, int]]:
    """Capture ``fn()`` on ``stream`` into a CUDA graph of ``pool`` (a
    private pool of its own when None): ``(graph, fn's result, kernel
    launches per replay)``. The counters read afterwards as before, also
    when the capture raises; an error propagates. Python's cyclic garbage
    is collected first and the collector is off while capturing: a step
    of a session no longer referenced holds its CUDA graph in a cycle
    (the session's registry and the step's function), and destroying a
    graph while a stream captures invalidates the capture."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = fn()
    finally:
        if enabled:
            gc.enable()
        after = launch_counts()
        captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_launch_counts({k: -n for k, n in captured.items()})
    return graph, out, captured
