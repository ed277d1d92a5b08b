"""``Deployment`` — the lifecycle object from programming to serving.
Port of ``repro/deploy/deployment.py`` (healthy path: no fault map;
calibration, snapshot and restore wait).

* ``Deployment.program(cfg, seed, backend=..., device=...)`` — init the
  teacher from the seed and program every RRAM leaf (programming-time
  drift included).
* ``Deployment.from_arrays(...)`` — adopt a teacher, codes and adapters
  made elsewhere (the reference package, through ``interop``); drift
  continues from those codes.
* ``dep.advance(hours)`` — the drift clock; event ``i`` of leaf ``path``
  draws from its own generator, so any history replays from the seed.
* ``dep.serve()`` — merged DoRA magnitudes and, under ``codes``, the
  prepared (fused) serving tree.

The port runs on the card: ``device`` defaults to ``"cuda"`` and raises
when no card is present; the CPU runs only when asked for.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch import substrate
from repro_torch.core import rram
from repro_torch.core.calibrate import (
    calibrated_fraction,
    drift_model,
    merge_adapters_for_serve,
    program_model,
    rram_bytes,
    sram_bytes,
)
from repro_torch.deploy import serving
from repro_torch.interop import from_reference
from repro_torch.models import transformer as T

Pytree = Any


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no card
    present raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return device


def _dequant_like(codes: Pytree, like: Pytree) -> Pytree:
    """Codes read back to floats, leaf dtypes taken from ``like``; other
    leaves pass through as the same tensors."""

    def walk(c, w):
        if isinstance(c, rram.CrossbarWeight):
            return rram.dequantize(c, dtype=w.dtype)
        if isinstance(c, dict):
            return {k: walk(v, w[k]) for k, v in c.items()}
        if isinstance(c, list):
            return [walk(v, w[i]) for i, v in enumerate(c)]
        return c

    return walk(codes, like)


class Deployment:
    """One RRAM deployment over its lifetime. ``self.codes`` (uint8) is
    the ground truth; ``self.base`` is what forwards consume — the codes
    under ``codes``, their float read-back under ``dequant``."""

    def __init__(self, cfg, backend: str, teacher_base: Pytree, codes: Pytree,
                 adapters: Pytree, teacher_seed: int, program_seed: int,
                 drift_hours: Sequence[float] = ()):
        if backend not in serving.BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; available: {serving.BACKENDS}")
        self.cfg = cfg
        self.backend = backend
        self.teacher_base = teacher_base
        self.codes = codes
        self.adapters = adapters
        self.teacher_seed = int(teacher_seed)
        self.program_seed = int(program_seed)
        self.drift_hours: List[float] = [float(h) for h in drift_hours]
        self._refresh_base()

    @property
    def device(self) -> torch.device:
        return self.teacher_base["embed"]["embedding"].device

    @classmethod
    def program(cls, cfg, seed: int = 0, *, backend: str = "dequant",
                adapters: Optional[Pytree] = None,
                device="cuda") -> "Deployment":
        """The programming event: the teacher from generator ``seed``,
        the codes from ``seed + 1`` (per-leaf streams)."""
        device = resolve_device(device)
        params = T.init_params(rram.make_generator(device, seed), cfg)
        codes = program_model(params["base"], cfg.rram, seed + 1, mode="codes")
        return cls(cfg, backend, params["base"], codes,
                   params["adapters"] if adapters is None else adapters,
                   teacher_seed=seed, program_seed=seed + 1)

    @classmethod
    def from_arrays(cls, cfg, teacher_base, codes, adapters, *,
                    backend: str = "codes", seed: int = 0,
                    drift_hours: Sequence[float] = (),
                    device="cuda") -> "Deployment":
        """A deployment over trees made elsewhere, given as numpy trees in
        the reference layout (``interop.from_reference``). ``drift_hours``
        is the drift history those codes already carry, so the field
        clock continues from it; later drift events draw from the port's
        streams for ``seed``."""
        device = resolve_device(device)
        return cls(cfg, backend, from_reference(teacher_base, device),
                   from_reference(codes, device), from_reference(adapters, device),
                   teacher_seed=seed, program_seed=seed + 1,
                   drift_hours=drift_hours)

    def _refresh_base(self):
        if self.backend == "dequant":
            self.base = _dequant_like(self.codes, self.teacher_base)
        else:
            self.base = self.codes

    @property
    def field_hours(self) -> float:
        return float(sum(self.drift_hours))

    def advance(self, hours: float) -> "Deployment":
        """Let ``hours`` of field time pass: the codes re-drift by the
        variance increment over the cumulative clock, never rewritten.
        ``hours=0`` is a no-op; negative hours raise."""
        hours = float(hours)
        if hours < 0:
            raise ValueError(f"drift clock cannot run backwards (hours={hours})")
        if hours == 0.0:
            return self
        self.codes = drift_model(
            self.codes, self.cfg.rram, self.program_seed, hours=hours,
            event_index=len(self.drift_hours), clock_offset=self.field_hours,
        )
        self.drift_hours.append(hours)
        self._refresh_base()
        return self

    def serve(self) -> serving.ServeSession:
        """Merge the DoRA magnitudes (Algorithm 2 line 12) and bind a
        session; under ``codes`` the params are the prepared tree (q/k/v
        and gate/up fused into single launches)."""
        with torch.no_grad():
            merged = merge_adapters_for_serve(self.base, self.adapters)
            base = self.base
            if self.backend == "codes":
                base = substrate.prepare_base_for_serve(self.base, merged, self.cfg)
        return serving.ServeSession(self, {"base": base, "adapters": merged})

    def rram_bytes(self) -> int:
        return rram_bytes(self.base)

    def sram_bytes(self) -> int:
        return sram_bytes(self.adapters)

    def calibrated_fraction(self) -> float:
        return calibrated_fraction(self.base, self.adapters)
