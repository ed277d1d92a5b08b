"""RRAM crossbar compact model: conductance mapping, programming, drift,
the reference crossbar MVM with its ADC, and the lifespan and speed
model of Table I. Port of ``repro/core/rram.py`` (paper Section II).

Weights are scaled per column onto the conductance range and programmed
as a differential pair ``(G+, G-)`` of uint8 codes (eq. 2); conductance
relaxation is Gaussian and proportional to the programmed conductance
(eq. 1).

Every function that draws noise takes the draws as ``noise=`` (so a test
can pass in the reference's normals and compare bitwise) or else a
``torch.Generator``. ``make_generator`` seeds one from ``(seed, crc32 of
the leaf path, event index)``: the port's streams replay exactly from a
seed, but they are not JAX's threefry bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import _div


@dataclasses.dataclass(frozen=True)
class RramConfig:
    """Device/array parameters for the simulated RRAM crossbar."""

    levels: int = 256              # conductance codes are [0, levels-1]
    relative_drift: float = 0.0    # drift sigma / G_max (paper: <= 20%)
    drift_mu: float = 0.0
    programming_sigma: float = 0.0  # write-and-verify residual / G_max
    adc_bits: int = 8
    array_rows: int = 256
    simulate_adc: bool = False

    @property
    def code_max(self) -> int:
        return self.levels - 1


DEFAULT_RRAM = RramConfig()


@dataclasses.dataclass
class CrossbarWeight:
    """A weight programmed onto RRAM: ``W = (g_pos - g_neg) * scale``.
    ``g_pos``/``g_neg`` are uint8 codes of the weight's shape; ``scale``
    is f32 ``(..., 1, k)``, one per output column."""

    g_pos: torch.Tensor
    g_neg: torch.Tensor
    scale: torch.Tensor


def make_generator(device, *parts: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from integer ``parts``
    (deployment seed, crc32 of a leaf path, event index): independent
    streams per leaf and per event, all replayable from the seed."""
    entropy = [int(p) & 0xFFFFFFFFFFFFFFFF for p in parts]
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed >> 1)
    return g


def _normals(generator: torch.Generator, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    kw = dict(generator=generator, device=generator.device, dtype=torch.float32)
    return torch.randn(shape, **kw), torch.randn(shape, **kw)


def program(
    w: torch.Tensor,
    cfg: RramConfig = DEFAULT_RRAM,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> CrossbarWeight:
    """Program float weights: per-column absmax scale, clip, round half
    to even, uint8. With ``cfg.programming_sigma > 0`` and draws
    (``noise`` or ``generator``), write-and-verify noise is added to the
    codes before rounding."""
    w = w.to(torch.float32)
    absmax = torch.clamp_min(w.abs().amax(dim=-2, keepdim=True), 1e-8)
    scale = absmax / cfg.code_max
    codes = w / scale
    g_pos = torch.clamp(codes, 0, cfg.code_max)
    g_neg = torch.clamp(-codes, 0, cfg.code_max)
    if cfg.programming_sigma > 0.0 and (noise is not None or generator is not None):
        n_pos, n_neg = noise if noise is not None else _normals(generator, g_pos.shape)
        sp = cfg.programming_sigma * cfg.code_max
        g_pos = g_pos + sp * n_pos
        g_neg = g_neg + sp * n_neg
    g_pos = torch.clamp(torch.round(g_pos), 0, cfg.code_max).to(torch.uint8)
    g_neg = torch.clamp(torch.round(g_neg), 0, cfg.code_max).to(torch.uint8)
    return CrossbarWeight(g_pos=g_pos, g_neg=g_neg, scale=scale)


# sigma(t) = relative_drift * log1p(t / tau): log-time relaxation
DRIFT_TAU_HOURS = 24.0


def drift_sigma(cfg: RramConfig, hours: float) -> float:
    """Total relative drift sigma after ``hours`` of field time."""
    if hours < 0:
        raise ValueError(f"drift clock cannot run backwards (hours={hours})")
    return float(cfg.relative_drift * np.log1p(hours / DRIFT_TAU_HOURS))


def drift_sigma_increment(cfg: RramConfig, t0: float, hours: float) -> float:
    """Sigma for one tick over ``[t0, t0 + hours]``: independent Gaussian
    increments add in variance, so slicing the clock differently
    accumulates the same total drift."""
    s1 = drift_sigma(cfg, t0 + hours)
    s0 = drift_sigma(cfg, t0)
    return float(np.sqrt(max(s1 * s1 - s0 * s0, 0.0)))


def apply_drift(
    xw: CrossbarWeight,
    cfg: RramConfig,
    generator: Optional[torch.Generator] = None,
    *,
    hours: Optional[float] = None,
    clock_offset: float = 0.0,
    sigma: Optional[float] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> CrossbarWeight:
    """Gaussian conductance relaxation on programmed codes:
    ``G_r = G_t * (1 + N(mu, sigma^2))`` per device, clipped to the code
    range and rounded back to the code grid. ``hours`` selects the
    log-time sigma increment over ``[clock_offset, clock_offset +
    hours]``; ``sigma`` overrides it; neither means ``relative_drift``.
    The draws come from ``noise`` or else ``generator``."""
    if sigma is None:
        sigma = (
            cfg.relative_drift if hours is None
            else drift_sigma_increment(cfg, clock_offset, hours)
        )
    if sigma <= 0.0:
        return xw
    if noise is None:
        if generator is None:
            raise ValueError("apply_drift needs noise= or a generator")
        noise = _normals(generator, xw.g_pos.shape)
    n_pos, n_neg = noise
    gp = xw.g_pos.to(torch.float32)
    gn = xw.g_neg.to(torch.float32)
    drift_p = gp * (cfg.drift_mu + sigma * n_pos)
    drift_n = gn * (cfg.drift_mu + sigma * n_neg)
    g_pos = torch.clamp(gp + drift_p, 0, cfg.code_max)
    g_neg = torch.clamp(gn + drift_n, 0, cfg.code_max)
    return CrossbarWeight(
        g_pos=torch.round(g_pos).to(torch.uint8),
        g_neg=torch.round(g_neg).to(torch.uint8),
        scale=xw.scale,
    )


def dequantize(xw: CrossbarWeight, dtype=torch.float32) -> torch.Tensor:
    """The effective weight read back out of the codes: ``(G+ - G-) *
    scale`` in f32, rounded once to ``dtype``. The difference is exact in
    int16 and the product is computed in f32 and written in ``dtype`` by
    one op, so an expert stack's read-back makes no f32 copy of it."""
    diff = xw.g_pos.to(torch.int16) - xw.g_neg
    out = torch.empty(diff.shape, dtype=dtype, device=diff.device)
    return torch.mul(diff, xw.scale, out=out)


def programmed_codes(
    w: torch.Tensor,
    cfg: RramConfig,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> CrossbarWeight:
    """W -> program -> drift (programming-time drift at
    ``relative_drift``), keeping the uint8 codes resident."""
    return apply_drift(program(w, cfg), cfg, generator, noise=noise)


def drifted_weights(
    w: torch.Tensor,
    cfg: RramConfig,
    generator: Optional[torch.Generator] = None,
    dtype=torch.bfloat16,
    *,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """W -> program -> drift -> dequantize; the drifted float weights."""
    return dequantize(programmed_codes(w, cfg, generator, noise=noise), dtype=dtype)


def mvm_reference(x: torch.Tensor, xw: CrossbarWeight, cfg: RramConfig) -> torch.Tensor:
    """Simulated analog MVM: the array activates ``cfg.array_rows`` rows at
    a time, each block's differential column current is digitized by a
    saturating ``adc_bits`` ADC, and the blocks add digitally. Without ADC
    simulation this is ``x @ dequantize(xw)``. The DAC range is max|x|
    over every row of a block (the kernels take it per 128-row tile, so
    the two agree only up to 128 rows)."""
    if not cfg.simulate_adc:
        return x @ dequantize(xw)
    d = x.shape[-1]
    rows = cfg.array_rows
    n_blocks = (d + rows - 1) // rows
    pad = n_blocks * rows - d
    xp = F.pad(x, (0, pad))
    gp = F.pad(xw.g_pos.to(torch.float32), (0, 0, 0, pad))
    gn = F.pad(xw.g_neg.to(torch.float32), (0, 0, 0, pad))
    adc_max = 2.0 ** (cfg.adc_bits - 1) - 1.0
    out = x.new_zeros(x.shape[:-1] + (xw.g_pos.shape[-1],), dtype=torch.float32)
    for b in range(n_blocks):
        xs = xp[..., b * rows:(b + 1) * rows]
        cur = xs @ (gp[b * rows:(b + 1) * rows] - gn[b * rows:(b + 1) * rows])
        x_absmax = torch.clamp_min(xs.abs().amax(), 1e-8)
        step = _div(rows * cfg.code_max * x_absmax, adc_max * 16.0)
        cur = torch.clamp(torch.round(cur / step), -adc_max, adc_max) * step
        out = out + cur
    return out * xw.scale.reshape((1,) * (out.ndim - 1) + (-1,))


# Table I: lifespan and speed of calibration, backprop on RRAM against
# DoRA side-cars in SRAM
RRAM_ENDURANCE = 1e8    # write cycles
SRAM_ENDURANCE = 1e16
RRAM_WRITE_NS = 100.0   # write-and-verify per cell
SRAM_WRITE_NS = 1.0


def lifespan_calibrations(*, samples: int, epochs: int = 20, batch: int = 1,
                          on_rram: bool) -> float:
    """Calibrations before the storage wears out: ``epochs * samples /
    batch`` updates each, against the RRAM's or the SRAM's endurance."""
    updates = epochs * (samples / batch)
    endurance = RRAM_ENDURANCE if on_rram else SRAM_ENDURANCE
    return endurance / updates


def calibration_speedup(*, base_samples: int = 125, dora_samples: int = 10,
                        rram_write_ns: float = RRAM_WRITE_NS,
                        sram_write_ns: float = SRAM_WRITE_NS) -> float:
    """Weight-update-bound speedup of DoRA on SRAM over backprop on RRAM
    (paper §IV-E): the sample ratio times the write-time ratio, 1250x."""
    return (base_samples / dora_samples) * (rram_write_ns / sram_write_ns)
