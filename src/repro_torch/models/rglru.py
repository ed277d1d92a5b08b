"""RG-LRU recurrent block (recurrentgemma-9b, Griffin arXiv:2402.19427).
Port of ``repro/models/rglru.py``.

Per channel, with an elementwise state:

    r_t = sigmoid(W_a x_t)                      (recurrence gate)
    i_t = sigmoid(W_x x_t)                      (input gate)
    a_t = a ^ (c * r_t),  a = sigmoid(Lambda)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block: two input projections (the recurrent branch ``x`` and the
gate branch ``y``), the depthwise causal conv on ``x`` (``ssm.py``'s, no
SiLU), the RG-LRU, the gated merge and the output projection. The five
projections are RimcLinear leaves: the DoRA side-car applies to them, and
under ``codes``/``codes_adc`` they run through the crossbar kernels.
``in_x`` and ``in_y`` share their input but do not fuse, as in the
reference. ``conv_w``, ``conv_b`` and ``lambda_p`` are f32 digital
peripherals, frozen during calibration.

The recurrence is plain PyTorch: one log-depth (Hillis-Steele) scan of
the ``(a_t, b_t)`` pairs over the whole sequence. It regroups the products
otherwise than the reference's ``associative_scan``, so the two agree to
f32 rounding, not bitwise. Every f32 contraction is an elementwise product
and a sum, never a matmul. One (B, S, d_rnn) f32 tensor is small (34 MB
at 2100 x 4096), so the scan needs neither chunks nor a recompute under
autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dora
from repro_torch.core.dora import AdapterConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv, _scan_in_chunk, conv_tail

_C_FACTOR = 8.0
_LEAVES = ("in_x", "in_y", "gate_a", "gate_x", "out")


@dataclasses.dataclass(frozen=True)
class RglruConfig:
    d_model: int
    d_rnn: int  # lru width
    conv_kernel: int = 4


def _leaf_shapes(cfg: RglruConfig) -> Dict[str, Tuple[int, int]]:
    return {"in_x": (cfg.d_model, cfg.d_rnn), "in_y": (cfg.d_model, cfg.d_rnn),
            "gate_a": (cfg.d_rnn, cfg.d_rnn), "gate_x": (cfg.d_rnn, cfg.d_rnn),
            "out": (cfg.d_rnn, cfg.d_model)}


def init_lambda(d_rnn: int, device=None) -> torch.Tensor:
    """``Lambda`` with ``a^c`` spread over [0.9, 0.999] (``a = sigmoid(Lambda)``),
    in the reference's f32 steps."""
    u = torch.linspace(0.9, 0.999, d_rnn, dtype=torch.float32, device=device)
    a = u ** (1.0 / _C_FACTOR)
    return torch.log(a / (1.0 - a))


def init_rglru(generator: Optional[torch.Generator], cfg: RglruConfig, acfg: AdapterConfig,
               dtype=torch.bfloat16, *,
               draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[Dict, Dict]:
    """The five linear leaves and the f32 peripherals. ``draws`` gives the
    draws instead of ``generator``: per leaf the standard normals (d_in,
    d_out) under its name and A's U(0, 1) draws (d_in, r) under
    ``"<name>/lora_a"``; the conv taps' standard normals (K, d_rnn) under
    ``"conv_w"``."""
    device = generator.device if draws is None else next(iter(draws.values())).device
    base: Dict = {}
    adapters: Dict = {}
    for name, (d_in, d_out) in _leaf_shapes(cfg).items():
        if draws is None:
            base[name], adapters[name] = L.init_linear(generator, d_in, d_out, acfg,
                                                       dtype=dtype)
            continue
        w = (draws[name].to(torch.float32) * d_in ** -0.5).to(dtype)
        base[name] = {"w": w}
        adapters[name] = dora.init_adapter(None, d_in, d_out, acfg, w_base=w,
                                           uniforms=draws.get(f"{name}/lora_a"))
    k, d = cfg.conv_kernel, cfg.d_rnn
    taps = draws["conv_w"].to(torch.float32) if draws is not None else torch.randn(
        (k, d), generator=generator, device=device, dtype=torch.float32)
    base["conv_w"] = taps * (k ** -0.5)
    base["conv_b"] = torch.zeros((d,), dtype=torch.float32, device=device)
    base["lambda_p"] = init_lambda(d, device)
    return base, adapters


def _gates(x: torch.Tensor, base: Dict, a: Dict, acfg: AdapterConfig):
    """``(log_a, i)`` in f32 from the conv'd branch ``x``: the recurrence's
    log decay ``c * r * log(sigmoid(Lambda))`` and the input gate."""
    f32 = torch.float32
    r = torch.sigmoid(L.linear(x, base["gate_a"], a.get("gate_a"), acfg).to(f32))
    i = torch.sigmoid(L.linear(x, base["gate_x"], a.get("gate_x"), acfg).to(f32))
    log_a_base = torch.log(torch.sigmoid(base["lambda_p"].to(f32)))
    return _C_FACTOR * r * log_a_base, i


def _multiplier(log_a: torch.Tensor) -> torch.Tensor:
    """``sqrt(1 - a_t^2)`` in the reference's form (not ``-expm1``, which
    rounds otherwise)."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))


def rglru_scan(x: torch.Tensor, base: Dict, a: Dict, acfg: AdapterConfig,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over the conv'd branch ``x`` (B, S, d_rnn): ``(h (B, S,
    d_rnn) f32, h after the last position (B, d_rnn) f32)``, from ``h0``
    (zeros when None)."""
    log_a, i = _gates(x, base, a, acfg)
    b_t = _multiplier(log_a) * (i * x.to(torch.float32))
    h = scan_pairs(torch.exp(log_a), b_t, h0)
    return h, h[:, -1]


def scan_pairs(a_t: torch.Tensor, b_t: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1 by one log-depth scan of
    the pairs, from ``h0`` (B, d) or zeros."""
    a_cum, b_cum = _scan_in_chunk(a_t, b_t)
    return b_cum if h0 is None else a_cum * h0[:, None] + b_cum


def rglru_block(x: torch.Tensor, base: Dict, adapters: Optional[Dict], cfg: RglruConfig,
                acfg: AdapterConfig, *, return_state: bool = False):
    """The block over (B, S, d_model); with ``return_state`` also its
    decode cache after the last position: ``{"h": (B, d_rnn) f32, "conv":
    (B, K-1, d_rnn) f32}``."""
    a = adapters or {}
    xb_raw = L.linear(x, base["in_x"], a.get("in_x"), acfg)
    yb = F.gelu(L.linear(x, base["in_y"], a.get("in_y"), acfg), approximate="tanh")
    xb = _causal_conv(xb_raw, base["conv_w"], base["conv_b"])
    h, h_last = rglru_scan(xb, base, a, acfg)
    out = L.linear(h.to(x.dtype) * yb, base["out"], a.get("out"), acfg)
    if return_state:
        return out, {"h": h_last, "conv": conv_tail(xb_raw, cfg.conv_kernel)}
    return out


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_rglru_cache(batch: int, cfg: RglruConfig, device, dtype=torch.float32) -> Dict:
    return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_rnn), dtype=dtype,
                                device=device)}


def rglru_decode(x: torch.Tensor, cache: Dict, base: Dict, adapters: Optional[Dict],
                 cfg: RglruConfig, acfg: AdapterConfig) -> Tuple[torch.Tensor, Dict]:
    """One token per row, x (B, 1, d_model): the conv over the cached
    window and the input (rounded to ``x.dtype``), one recurrence step.
    ``cache``'s ``h`` and ``conv`` are advanced in place; returns ``(out,
    cache)``."""
    f32 = torch.float32
    a = adapters or {}
    xb = L.linear(x, base["in_x"], a.get("in_x"), acfg)  # (B, 1, d_rnn)
    yb = F.gelu(L.linear(x, base["in_y"], a.get("in_y"), acfg), approximate="tanh")
    window = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)], dim=1)  # (B, K, d)
    conv_out = torch.sum(window.to(f32) * base["conv_w"][None], dim=1) + base["conv_b"]
    xb1 = conv_out[:, None, :].to(x.dtype)
    log_a, i = _gates(xb1, base, a, acfg)
    log_a, i = log_a[:, 0], i[:, 0]
    h = torch.exp(log_a) * cache["h"] + _multiplier(log_a) * (i * xb1[:, 0].to(f32))
    out = L.linear(h[:, None, :].to(x.dtype) * yb, base["out"], a.get("out"), acfg)
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
