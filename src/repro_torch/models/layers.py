"""Shared layer primitives. Port of ``repro/models/layers.py``.

Every matmul goes through ``linear`` — the paper's unit of calibration: a
frozen (possibly drifted) base weight "in RRAM" plus an optional DoRA
side-car "in SRAM". ``init_*`` functions return mirrored ``(base,
adapters)`` trees and draw from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dora
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import CrossbarWeight
from repro_torch.substrate.prepared import PreparedCrossbar


def init_linear(
    generator: torch.Generator, d_in: int, d_out: int, acfg: AdapterConfig,
    *, dtype=torch.bfloat16, scale: Optional[float] = None,
) -> Tuple[Dict, Dict]:
    if scale is None:
        scale = d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, device=generator.device,
                    dtype=torch.float32)
    w = (w * scale).to(dtype)
    adapter = dora.init_adapter(generator, d_in, d_out, acfg, w_base=w)
    return {"w": w}, adapter


def linear(
    x: torch.Tensor, base: Dict, adapter: Optional[Dict], acfg: AdapterConfig,
    *, backend: Optional[str] = None,
) -> torch.Tensor:
    """Apply a RimcLinear: resident codes (``CrossbarWeight``) and
    prepared leaves go to the substrate backends; float leaves take the
    plain path. ``adapter=None``/``{}`` is the plain base matmul."""
    w = base["w"]
    if isinstance(w, (CrossbarWeight, PreparedCrossbar)):
        from repro_torch.substrate import crossbar_linear

        return crossbar_linear(x, w, adapter, acfg, backend=backend)
    if adapter:
        return dora.adapted_forward(x, w, adapter, acfg)
    return x @ w.to(x.dtype)


def init_rmsnorm(d: int, device, dtype=torch.float32) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, device, dtype=torch.float32) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16) -> Dict:
    w = torch.randn((vocab, d), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return {"embedding": w.to(dtype)}


def embed(tokens: torch.Tensor, p: Dict, *, scale_by_sqrt_dim: bool = False):
    """Token embedding lookup. The reference's decode path computes it as
    a one-hot matmul (for vocab-sharded tables); every output there is
    one exact product, so a gather gives the same values."""
    w = p["embedding"]
    y = w[tokens]
    if scale_by_sqrt_dim:
        y = y * (w.shape[-1] ** 0.5)
    return y


@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies (head_dim / 2,) f32; cached per device, since
    every attention call of every layer needs the same table."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    angles = angles[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    gated: bool = True
    activation: str = "silu"   # 'silu' | 'gelu' | 'gelu_tanh' | 'relu'


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


def init_mlp(generator: torch.Generator, cfg: MlpConfig, acfg: AdapterConfig,
             dtype=torch.bfloat16) -> Tuple[Dict, Dict]:
    base: Dict = {}
    adapters: Dict = {}
    if cfg.gated:
        base["gate"], adapters["gate"] = init_linear(
            generator, cfg.d_model, cfg.d_ff, acfg, dtype=dtype)
    base["up"], adapters["up"] = init_linear(
        generator, cfg.d_model, cfg.d_ff, acfg, dtype=dtype)
    base["down"], adapters["down"] = init_linear(
        generator, cfg.d_ff, cfg.d_model, acfg, dtype=dtype)
    return base, adapters


def mlp(x: torch.Tensor, base: Dict, adapters: Optional[Dict], cfg: MlpConfig,
        acfg: AdapterConfig) -> torch.Tensor:
    a = adapters or {}
    if "_gate_up" in base:
        # serve-time fused leaf: one launch over concatenated N
        gu = linear(x, base["_gate_up"], None, acfg)
        h = _act(gu[..., : cfg.d_ff], cfg.activation) * gu[..., cfg.d_ff:]
    elif cfg.gated:
        up = linear(x, base["up"], a.get("up"), acfg)
        gate = linear(x, base["gate"], a.get("gate"), acfg)
        h = _act(gate, cfg.activation) * up
    else:
        h = _act(linear(x, base["up"], a.get("up"), acfg), cfg.activation)
    return linear(h, base["down"], a.get("down"), acfg)
