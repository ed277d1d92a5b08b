"""DoRA / LoRA adapters for RIMC calibration (paper §III-C, Algorithm 2).
Port of ``repro/core/dora.py`` (the linear half; the conv variants wait).

  LoRA:  Y = X @ W_r + (X @ A) @ B                            (eq. 5)
  DoRA:  Y = M ∘ normalize(X @ W_r + (X @ A) @ B)             (training)
         Y = M' ∘ (X @ W_r + (X @ A) @ B),  M' = M / ||W_r + A@B||_col

A is kaiming-uniform, B starts at zero and M at the column norm of the
drifted base, so a fresh adapter is output-preserving.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    rank: int = 4
    kind: str = "dora"          # 'dora' | 'lora' | 'none'
    dtype: torch.dtype = torch.float32


def param_ratio(d: int, k: int, r: int) -> float:
    """Eq. 7: proportion of new parameters introduced by DoRA."""
    return (d * r + r * k + k) / (d * k)


def init_adapter(
    generator: torch.Generator,
    d: int,
    k: int,
    cfg: AdapterConfig,
    w_base: Optional[torch.Tensor] = None,
) -> dict:
    """(A, B, M) per Algorithm 2 line 2, on ``generator``'s device."""
    if cfg.kind == "none":
        return {}
    device = generator.device
    r = cfg.rank
    bound = 1.0 / math.sqrt(d)
    u = torch.rand((d, r), generator=generator, device=device, dtype=torch.float32)
    a = (u * (2 * bound) - bound).to(cfg.dtype)
    b = torch.zeros((r, k), dtype=cfg.dtype, device=device)
    out = {"lora_a": a, "lora_b": b}
    if cfg.kind == "dora":
        if w_base is not None:
            m = torch.linalg.vector_norm(w_base.to(torch.float32), dim=0)
        else:
            m = torch.ones((k,), dtype=torch.float32, device=device)
        out["dora_m"] = m.to(cfg.dtype)
    return out


def column_norm(
    w_base: torch.Tensor, a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """||W_r + A@B||_2 per column without forming W + A@B:
    norm² = colnorm²(W) + 2·col(Wᵀ(A@B)) + colnorm²(A@B)."""
    wf = w_base.to(torch.float32)
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    w_sq = torch.sum(wf * wf, dim=0)
    wta = wf.T @ af                                   # (k, r)
    cross = torch.einsum("kr,rk->k", wta, bf)
    ab_sq = torch.sum((af @ bf) ** 2, dim=0)
    return torch.sqrt(torch.clamp_min(w_sq + 2.0 * cross + ab_sq, eps))


def adapted_forward(
    x: torch.Tensor,
    w_base: torch.Tensor,
    adapter: dict,
    cfg: AdapterConfig,
    *,
    merged_norm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Base + adapter forward (Algorithm 2 lines 5-7) in ``x``'s dtype.
    A merged adapter (``dora_m_merged``) applies its static per-column
    scale; otherwise the norm is ``merged_norm`` or recomputed."""
    dt = x.dtype
    y = x @ w_base.to(dt)
    if cfg.kind == "none" or not adapter:
        return y
    y = y + (x @ adapter["lora_a"].to(dt)) @ adapter["lora_b"].to(dt)
    if cfg.kind == "lora":
        return y
    if "dora_m_merged" in adapter:
        return y * adapter["dora_m_merged"].to(dt)
    m = adapter["dora_m"].to(torch.float32)
    norm = (
        column_norm(w_base, adapter["lora_a"], adapter["lora_b"])
        if merged_norm is None else merged_norm
    )
    return y * (m / norm).to(dt)


def merge_magnitude(
    w_base: torch.Tensor, adapter: dict, cfg: AdapterConfig
) -> Optional[torch.Tensor]:
    """Algorithm 2 line 12: ||W_r + A@B|| for inference, or None for
    non-DoRA adapters."""
    if cfg.kind != "dora" or not adapter:
        return None
    return column_norm(w_base, adapter["lora_a"], adapter["lora_b"])
