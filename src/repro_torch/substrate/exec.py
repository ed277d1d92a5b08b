"""Execution wrappers around the fused crossbar kernel. Port of
``repro/substrate/exec.py`` (the ADC path waits with its kernel).

``rimc_linear`` takes a ``CrossbarWeight``, its DoRA adapter and the
merged gamma, and dispatches the GEMV launcher when all M rows fit one
block, the tiled launcher otherwise. The CUDA kernels mask ragged
edges, so unlike the reference nothing is padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dora as dora_lib
from repro_torch.core.rram import CrossbarWeight, dequantize
from repro_torch.kernels import autotune
from repro_torch.kernels.dora_linear import dora_linear, dora_linear_gemv


def code_column_norms(xw: CrossbarWeight) -> torch.Tensor:
    """Per-output-column L2 norms of the resident codes, ``(..., n)``."""
    w = dequantize(xw)
    return torch.sqrt(torch.sum(w * w, dim=-2))


def dora_gamma(xw: CrossbarWeight, adapter: dict) -> torch.Tensor:
    """Merged DoRA scale M/||W_r + A@B|| (Algorithm 2 line 12), (1, N)."""
    w = dequantize(xw)
    norm = dora_lib.column_norm(w, adapter["lora_a"], adapter["lora_b"])
    return (adapter["dora_m"].to(torch.float32) / norm)[None, :]


def launch(xf: torch.Tensor, gp, gn, scale, a, b, gamma) -> torch.Tensor:
    """The launcher for ``xf``'s row count: GEMV while M fits one block."""
    fn = dora_linear_gemv if autotune.use_gemv(xf.shape[0]) else dora_linear
    return fn(xf, gp, gn, scale, a, b, gamma)


def rimc_linear(
    x: torch.Tensor,
    xw: CrossbarWeight,
    adapter: dict,
    gamma: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused Y = gamma * (X W_r + (XA)B); x (..., K), leading dims
    flattened to M."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = xw.g_pos.shape[-1]
    if gamma is None:
        gamma = dora_gamma(xw, adapter)
    xf = x.reshape(-1, k).contiguous()
    y = launch(
        xf, xw.g_pos.contiguous(), xw.g_neg.contiguous(),
        xw.scale.reshape(1, -1).to(torch.float32).contiguous(),
        adapter["lora_a"].to(torch.float32).contiguous(),
        adapter["lora_b"].to(torch.float32).contiguous(),
        gamma.reshape(1, -1).to(torch.float32).contiguous(),
    )
    return y.reshape(*lead, n).to(x.dtype)
