"""Plain PyTorch versions of the port's kernels (the correctness
contract). Port of ``repro/kernels/ref.py``: the CPU path of every
kernel wrapper, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card."""
from __future__ import annotations

import torch


def dora_linear_ref(x, g_pos, g_neg, scale, a, b, gamma, out_dtype=torch.float32):
    """Y = (X @ ((G+ - G-) * scale) + (X @ A) @ B) * gamma, all in f32."""
    xf = x.to(torch.float32)
    w = (g_pos.to(torch.float32) - g_neg.to(torch.float32)) * scale
    y = xf @ w
    y = y + (xf @ a.to(torch.float32)) @ b.to(torch.float32)
    return (y * gamma).to(out_dtype)
