"""Execution wrappers around the crossbar kernels. Port of
``repro/substrate/exec.py``.

``rimc_linear`` takes a ``CrossbarWeight``, its DoRA adapter and the
merged gamma, and dispatches the GEMV launcher when all M rows fit one
block, the tiled launcher otherwise, with either body (``accum``).
``rimc_mvm_adc`` is the ADC-faithful MVM without an adapter. The CUDA
kernels mask ragged edges, so unlike the reference nothing is padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dora as dora_lib
from repro_torch.core.rram import CrossbarWeight, dequantize
from repro_torch.kernels import autotune
from repro_torch.kernels.crossbar_mvm import crossbar_mvm
from repro_torch.kernels.dora_linear import dora_linear, dora_linear_gemv


def code_column_norms(xw: CrossbarWeight) -> torch.Tensor:
    """Per-output-column L2 norms of the resident codes, ``(..., n)``."""
    w = dequantize(xw)
    return torch.sqrt(torch.sum(w * w, dim=-2))


def faulted_view(xw: CrossbarWeight, leaf_faults, cfg) -> CrossbarWeight:
    """The faulty read-back view of one leaf's codes (retention, I-V bend,
    caps, stuck pins; ``faults/map.py``), the scale untouched. The
    resident codes are never written: drift keeps acting on them, and
    every consumer reads this view. ``leaf_faults=None`` is healthy."""
    if leaf_faults is None:
        return xw
    return leaf_faults.apply(xw, cfg)


def faulted_codes(tree, fault_map, cfg):
    """``faulted_view`` over a whole codes tree through a composed
    ``FaultMap`` (``None``: the tree itself). ``Deployment._refresh_base``
    calls it after every programming, drift or injection event, and
    ``prepare_base_for_serve(faults=...)`` derives its view the same way."""
    if fault_map is None:
        return tree
    from repro_torch.faults.map import apply_fault_map

    return apply_fault_map(tree, fault_map, cfg)


def dora_gamma(xw: CrossbarWeight, adapter: dict) -> torch.Tensor:
    """Merged DoRA scale M/||W_r + A@B|| (Algorithm 2 line 12), (1, N)."""
    w = dequantize(xw)
    norm = dora_lib.column_norm(w, adapter["lora_a"], adapter["lora_b"])
    return (adapter["dora_m"].to(torch.float32) / norm)[None, :]


def launch(xf: torch.Tensor, gp, gn, scale, a, b, gamma, *, accum: str = "f32",
           plan_n=None) -> torch.Tensor:
    """The launcher for ``xf``'s row count: GEMV while M fits one block.
    ``plan_n``: the width the launch is planned for (a column block's
    whole leaf; N by default)."""
    fn = dora_linear_gemv if autotune.use_gemv(xf.shape[0]) else dora_linear
    return fn(xf, gp, gn, scale, a, b, gamma, accum=accum, plan_n=plan_n)


def rimc_linear(
    x: torch.Tensor,
    xw: CrossbarWeight,
    adapter: dict,
    gamma: Optional[torch.Tensor] = None,
    *,
    accum: str = "f32",
) -> torch.Tensor:
    """Fused Y = gamma * (X W_r + (XA)B); x (..., K), leading dims
    flattened to M. ``accum="int8"`` selects the integer body."""
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
        accum=accum,
    )
    return y.reshape(*lead, n).to(x.dtype)


def rimc_mvm_adc(x: torch.Tensor, xw: CrossbarWeight, *, code_max: int = 255,
                 adc_bits: int = 8) -> torch.Tensor:
    """ADC-faithful crossbar MVM (no adapter), rounded to x's dtype as
    the reference rounds it; x (..., K), leading dims flattened to M."""
    lead = x.shape[:-1]
    n = xw.g_pos.shape[-1]
    y = crossbar_mvm(
        x.reshape(-1, x.shape[-1]).contiguous(), xw.g_pos.contiguous(),
        xw.g_neg.contiguous(), xw.scale.reshape(1, -1).to(torch.float32).contiguous(),
        code_max=code_max, adc_bits=adc_bits,
    )
    return y.reshape(*lead, n).to(x.dtype)
