"""Programming, drift and serve-time merging over whole model trees.
Port of the serving half of ``repro/core/calibrate.py``; feature-KD
calibration with autograd is the next slice.

Per-leaf streams: leaf ``path`` of a deployment with seed ``s`` draws its
programming noise from ``make_generator(s, crc32(path), 0)`` and drift
event ``i`` from ``make_generator(s, crc32(path), i + 1)`` — independent
per leaf and per event, replayable from the seed alone.
"""
from __future__ import annotations

import zlib
from typing import Any, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import dora as dora_lib
from repro_torch.core import rram
from repro_torch.core.rram import RramConfig

Pytree = Any

# Leaf names that live in RRAM (weights that participate in MVMs).
RRAM_LEAF_NAMES = ("w", "gate_w", "up_w", "down_w")


def _is_rram_leaf(path) -> bool:
    return bool(path) and path[-1] in RRAM_LEAF_NAMES


def _crc(path) -> int:
    return zlib.crc32(tree_lib.path_str(path).encode())


def program_model(base: Pytree, cfg: RramConfig, seed: int, *,
                  mode: str = "codes") -> Pytree:
    """Program + drift every RRAM-resident leaf; returns the student base.
    ``mode="codes"`` keeps uint8 ``CrossbarWeight`` leaves (stacked
    scan-group leaves included); ``"dequant"`` reads them back to the
    leaf's float dtype."""
    if mode not in ("dequant", "codes"):
        raise ValueError(f"mode must be 'dequant' or 'codes', got {mode!r}")

    def leaf(path, x):
        if not _is_rram_leaf(path):
            return x
        g = rram.make_generator(x.device, seed, _crc(path), 0)
        return program_leaf(x, cfg, g, mode=mode)

    return tree_lib.map_with_path(leaf, base)


def program_leaf(w: torch.Tensor, cfg: RramConfig, generator: torch.Generator,
                 *, mode: str = "codes"):
    """Program ONE RRAM leaf. Stacked leaves (G, d, k) program per matrix
    (the absmax is per column of each matrix) with one draw for the
    stack."""
    xw = rram.programmed_codes(w, cfg, generator)
    if mode == "codes":
        return xw
    return rram.dequantize(xw, dtype=w.dtype)


def drift_model(base: Pytree, cfg: RramConfig, seed: int, *,
                hours: Optional[float] = None, event_index: int,
                clock_offset: float = 0.0, sigma: Optional[float] = None) -> Pytree:
    """One drift-clock tick over a codes-resident tree: every
    ``CrossbarWeight`` re-drifts by the variance increment over
    ``[clock_offset, clock_offset + hours]`` without reprogramming."""
    if (hours is None) == (sigma is None):
        raise ValueError("drift_model needs exactly one of hours= or sigma=")
    n_drifted = 0

    def leaf(path, x):
        nonlocal n_drifted
        if not isinstance(x, rram.CrossbarWeight):
            return x
        n_drifted += 1
        g = rram.make_generator(x.g_pos.device, seed, _crc(path), event_index + 1)
        return rram.apply_drift(x, cfg, g, hours=hours,
                                clock_offset=clock_offset, sigma=sigma)

    out = tree_lib.map_with_path(
        leaf, base, is_leaf=lambda n: isinstance(n, rram.CrossbarWeight))
    if n_drifted == 0:
        raise ValueError(
            "drift_model needs a codes-resident tree (CrossbarWeight leaves); "
            "got a float tree — program with mode='codes' first"
        )
    return out


def rram_bytes(base: Pytree) -> int:
    """Bytes resident in RRAM: the uint8 code arrays of a codes tree (a
    measurement), or 2 bytes per weight of a float tree (an estimate)."""
    total = 0

    def leaf(path, x):
        nonlocal total
        if isinstance(x, rram.CrossbarWeight):
            total += x.g_pos.numel() + x.g_neg.numel()
        elif _is_rram_leaf(path):
            total += 2 * x.numel()
        return x

    tree_lib.map_with_path(leaf, base,
                           is_leaf=lambda n: isinstance(n, rram.CrossbarWeight))
    return total


def sram_bytes(adapters: Pytree) -> int:
    """Bytes of the DoRA/LoRA side-car arrays at their storage width."""
    return sum(t.numel() * t.element_size() for t in tree_lib.tensors(adapters))


def calibrated_fraction(base: Pytree, adapters: Pytree) -> float:
    """Adapter params / base params (the paper's 2.34% headline)."""
    from repro_torch.models.transformer import count_params

    n_base, n_adapters = count_params({"base": base, "adapters": adapters})
    return n_adapters / max(n_base, 1)


def _stacked_column_norm(w, a, b, eps=1e-6):
    """``column_norm`` over a stack: w (E, d, k), a (E, d, r), b (E, r, k)
    -> (E, k). Port of ``repro/models/moe.py::_stacked_column_norm``."""
    if isinstance(w, rram.CrossbarWeight):
        w = rram.dequantize(w)
    wf = w.to(torch.float32)
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    w_sq = torch.sum(wf * wf, dim=1)
    wta = torch.einsum("edk,edr->ekr", wf, af)
    cross = torch.einsum("ekr,erk->ek", wta, bf)
    ab = torch.einsum("edr,erk->edk", af, bf)
    ab_sq = torch.sum(ab * ab, dim=1)
    return torch.sqrt(torch.clamp_min(w_sq + 2.0 * cross + ab_sq, eps))


def merge_adapters_for_serve(base: Pytree, adapters: Pytree) -> Pytree:
    """Algorithm 2 line 12 over a whole model: every ``dora_m`` becomes
    ``dora_m_merged = M / ||W_r + A@B||_col``. Scan-stacked adapters
    (lora_b (G, r, k)) take the stacked norm."""

    def walk(b, a):
        if isinstance(a, dict) and "lora_a" in a:
            if "dora_m" not in a:
                return a
            w = b["w"] if isinstance(b, dict) and "w" in b else b
            if isinstance(w, rram.CrossbarWeight):
                w = rram.dequantize(w)
            m = a["dora_m"].to(torch.float32)
            lb = a["lora_b"]
            if lb.dim() == 2:
                norm = dora_lib.column_norm(w, a["lora_a"], lb)
            elif lb.dim() == 3:
                norm = _stacked_column_norm(w, a["lora_a"], lb)
            else:
                raise NotImplementedError(
                    f"adapter with lora_b of rank {lb.dim()} is not ported")
            out = {k: v for k, v in a.items() if k != "dora_m"}
            out["dora_m_merged"] = m / norm
            return out
        if isinstance(a, dict):
            return {k: walk(b[k] if isinstance(b, dict) and k in b else b, v)
                    for k, v in a.items()}
        if isinstance(a, list):
            return [walk(b[i], v) for i, v in enumerate(a)]
        return a

    return walk(base, adapters)
