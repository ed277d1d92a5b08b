"""Composable per-leaf fault maps over the crossbar substrate. Port of
``repro/faults/map.py``.

A ``FaultMap`` holds one ``LeafFaults`` record per RRAM leaf, keyed by
the leaf's path string (``tree.path_str``, the same strings the drift
clock seeds from), each with the per-cell fault state of the positive
and negative device arrays of the differential pair.

Faults apply at code read-back: the resident (pristine) codes are never
written. ``apply_fault_map`` derives a faulty uint8 view, and every
consumer (the ``codes``, ``dequant`` and ``codes_adc`` backends, the
prepared serving tree) reads that one view.

Composition is a lattice join, commutative and idempotent:

* stuck cells: masks OR, pinned codes ``maximum`` (LRS wins);
* saturation caps: ``minimum`` (the tighter clamp wins);
* retention factors: ``minimum`` (the worse decay wins);
* I-V strength: ``maximum``.

Within a leaf the stages run in one fixed order (retention, I-V bend,
cap, stuck pins), so a composite has one meaning whatever the order its
parts were injected in. Every stage is elementwise on the code grid, so
a stacked leaf is applied one matrix at a time, bitwise the same as all
at once, with temporaries of one matrix.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import rram

_FIELDS = (
    "stuck_mask_pos", "stuck_val_pos", "stuck_mask_neg", "stuck_val_neg",
    "cap_pos", "cap_neg", "retain_pos", "retain_neg", "iv_strength",
)


@functools.lru_cache(maxsize=64)
def _iv_table_cpu(strength: float, code_max: int) -> torch.Tensor:
    """The I-V bend of every code 0..code_max for one strength, f32 on the
    CPU, in the reference's order of operations: ``round(code_max *
    sinh(max(s, 1e-6) * u) / sinh(max(s, 1e-6)))`` with ``u = code /
    code_max``, and the code itself where ``s <= 0``."""
    f32 = torch.float32
    s = torch.tensor(strength, dtype=f32)
    ss = torch.maximum(s, torch.tensor(1e-6, dtype=f32))
    cm = torch.tensor(float(code_max), dtype=f32)
    gf = torch.arange(code_max + 1, dtype=f32)
    bent = torch.round(cm * torch.sinh(ss * (gf / cm)) / torch.sinh(ss))
    return torch.where(s > 0.0, bent, gf)


def iv_table(strength: torch.Tensor, code_max: int, device) -> torch.Tensor:
    """``_iv_table_cpu`` for a strength tensor, on ``device``. After the
    retention stage every code is an integer in [0, code_max], so the
    bend is a gather from this table, and the card's view equals the
    CPU's by construction."""
    return _iv_table_cpu(float(strength), int(code_max)).to(device)


def _join(a, b, f):
    if a is None:
        return b
    if b is None:
        return a
    return f(a, b)


@dataclasses.dataclass
class LeafFaults:
    """Fault state of one RRAM leaf. A ``None`` field is the exact
    identity of its stage. Shapes match the leaf's ``g_pos``/``g_neg``;
    ``iv_strength`` is a 0-dim f32 tensor (a property of the column
    driver, not of a cell), or a fleet's ``(n_chips,)`` vector, one per
    row of the leaf's leading chip axis."""

    stuck_mask_pos: Optional[torch.Tensor] = None  # bool, True = pinned
    stuck_val_pos: Optional[torch.Tensor] = None   # uint8, 0 outside masks
    stuck_mask_neg: Optional[torch.Tensor] = None
    stuck_val_neg: Optional[torch.Tensor] = None
    cap_pos: Optional[torch.Tensor] = None         # uint8, code_max = no-op
    cap_neg: Optional[torch.Tensor] = None
    retain_pos: Optional[torch.Tensor] = None      # f32 in [0, 1], 1 = no decay
    retain_neg: Optional[torch.Tensor] = None
    iv_strength: Optional[torch.Tensor] = None     # f32 >= 0, 0 = linear read

    def fields(self) -> Dict[str, torch.Tensor]:
        """The fields that are set, by name."""
        return {f: getattr(self, f) for f in _FIELDS if getattr(self, f) is not None}

    def compose(self, other: "LeafFaults") -> "LeafFaults":
        """Lattice join of two records (commutative, idempotent)."""
        ops = {"stuck_mask": torch.logical_or, "stuck_val": torch.maximum,
               "cap": torch.minimum, "retain": torch.minimum, "iv": torch.maximum}
        return LeafFaults(**{
            f: _join(getattr(self, f), getattr(other, f),
                     ops[f.rsplit("_", 1)[0]])
            for f in _FIELDS
        })

    def _apply_device(self, g, mask, val, cap, retain, code_max: int, iv=None):
        """One stage chain over ``g``; ``iv`` is the I-V strength of these
        rows (``None``: the record's own)."""
        iv = self.iv_strength if iv is None else iv
        if g.dim() > 2:  # a stacked leaf: one matrix at a time
            # a fleet's I-V strength is a vector over the chip axis
            per_row = iv is not None and iv.dim() > 0
            out = torch.empty_like(g)
            for i in range(g.shape[0]):
                out[i] = self._apply_device(
                    g[i], *(None if t is None else t[i] for t in (mask, val, cap, retain)),
                    code_max, iv[i] if per_row else iv)
            return out
        gf = g.to(torch.float32)
        if retain is not None:
            gf = torch.round(gf * retain.to(torch.float32))
        if iv is not None:
            gf = iv_table(iv, code_max, g.device)[gf.long()]
        if cap is not None:
            gf = torch.minimum(gf, cap.to(torch.float32))
        if mask is not None:
            gf = torch.where(mask, val.to(torch.float32), gf)
        return torch.clamp(torch.round(gf), 0, code_max).to(torch.uint8)

    def apply(self, xw: rram.CrossbarWeight, cfg: rram.RramConfig) -> rram.CrossbarWeight:
        """The faulty read-back view of one leaf's codes. The input codes
        are not written; the per-column scale is the same tensor (faults
        live in the analog cells, not the digital periphery)."""
        if not self.fields():
            return xw
        cm = int(cfg.code_max)
        return rram.CrossbarWeight(
            self._apply_device(xw.g_pos, self.stuck_mask_pos, self.stuck_val_pos,
                               self.cap_pos, self.retain_pos, cm),
            self._apply_device(xw.g_neg, self.stuck_mask_neg, self.stuck_val_neg,
                               self.cap_neg, self.retain_neg, cm),
            xw.scale,
        )


class FaultMap:
    """Path string -> ``LeafFaults`` for a whole model."""

    def __init__(self, leaves: Dict[str, LeafFaults]):
        self.leaves = dict(leaves)

    def compose(self, other: "FaultMap") -> "FaultMap":
        """Merge two maps leaf by leaf (``LeafFaults.compose`` on shared
        paths); commutative and idempotent like the leaf join."""
        merged = dict(self.leaves)
        for path, lf in other.leaves.items():
            merged[path] = merged[path].compose(lf) if path in merged else lf
        return FaultMap(merged)

    __or__ = compose

    def __len__(self) -> int:
        return len(self.leaves)

    def __repr__(self) -> str:
        return f"FaultMap({len(self.leaves)} leaves)"


def compose_maps(maps: Iterable[Optional[FaultMap]]) -> Optional[FaultMap]:
    """Fold maps into one composite (``None`` entries skipped; ``None``
    when there is none). A generator is consumed one map at a time."""
    out: Optional[FaultMap] = None
    for m in maps:
        if m is None:
            continue
        out = m if out is None else out.compose(m)
    return out


def apply_fault_map(tree, fmap: Optional[FaultMap], cfg: rram.RramConfig):
    """The faulty codes view of ``tree``: every ``CrossbarWeight`` with an
    entry in ``fmap`` read back through it; everything else passes
    through as the same tensors. ``None`` is the healthy identity."""
    if fmap is None:
        return tree

    def leaf(path, x):
        if not isinstance(x, rram.CrossbarWeight):
            return x
        lf = fmap.leaves.get(tree_lib.path_str(path))
        return x if lf is None else lf.apply(x, cfg)

    return tree_lib.map_with_path(
        leaf, tree, is_leaf=lambda n: isinstance(n, rram.CrossbarWeight))
