"""Fault generators: serializable ``FaultSpec`` events that materialize
into ``FaultMap``s. Port of ``repro/faults/generators.py``.

A spec is the event, the map the state, as drift hours are to codes.
Specs are frozen records (kind, parameters, key words) whose
``to_dict`` is the reference's JSON, word for word.

The four fault classes:

* ``stuck_at``        cells pinned to LRS (``code_max``) or HRS (0);
* ``saturated``       cells clamped at ``round(cap_fraction * code_max)``;
* ``retention``       a random subset of cells decays to
                      ``round(code * retain)``;
* ``iv_nonlinearity`` the read path bends every code like the device's
                      ``sinh`` I-V curve; keyless.

Draws. The reference draws each leaf's uniforms ``(up, un)`` from
``split(fold_in(spec key, crc32(path)))``; threefry cannot be reproduced
here, so ``build_map`` takes those draws as ``draws={path: (up, un)}``.
Without them, leaf ``path`` draws ``up`` and then ``un`` from
``rram.make_generator(device, *spec.key_data, crc32(path))``: replayable
from the spec alone and independent of the order of injection.

The fleet. ``FaultSpec.for_chip(i)`` mixes chip ``i`` into the key words
(``np.random.SeedSequence``, not JAX's ``fold_in``), and
``build_fleet_map`` draws each selected chip's leaves from its
``for_chip`` spec, with exact-identity rows for the chips not selected,
so chip ``i``'s row of a fleet's map is bitwise
``build_map(codes_i, spec.for_chip(i))``.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import rram
from repro_torch.faults.map import FaultMap, LeafFaults

FAULT_KINDS = ("stuck_at", "saturated", "retention", "iv_nonlinearity")

Draws = Tuple[torch.Tensor, torch.Tensor]


def _key_words(key) -> Tuple[int, ...]:
    """An int seed or raw key words -> the reference's uint32 key words.
    ``PRNGKey(s)`` is ``[0, s]`` for ``0 <= s < 2**32``; other seeds are
    refused rather than spelled differently from the reference."""
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        s = int(key)
        if not 0 <= s < 2 ** 32:
            raise ValueError(f"an int fault seed must be in [0, 2**32), got {s}")
        return (0, s)
    words = tuple(int(v) for v in np.asarray(key).reshape(-1))
    if len(words) != 2 or not all(0 <= w < 2 ** 32 for w in words):
        raise ValueError(f"key words must be two uint32 values, got {words}")
    return words


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault event: kind, parameters and key words
    (``None`` for keyless kinds). Hashable and JSON-serializable."""

    kind: str
    params: Tuple[Tuple[str, float], ...]
    key_data: Optional[Tuple[int, ...]] = None

    @property
    def param(self) -> Dict[str, float]:
        return dict(self.params)

    def for_chip(self, chip: int) -> "FaultSpec":
        """The per-chip event: chip ``chip`` mixed into the key words, so a
        solo ``Deployment.inject(spec.for_chip(i))`` draws bitwise what
        ``Fleet.inject(spec, chips=[i])`` drew for chip ``i``. A keyless
        spec is its own per-chip event."""
        if self.key_data is None:
            return self
        words = np.random.SeedSequence([*self.key_data, int(chip)]).generate_state(2, np.uint32)
        return dataclasses.replace(self, key_data=_key_words(words))

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "params": dict(self.params),
            "key_data": None if self.key_data is None else list(self.key_data),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        kd = d.get("key_data")
        return cls(
            kind=d["kind"],
            params=tuple(sorted((k, float(v)) for k, v in d["params"].items())),
            key_data=None if kd is None else tuple(int(v) for v in kd),
        )


def _spec(kind: str, key, **params) -> FaultSpec:
    return FaultSpec(
        kind=kind,
        params=tuple(sorted((k, float(v)) for k, v in params.items())),
        key_data=None if key is None else _key_words(key),
    )


def _check_rate(rate: float) -> float:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"fault rate must be in [0, 1], got {rate}")
    return float(rate)


def stuck_at(key, *, rate: float, lrs_fraction: float = 0.5) -> FaultSpec:
    """Each cell sticks with probability ``rate``; of those,
    ``lrs_fraction`` pin to LRS (``code_max``), the rest to HRS (0). The
    view re-pins them after every ``advance``."""
    if not 0.0 <= lrs_fraction <= 1.0:
        raise ValueError(f"lrs_fraction must be in [0, 1], got {lrs_fraction}")
    return _spec("stuck_at", key, rate=_check_rate(rate), lrs_fraction=lrs_fraction)


def saturated(key, *, rate: float, cap_fraction: float = 0.75) -> FaultSpec:
    """With probability ``rate`` a cell's readable code clamps at
    ``round(cap_fraction * code_max)``."""
    if not 0.0 < cap_fraction <= 1.0:
        raise ValueError(f"cap_fraction must be in (0, 1], got {cap_fraction}")
    return _spec("saturated", key, rate=_check_rate(rate), cap_fraction=cap_fraction)


def retention(key, *, rate: float, retain: float = 0.5) -> FaultSpec:
    """With probability ``rate`` a cell's code decays to
    ``round(code * retain)``: a persistent floor, not a drift draw."""
    if not 0.0 <= retain <= 1.0:
        raise ValueError(f"retain must be in [0, 1], got {retain}")
    return _spec("retention", key, rate=_check_rate(rate), retain=retain)


def iv_nonlinearity(strength: float) -> FaultSpec:
    """The read sees ``code_max * sinh(s*u)/sinh(s)`` for normalized code
    ``u``; ``s=0`` is the linear read. Every RRAM leaf; keyless."""
    if strength < 0:
        raise ValueError(f"strength must be >= 0, got {strength}")
    return _spec("iv_nonlinearity", None, strength=strength)


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------


def leaf_draws(spec: FaultSpec, path: str, shape, device) -> Draws:
    """``(up, un)``: f32 uniforms of ``shape``, in that order, from leaf
    ``path``'s stream for ``spec``."""
    g = rram.make_generator(device, *spec.key_data, zlib.crc32(path.encode()))
    kw = dict(generator=g, device=g.device, dtype=torch.float32)
    return torch.rand(shape, **kw), torch.rand(shape, **kw)


def _f32(v: float, device) -> torch.Tensor:
    """A Python number rounded to f32, as JAX's weak-typed scalars are."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def leaf_fault(spec: FaultSpec, draws: Optional[Draws], shape,
               cfg: rram.RramConfig, device) -> LeafFaults:
    """One leaf's fault record from its uniforms ``draws = (up, un)``
    (``None`` for keyless kinds). Comparisons run in f32 against the
    parameters rounded to f32, as the reference's do."""
    cm = int(cfg.code_max)
    p = spec.param
    if spec.kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {spec.kind!r}; known: {FAULT_KINDS}")
    if spec.kind == "iv_nonlinearity":
        return LeafFaults(iv_strength=_f32(p["strength"], device))
    up, un = (d if isinstance(d, torch.Tensor) else torch.from_numpy(np.array(d))
              for d in draws)
    up, un = (d.to(device=device, dtype=torch.float32) for d in (up, un))
    if tuple(up.shape) != tuple(shape) or tuple(un.shape) != tuple(shape):
        raise ValueError(f"draws of shape {tuple(up.shape)} for a leaf of {tuple(shape)}")
    rate = _f32(p["rate"], device)
    if spec.kind == "stuck_at":
        lrs = _f32(p["rate"] * p["lrs_fraction"], device)
        return LeafFaults(
            stuck_mask_pos=up < rate,
            stuck_val_pos=(up < lrs).to(torch.uint8).mul_(cm),
            stuck_mask_neg=un < rate,
            stuck_val_neg=(un < lrs).to(torch.uint8).mul_(cm),
        )
    if spec.kind == "saturated":
        cap = torch.tensor(round(p["cap_fraction"] * cm), dtype=torch.uint8, device=device)
        full = torch.tensor(cm, dtype=torch.uint8, device=device)
        return LeafFaults(cap_pos=torch.where(up < rate, cap, full),
                          cap_neg=torch.where(un < rate, cap, full))
    r, one = _f32(p["retain"], device), _f32(1.0, device)
    return LeafFaults(retain_pos=torch.where(up < rate, r, one),
                      retain_neg=torch.where(un < rate, r, one))


def rram_leaves(tree) -> List[Tuple[str, rram.CrossbarWeight]]:
    """``(path, CrossbarWeight)`` for every RRAM leaf, in walk order."""
    out: List[Tuple[str, rram.CrossbarWeight]] = []

    def visit(path, x):
        if isinstance(x, rram.CrossbarWeight):
            out.append((tree_lib.path_str(path), x))
        return x

    tree_lib.map_with_path(visit, tree,
                           is_leaf=lambda n: isinstance(n, rram.CrossbarWeight))
    return out


def build_map(codes, spec: FaultSpec, cfg: rram.RramConfig,
              draws: Optional[Mapping[str, Draws]] = None) -> FaultMap:
    """Materialize ``spec`` over a codes tree: one ``LeafFaults`` per RRAM
    leaf, on the leaf's device. ``draws`` maps each leaf's path to its
    ``(up, un)`` (the reference's, in parity tests); without it each leaf
    draws from its own stream (``leaf_draws``)."""
    leaves = {}
    for path, xw in rram_leaves(codes):
        shape, device = tuple(xw.g_pos.shape), xw.g_pos.device
        d = None
        if spec.key_data is not None:
            d = draws[path] if draws is not None else leaf_draws(spec, path, shape, device)
        leaves[path] = leaf_fault(spec, d, shape, cfg, device)
    return FaultMap(leaves)


# identity of each field for a chip the spec does not select
_IDENTITY = {"stuck_mask_pos": False, "stuck_val_pos": 0, "stuck_mask_neg": False,
             "stuck_val_neg": 0, "cap_pos": None, "cap_neg": None,
             "retain_pos": 1.0, "retain_neg": 1.0}


def build_fleet_map(per_chip_codes, spec: FaultSpec, cfg: rram.RramConfig,
                    chips: Sequence[int], n_chips: int,
                    draws: Optional[Mapping[int, Mapping[str, Draws]]] = None) -> FaultMap:
    """Materialize ``spec`` over a fleet: each field carries a leading
    ``(n_chips,)`` axis matching the stacked codes. Row ``c`` of a selected
    chip is ``build_map``'s record drawn from ``spec.for_chip(c)``; the
    other rows are the exact identity (nothing stuck, caps at
    ``code_max``, retention 1, I-V strength 0). ``per_chip_codes`` gives
    the per-chip leaf shapes and device (one chip's codes tree); ``draws``
    maps a chip to its ``{path: (up, un)}`` (the reference's, in parity
    tests)."""
    chips = [int(c) for c in chips]
    cm = int(cfg.code_max)
    leaves: Dict[str, LeafFaults] = {}
    for path, xw in rram_leaves(per_chip_codes):
        shape, device = tuple(xw.g_pos.shape), xw.g_pos.device
        if spec.key_data is None:
            strength = torch.zeros((n_chips,), dtype=torch.float32, device=device)
            strength[chips] = _f32(spec.param["strength"], device)
            leaves[path] = LeafFaults(iv_strength=strength)
            continue
        full: Dict[str, torch.Tensor] = {}
        for c in chips:
            chip_spec = spec.for_chip(c)
            d = (draws[c][path] if draws is not None
                 else leaf_draws(chip_spec, path, shape, device))
            for name, t in leaf_fault(chip_spec, d, shape, cfg, device).fields().items():
                if name not in full:
                    fill = _IDENTITY[name]
                    full[name] = torch.full((n_chips,) + shape, cm if fill is None else fill,
                                            dtype=t.dtype, device=device)
                full[name][c] = t
        leaves[path] = LeafFaults(**full)
    return FaultMap(leaves)
