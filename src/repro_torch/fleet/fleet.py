"""``Fleet`` — N chips, one model, stacked trees. Port of
``repro/fleet/fleet.py`` (its mesh paths wait for the port's distributed
slice).

Every edge chip carries the same target weights but its own programming
noise, its own drift clock and its own SRAM side-car. ``Deployment``
models one chip; ``Fleet`` models N of them as stacked trees: every RRAM
leaf carries a leading chip axis (``(N, ...)``), while the digital
peripherals (norms, embeddings) and the teacher are one shared buffer.

* ``Fleet.program(cfg, seed, n_chips)`` — the teacher from the teacher
  seed, chip ``i`` programmed from ``chip_seed(i)`` (the program seed and
  ``i`` mixed by ``np.random.SeedSequence``), so ``Deployment.program(cfg,
  (fleet.teacher_seed, fleet.chip_seed(i)))`` rebuilds chip ``i``
  bitwise. Torch generators do not vmap: programming and drift run chip
  by chip, each from its own ``(chip seed, leaf, event)`` streams, and
  write the chip's row of the stacked leaf in place.
* ``fleet.advance(hours, chips=...)`` — heterogeneous drift clocks: each
  chip keeps its own ordered event history, so advancing disjoint chips
  commutes in any interleaving of calls.
* ``fleet.inject(faults, chips=...)`` — a stacked fault map
  (``faults.build_fleet_map``), identity rows for chips not selected;
  chip ``i``'s view is bitwise ``Deployment.inject(spec.for_chip(i))``.
* ``fleet.calibrate(...)`` — Algorithm 1 for the selected chips under
  ``dequant``: the teacher's features are computed once for all of them,
  and every step of every chip runs from one ``CompiledCalibStep`` over
  the chips (on the card one CUDA graph a step: step 1 eager, step 2
  captured, the rest replayed), each chip's step the very operations of
  its solo step, so chip ``i``'s losses, adapters and AdamW state are
  bitwise an independent ``Deployment.calibrate``'s. One step is built a
  call, whatever the number of chips (``fleet_compile_count``).
* ``fleet.chip(i)`` / ``fleet.serve(i)`` — chip ``i`` as a plain
  ``Deployment`` (copies of its rows: advancing one does not move the
  other) and a serving session over it. Each session captures its own
  graphs (a session's graphs are bound to its params' addresses).
* ``fleet.snapshot()`` / ``Fleet.restore()`` — the stacked base is never
  stored: restore replays the programming, every chip's drift history
  round-robin and every fault event, and refuses what it cannot replay
  bitwise (another device, a digest that differs).

The drift-aware recalibration policy lives in ``fleet/scheduler.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import substrate
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import as_manager
from repro_torch.core import rram
from repro_torch.core.calibrate import (
    CalibState,
    CompiledCalibStep,
    _is_rram_leaf,
    drift_model,
    program_model,
    rram_bytes,
    sram_bytes,
    teacher_features,
)
from repro_torch.deploy import serving
from repro_torch.deploy.deployment import (
    CalibrationReport,
    Deployment,
    _dequant_like,
    _device_batch,
    calibration_batch,
    check_digests,
    code_digest,
    device_name,
    open_snapshot,
    resolve_device,
    seed_pair,
)
from repro_torch.faults.generators import FaultSpec, build_fleet_map
from repro_torch.faults.map import FaultMap, LeafFaults, compose_maps
from repro_torch.interop import from_reference
from repro_torch.models import transformer as T
from repro_torch.optim.adam import AdamState, AdamW

Pytree = Any

_FLEET_META = "fleet.json"
_SEED_MASK = 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# stacked trees: RRAM leaves carry the chip axis, peripherals are shared
# ---------------------------------------------------------------------------


def _is_cw(n) -> bool:
    return isinstance(n, rram.CrossbarWeight)


def chip_axes(tree: Pytree) -> Pytree:
    """Per-leaf chip axis of a stacked base tree: ``0`` for RRAM leaves
    (``CrossbarWeight`` or their float read-backs), ``None`` for the shared
    peripherals."""
    return tree_lib.map_with_path(lambda p, x: 0 if (_is_cw(x) or _is_rram_leaf(p)) else None,
                                  tree, is_leaf=_is_cw)


def _take(tree: Pytree, i: int, copy: bool = False) -> Pytree:
    """Chip ``i`` of a stacked base tree: views of its rows (copies with
    ``copy``); the shared leaves as they are."""
    row = (lambda t: t[i].clone()) if copy else (lambda t: t[i])

    def leaf(p, x):
        if _is_cw(x):
            return rram.CrossbarWeight(row(x.g_pos), row(x.g_neg), row(x.scale))
        return row(x) if _is_rram_leaf(p) else x

    return tree_lib.map_with_path(leaf, tree, is_leaf=_is_cw)


def _rram_tensors(tree: Pytree) -> List[List[torch.Tensor]]:
    """The tensors of every RRAM leaf in walk order: ``[g_pos, g_neg,
    scale]`` of a ``CrossbarWeight``, ``[w]`` of a float read-back."""
    out: List[List[torch.Tensor]] = []

    def leaf(p, x):
        if _is_cw(x):
            out.append([x.g_pos, x.g_neg, x.scale])
        elif _is_rram_leaf(p):
            out.append([x])
        return x

    tree_lib.map_with_path(leaf, tree, is_leaf=_is_cw)
    return out


@torch.no_grad()
def _put(stacked: Pytree, i: int, chip: Pytree) -> None:
    """Write chip ``i``'s RRAM leaves (a per-chip tree of the same layout)
    into its rows of ``stacked``, in place; a tensor that already is the
    row is left alone."""
    for rows, new in zip(_rram_tensors(stacked), _rram_tensors(chip)):
        for full, t in zip(rows, new):
            if t.data_ptr() != full[i].data_ptr():
                full[i].copy_(t)


def _rows(tree: Pytree, idx) -> Pytree:
    """Rows ``idx`` of every tensor of a stacked adapter or AdamW tree."""
    if isinstance(tree, AdamState):
        return AdamState(*(_rows(t, idx) for t in tree))
    return tree_lib.map_tensors(lambda t: t[idx], tree)


def _clone(tree: Pytree) -> Pytree:
    if isinstance(tree, AdamState):
        return AdamState(*(_clone(t) for t in tree))
    return tree_lib.map_tensors(torch.clone, tree)


def _stack_copies(tree: Pytree, n: int) -> Pytree:
    """``n`` copies of every tensor of ``tree`` on a new leading axis."""
    return tree_lib.map_tensors(lambda t: t.unsqueeze(0).expand(n, *t.shape).clone(), tree)


def _adamw_init_stacked(adapters: Pytree) -> AdamState:
    """``adamw_init`` of every chip at once: f32 zeros like the stacked
    adapters and one int32 step count a chip."""
    leaves = tree_lib.tensors(adapters)
    n, device = leaves[0].shape[0], leaves[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamState(step=torch.zeros((n,), dtype=torch.int32, device=device),
                     mu=tree_lib.map_tensors(zeros, adapters),
                     nu=tree_lib.map_tensors(zeros, adapters))


def chip_seed(program_seed: int, chip: int) -> int:
    """Chip ``chip``'s programming seed: ``(program_seed, chip)`` mixed by
    ``np.random.SeedSequence`` into 63 bits (the port's counterpart of
    ``fold_in(program_key, chip)``)."""
    state = np.random.SeedSequence([int(program_seed) & _SEED_MASK, int(chip)])
    return int(state.generate_state(1, np.uint64)[0] >> 1)


def chip_seeds(program_seed: int, n_chips: int) -> List[int]:
    """``chip_seed(program_seed, i)`` for ``i in range(n_chips)`` (the
    reference's ``chip_keys``)."""
    return [chip_seed(program_seed, i) for i in range(int(n_chips))]


def fleet_program_model(base: Pytree, cfg: rram.RramConfig, seeds: Sequence[int], *,
                        mode: str = "codes") -> Pytree:
    """``program_model`` for a whole fleet: chip ``i`` programmed from
    ``seeds[i]`` (bitwise ``program_model(base, cfg, seeds[i])``) into its
    row of every stacked RRAM leaf, one chip at a time, so no second
    stacked copy is made. The digital peripherals are returned as the
    same tensors: one copy for the fleet."""
    n = len(seeds)
    out = None
    for i, seed in enumerate(seeds):
        chip = program_model(base, cfg, int(seed), mode=mode)
        if out is None:
            def empty(p, x):
                if _is_cw(x):
                    return rram.CrossbarWeight(*(t.new_empty((n,) + tuple(t.shape))
                                                 for t in (x.g_pos, x.g_neg, x.scale)))
                return x.new_empty((n,) + tuple(x.shape)) if _is_rram_leaf(p) else x

            out = tree_lib.map_with_path(empty, chip, is_leaf=_is_cw)
        _put(out, i, chip)
        del chip
    return out


# calibration steps built per config: one per ``Fleet.calibrate`` call
_CALIB_STEPS: Counter = Counter()


def fleet_compile_count(cfg) -> int:
    """The calibration steps built for ``cfg``'s fleets: one per
    ``Fleet.calibrate`` call, whatever the number of chips (on the card
    each captures one CUDA graph, from its second step). The counterpart
    of the reference's count of compiles per fleet shape."""
    return _CALIB_STEPS[cfg]


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetCalibrationReport:
    """Outcome of one ``Fleet.calibrate`` call."""

    chips: List[int]             # which chips this pass trained
    losses: np.ndarray           # (steps, len(chips)) per-step feature MSE
    epochs_run: int
    sram_bytes: int              # total side-car bytes (all chips)
    sram_bytes_per_chip: int
    rram_bytes: int              # total resident code bytes across the fleet
    base_params: int             # per-chip logical base params
    adapter_params: int          # per-chip adapter params
    calibrated_fraction: float
    backend: str
    # which of ``chips`` were seeded from a stable reference, and from which
    warm_started_chips: List[int] = dataclasses.field(default_factory=list)
    warm_sources: List[str] = dataclasses.field(default_factory=list)

    @property
    def initial_loss(self) -> np.ndarray:
        return self.losses[0]

    @property
    def final_loss(self) -> np.ndarray:
        return self.losses[-1]

    def summary(self) -> str:
        return (
            f"calibrated {len(self.chips)} chips x {self.epochs_run} epochs: "
            f"feature MSE {float(self.initial_loss.mean()):.6f} -> "
            f"{float(self.final_loss.mean()):.6f} (fleet mean) | "
            f"sram_bytes/chip={self.sram_bytes_per_chip} "
            f"({self.calibrated_fraction:.2%} of params) "
            f"backend={self.backend}"
        )


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------


class Fleet:
    """N deployments of one model as stacked trees (see the module
    docstring). ``self.codes`` is the stacked ground truth; ``codes_view``
    it read back through the stacked fault map; ``self.base`` what the
    chips' forwards consume (the view, or its float read-back under
    ``dequant``)."""

    def __init__(self, cfg, backend: str, teacher_base: Pytree, codes: Pytree,
                 adapters: Pytree, teacher_seed: int, program_seed: int, n_chips: int):
        if backend not in serving.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; available: {serving.BACKENDS}")
        if n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        self.cfg = cfg
        self.backend = backend
        self.teacher_base = teacher_base
        self.codes = codes
        self.adapters = adapters
        self.teacher_seed = int(teacher_seed)
        self.program_seed = int(program_seed)
        self.n_chips = int(n_chips)
        self.opt_state: Optional[AdamState] = None
        self.steps: List[int] = [0] * self.n_chips
        self.drift_hours: List[List[float]] = [[] for _ in range(self.n_chips)]
        # (spec, chips) events and the stacked map composed from them
        self.fault_events: List[Tuple[FaultSpec, Tuple[int, ...]]] = []
        self._fault_map: Optional[FaultMap] = None
        self._unreplayable: Optional[str] = None
        self._stream = None
        self._teacher_logits_cache = None
        self._refresh_base()
        self._proxy_ref = self._gamma_norms()

    @property
    def device(self) -> torch.device:
        return self.teacher_base["embed"]["embedding"].device

    # -- programming event ----------------------------------------------------

    @classmethod
    def program(cls, cfg, seed=0, n_chips: int = 1, *, backend: str = "dequant",
                device="cuda") -> "Fleet":
        """One programming event for ``n_chips`` devices sharing the
        teacher's target weights: the teacher from the teacher seed (an int
        ``seed`` gives ``seed`` and the program seed ``seed + 1``, as
        ``Deployment.program``; or a pair), chip ``i``'s codes from
        ``chip_seed(i)``. The adapters start as the teacher init's on every
        chip and diverge through calibration."""
        teacher_seed, program_seed = seed_pair(seed)
        device = resolve_device(device)
        params = T.init_params(rram.make_generator(device, teacher_seed), cfg)
        codes = fleet_program_model(params["base"], cfg.rram,
                                    chip_seeds(program_seed, n_chips))
        return cls(cfg, backend, params["base"], codes,
                   _stack_copies(params["adapters"], n_chips), teacher_seed, program_seed,
                   n_chips)

    @classmethod
    def from_arrays(cls, cfg, teacher_base, codes, adapters, *, backend: str = "codes",
                    seed=0, drift_hours: Optional[Sequence[Sequence[float]]] = None,
                    device="cuda") -> "Fleet":
        """A fleet over stacked trees made elsewhere (the reference fleet's,
        as numpy trees in its layout: ``interop.from_reference``).
        ``drift_hours`` is each chip's drift history those codes carry;
        later events draw from the port's streams for ``seed``'s chips. No
        seed replays those codes, so such a fleet cannot be snapshotted."""
        device = resolve_device(device)
        codes_t = from_reference(codes, device)
        n = _rram_tensors(codes_t)[0][0].shape[0]
        fleet = cls(cfg, backend, from_reference(teacher_base, device), codes_t,
                    from_reference(adapters, device), *seed_pair(seed), n)
        if drift_hours is not None:
            fleet.drift_hours = [[float(h) for h in hs] for hs in drift_hours]
        fleet._unreplayable = "Fleet.from_arrays (codes made elsewhere)"
        return fleet

    def chip_seed(self, i: int) -> int:
        """Chip ``i``'s programming seed: ``Deployment.program(cfg,
        (fleet.teacher_seed, fleet.chip_seed(i)))`` rebuilds that chip."""
        return chip_seed(self.program_seed, i)

    def _refresh_base(self):
        # the pristine stacked codes stay the drift clock's ground truth;
        # forwards, calibration and the proxies read the faulty view
        self.codes_view = substrate.faulted_codes(self.codes, self._fault_map, self.cfg.rram)
        if self.backend == "dequant":
            self.base = _dequant_like(self.codes_view, self.teacher_base)
        else:
            self.base = self.codes_view

    # -- heterogeneous drift clocks -------------------------------------------

    def field_hours(self, chip: int) -> float:
        """Chip ``chip``'s total elapsed field time."""
        return float(sum(self.drift_hours[chip]))

    def _chip_list(self, chips) -> List[int]:
        if chips is None:
            return list(range(self.n_chips))
        out = [int(c) for c in chips]
        if len(set(out)) != len(out):
            raise ValueError(f"duplicate chips in {out}")
        for c in out:
            if not 0 <= c < self.n_chips:
                raise ValueError(f"chip {c} out of range [0, {self.n_chips})")
        return out

    def advance(self, hours: Union[float, Sequence[float]], chips=None) -> "Fleet":
        """Let field time pass on ``chips`` (default all): ``hours`` is one
        number for every chip or one per chip. Each affected chip draws its
        tick from its own ``(chip seed, leaf, event)`` streams over its own
        clock, so its codes are bitwise what ``Deployment.advance`` gives,
        and advancing disjoint chips commutes. Under ``dequant`` only the
        affected rows of the read-back are refreshed. ``hours=0`` entries
        are no-ops; negative hours raise."""
        chips = self._chip_list(chips)
        if isinstance(hours, (int, float)):
            hlist = [float(hours)] * len(chips)
        else:
            hlist = [float(h) for h in hours]
            if len(hlist) != len(chips):
                raise ValueError(f"hours has {len(hlist)} entries for {len(chips)} chips")
        for h in hlist:
            if h < 0:
                raise ValueError(f"drift clock cannot run backwards (hours={h})")
        active = [(c, h) for c, h in zip(chips, hlist) if h > 0]
        for c, h in active:
            new = drift_model(_take(self.codes, c), self.cfg.rram, self.chip_seed(c),
                              hours=h, event_index=len(self.drift_hours[c]),
                              clock_offset=self.field_hours(c))
            _put(self.codes, c, new)
            if self._fault_map is None and self.backend == "dequant":
                _put(self.base, c, _dequant_like(new, self.teacher_base))
            del new
            self.drift_hours[c].append(h)
        if active and self._fault_map is not None:
            # stuck cells stay pinned over the freshly drifted codes
            self._refresh_base()
        return self

    # -- fault injection ------------------------------------------------------

    def inject(self, faults: Union[FaultSpec, Sequence[FaultSpec]], chips=None, *,
               draws=None) -> "Fleet":
        """Inject device faults (a ``FaultSpec`` or a sequence) into
        ``chips`` (default all), recorded in ``fault_events``: each selected
        chip draws from ``spec.for_chip(chip)``'s streams, the others get
        identity rows, so chip ``i``'s view is bitwise
        ``Deployment.inject(spec.for_chip(i))``'s. The maps are composed
        into the current one (a join: bitwise the rebuild from every
        event, and a repeated injection changes nothing); the pristine
        codes are not touched. ``draws`` gives one spec's per-chip uniforms
        ``{chip: {path: (up, un)}}`` (a sequence of them for a sequence of
        specs); a fleet given them cannot be snapshotted."""
        one = isinstance(faults, FaultSpec)
        specs = [faults] if one else list(faults)
        per = [None] * len(specs) if draws is None else ([draws] if one else list(draws))
        if len(per) != len(specs):
            raise ValueError(f"{len(per)} draws for {len(specs)} fault specs")
        chip_list = tuple(self._chip_list(chips))
        template = _take(self.codes, 0)  # the per-chip leaf shapes
        new = compose_maps(build_fleet_map(template, s, self.cfg.rram, chip_list,
                                           self.n_chips, draws=d)
                           for s, d in zip(specs, per))
        self.fault_events.extend((s, chip_list) for s in specs)
        if self._unreplayable is None and any(d is not None for d in per):
            self._unreplayable = "Fleet.inject(draws=...) (draws passed in)"
        self._fault_map = compose_maps([self._fault_map, new])
        self._refresh_base()
        return self

    def fault_map_bytes(self) -> int:
        """Bytes of the stacked fault map (0 without faults)."""
        if self._fault_map is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for lf in self._fault_map.leaves.values() for t in lf.fields().values())

    # -- calibration ----------------------------------------------------------

    def optimizer_state(self) -> AdamState:
        """The stacked AdamW state (``adamw_init`` of every chip the first
        time): step counts ``(n_chips,)``, moments with the chip axis."""
        if self.opt_state is None:
            self.opt_state = _adamw_init_stacked(self.adapters)
        return self.opt_state

    # one calibration stream per fleet (cuBLAS keeps a workspace per stream)
    _calib_stream = Deployment._calib_stream

    def calibrate(
        self, batch_or_samples: Union[Dict, int] = 10, *,
        steps: int = 20, lr: float = 1e-3, opt: Optional[AdamW] = None,
        seq_len: int = 32, chips=None, cached_teacher: Optional[bool] = None,
        loss_threshold: float = 0.0, registry=None, warm_start: bool = False,
        record: bool = True,
    ) -> FleetCalibrationReport:
        """Algorithm 1 for ``chips`` (default all) under ``dequant``: the
        frozen teacher's features are computed once for every selected chip,
        and one ``CompiledCalibStep`` over the chips runs each step (on the
        card one CUDA graph a step). Chip ``i``'s losses, adapters and AdamW
        state are bitwise an independent ``Deployment.calibrate``'s with
        the same seeds and arguments. ``loss_threshold`` stops the loop once
        every selected chip's loss is at or below it. ``warm_start=True``
        first seeds the selected chips from their nearest stable references
        (``registry/warmstart.seed_fleet``); ``record=True`` files each
        chip's run under its own ``(cfg, backend, chip_signature)`` key."""
        cfg = self.cfg
        opt = opt if opt is not None else AdamW(lr=lr)
        chips = self._chip_list(chips)
        batch = _device_batch(calibration_batch(cfg, batch_or_samples, seq_len), self.device)
        use_cached = True if cached_teacher is None else bool(cached_teacher)
        opt_state = self.optimizer_state()
        warm_recs: List[Any] = [None] * len(chips)
        if registry is not None and warm_start:
            from repro_torch.registry.warmstart import seed_fleet

            warm_recs = seed_fleet(self, registry, chips)
        states = [CalibState(self.teacher_base, _take(self.base, c), _rows(self.adapters, c),
                             _rows(opt_state, c), self.steps[c]) for c in chips]
        backend_ctx = (substrate.use_backend("dequant") if self.backend != "dequant"
                       else contextlib.nullcontext())
        losses: List[np.ndarray] = []
        with backend_ctx:
            feats = teacher_features(self.teacher_base, batch, cfg) if use_cached else None
            step = CompiledCalibStep(cfg, opt, states, batch, feats,
                                     stream=self._calib_stream())
            _CALIB_STEPS[cfg] += 1
            try:
                for _ in range(steps):
                    losses.append(step()["loss"].cpu().numpy().copy())
                    if loss_threshold and bool(np.all(losses[-1] <= loss_threshold)):
                        break
                trained = step.state()
            finally:
                step.release()
        del states, feats
        with torch.no_grad():
            for c, st in zip(chips, trained):
                for full, new in zip(tree_lib.tensors([self.adapters, *opt_state]),
                                     tree_lib.tensors([st.adapters, *st.opt_state])):
                    full[c].copy_(new)
                self.steps[c] = int(st.step)
        del trained
        # recalibration resets the drift baseline of the chips it touched
        now = self._gamma_norms(chips)
        for ref, cur in zip(self._proxy_ref, now):
            for j, c in enumerate(chips):
                ref[c] = cur[j]
        n_base, n_adapters = T.count_params({"base": self.teacher_base,
                                             "adapters": _rows(self.adapters, 0)})
        total_sram = sram_bytes(self.adapters)
        report = FleetCalibrationReport(
            chips=chips, losses=np.stack(losses), epochs_run=len(losses),
            sram_bytes=total_sram, sram_bytes_per_chip=total_sram // self.n_chips,
            rram_bytes=rram_bytes(self.codes), base_params=n_base,
            adapter_params=n_adapters, calibrated_fraction=n_adapters / max(n_base, 1),
            backend=self.backend,
            warm_started_chips=[c for c, r in zip(chips, warm_recs) if r is not None],
            warm_sources=[r.name for r in warm_recs if r is not None],
        )
        if registry is not None and record:
            self._record_artifacts(registry, report, warm_recs)
        return report

    def _record_artifacts(self, registry, report: FleetCalibrationReport, warm_recs) -> None:
        """File each calibrated chip's run as its own versioned artifact
        (its signature differs from its siblings', so each goes under, and
        is checked against, its own key)."""
        for j, c in enumerate(report.chips):
            rec = warm_recs[j]
            chip_report = CalibrationReport(
                losses=[float(x) for x in report.losses[:, j]],
                epochs_run=report.epochs_run, sram_bytes=report.sram_bytes_per_chip,
                rram_bytes=report.rram_bytes // self.n_chips,
                base_params=report.base_params, adapter_params=report.adapter_params,
                calibrated_fraction=report.calibrated_fraction, backend=report.backend,
                drift_events=len(self.drift_hours[c]), warm_started=rec is not None,
                warm_source=None if rec is None else rec.name)
            registry.record(self.cfg, self.backend, self.chip_signature(c),
                            adapters=_rows(self.adapters, c),
                            opt_state=_rows(self.optimizer_state(), c),
                            report=chip_report, extra_meta={"chip": int(c)})

    def chip_signature(self, i: int) -> np.ndarray:
        """Chip ``i``'s registry signature: the device feature of its seed
        and its own drift and fault state."""
        from repro_torch.registry.warmstart import drift_signature

        i = int(i)
        return drift_signature(
            self.cfg.rram, self.chip_seed(i), field_hours=self.field_hours(i),
            drift_events=len(self.drift_hours[i]),
            fault_events=sum(1 for _, chips in self.fault_events if i in chips))

    def reset_adapters(self) -> "Fleet":
        """Every chip's side-cars back to the fresh (output-preserving)
        teacher init, the optimizer cleared; codes and clocks untouched."""
        fresh = T.init_params(rram.make_generator(self.device, self.teacher_seed),
                              self.cfg)["adapters"]
        self.adapters = _stack_copies(fresh, self.n_chips)
        self.opt_state = None
        self.steps = [0] * self.n_chips
        return self

    # -- drift proxies --------------------------------------------------------

    @torch.no_grad()
    def _gamma_norms(self, chips: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """Per RRAM leaf, the faulty view's code column norms of ``chips``
        (default all), ``(len(chips), ..., n)``: one chip at a time, so the
        f32 read-back is one chip's."""
        chips = range(self.n_chips) if chips is None else chips
        out = []

        def leaf(_, x):
            if _is_cw(x):
                out.append(torch.stack([substrate.code_column_norms(
                    rram.CrossbarWeight(x.g_pos[c], x.g_neg[c], x.scale[c])) for c in chips]))
            return x

        tree_lib.map_with_path(leaf, self.codes_view, is_leaf=_is_cw)
        return out

    def _relative_moves(self):
        for now, ref in zip(self._gamma_norms(), self._proxy_ref):
            rel = torch.abs(now - ref) / torch.clamp_min(torch.abs(ref), 1e-8)
            yield rel.reshape(self.n_chips, -1)

    def drift_proxy(self) -> np.ndarray:
        """(n_chips,) forward-free drift signal: the mean relative movement
        of the code column norms (what the merged DoRA gamma divides by)
        since each chip's last calibration or programming. The
        ``RecalibrationScheduler`` recalibrates a chip only past its
        threshold."""
        vals = [rel.mean(dim=1) for rel in self._relative_moves()]
        return torch.stack(vals).mean(dim=0).cpu().numpy()

    def hard_fault_proxy(self) -> np.ndarray:
        """(n_chips,) hard-fault signal: the largest relative movement of
        any single column norm since the chip's last calibration. Drift
        moves every column a little; a stuck or saturated cell moves one
        column a lot, which drift alone does not do."""
        vals = [rel.amax(dim=1) for rel in self._relative_moves()]
        return torch.stack(vals).amax(dim=0).cpu().numpy()

    # the frozen teacher's logits, one forward per batch
    _teacher_logits = Deployment._teacher_logits

    def logit_mse(self, batch: Dict, *, use_adapters: bool = True) -> np.ndarray:
        """(n_chips,) teacher/student logit MSE on ``batch``: one teacher
        forward, then each chip's forward under ``dequant`` (as the
        reference's vmapped one)."""
        t = self._teacher_logits(batch)
        device_batch = _device_batch(batch, self.device)
        backend_ctx = (substrate.use_backend("dequant") if self.backend != "dequant"
                       else contextlib.nullcontext())
        out = []
        with backend_ctx, torch.no_grad():
            for c in range(self.n_chips):
                s = T.forward({"base": _take(self.base, c),
                               "adapters": _rows(self.adapters, c) if use_adapters else {}},
                              device_batch, self.cfg,
                              use_adapters=use_adapters).to(torch.float32)
                out.append(torch.mean((s - t) ** 2))
        return torch.stack(out).cpu().numpy()

    # -- one chip -------------------------------------------------------------

    def chip(self, i: int) -> Deployment:
        """Chip ``i`` as a plain ``Deployment``: copies of its codes,
        adapters and AdamW state, its history and step, and its rows of the
        fault map. The two share no mutable state: advancing one does not
        move the other. The teacher is shared (it is frozen)."""
        i = int(i)
        if not 0 <= i < self.n_chips:
            raise ValueError(f"chip {i} out of range [0, {self.n_chips})")
        dep = Deployment(self.cfg, self.backend, self.teacher_base,
                         _take(self.codes, i, copy=True),
                         _clone(_rows(self.adapters, i)), self.teacher_seed,
                         self.chip_seed(i), self.drift_hours[i])
        dep.step = int(self.steps[i])
        if self.opt_state is not None:
            dep.opt_state = _clone(_rows(self.opt_state, i))
        specs = [spec.for_chip(i) for spec, chips in self.fault_events if i in chips]
        if specs:
            # the fleet map's row i is bitwise build_map(codes_i, spec.for_chip(i))
            dep.fault_specs = specs
            dep._fault_map = FaultMap({
                path: LeafFaults(**{f: t[i].clone() for f, t in lf.fields().items()})
                for path, lf in self._fault_map.leaves.items()})
            dep._refresh_base()
        dep._unreplayable = self._unreplayable
        return dep

    def serve(self, chip: int) -> serving.ServeSession:
        """A serving session over chip ``chip`` (``chip(i).serve()``): a
        fresh session that captures its own graphs."""
        return self.chip(chip).serve()

    # -- accounting -----------------------------------------------------------

    def sram_bytes(self) -> int:
        """Side-car bytes across the fleet (N x per chip)."""
        return sram_bytes(self.adapters)

    def rram_bytes(self) -> int:
        """Resident code bytes across the fleet."""
        return rram_bytes(self.codes)

    # -- persistence ----------------------------------------------------------

    def snapshot(self, directory_or_manager, *, blocking: bool = True) -> int:
        """Checkpoint the fleet's mutable state through ``CheckpointManager``:
        the stacked adapters and AdamW state, the lifecycle (seeds, step
        counts, every chip's drift history, padded) and the drift-proxy
        baselines, at a step that grows with any calibration step or drift
        event; and ``fleet.json``: backend, arch, chip count, each chip's
        drift-event count, the fault events, the device type, the card's model and digests of the codes
        and the view. The stacked base is not stored. Raises ``ValueError``
        on a fleet holding draws no seed replays."""
        if self._unreplayable is not None:
            raise ValueError(
                f"cannot snapshot this fleet: {self._unreplayable} holds draws that no seed "
                "replays, so restore could not re-derive its codes")
        manager = as_manager(directory_or_manager)
        counts = [len(h) for h in self.drift_hours]
        step = int(sum(self.steps) + sum(counts))
        padded = np.zeros((self.n_chips, max(counts, default=0)), np.float64)
        for c, hs in enumerate(self.drift_hours):
            padded[c, :len(hs)] = hs
        lifecycle = {
            "teacher_seed": np.asarray(self.teacher_seed, np.int64),
            "program_seed": np.asarray(self.program_seed, np.int64),
            "steps": np.asarray(self.steps, np.int64),
            "drift_hours": padded,
            "drift_counts": np.asarray(counts, np.int64),
        }
        manager.save(step, {"adapters": self.adapters, "opt": self.optimizer_state(),
                            "lifecycle": lifecycle, "proxy_ref": list(self._proxy_ref)},
                     blocking=blocking)
        meta = {
            "format": 1, "backend": self.backend, "arch": getattr(self.cfg, "name", None),
            "n_chips": self.n_chips, "drift_events": counts,
            "fault_events": [[spec.to_dict(), list(chips)] for spec, chips in self.fault_events],
            "device_type": self.device.type, "device_name": device_name(self.device),
            "codes_digest": code_digest(self.codes), "view_digest": code_digest(self.codes_view),
        }
        with open(os.path.join(manager.directory, _FLEET_META), "w") as f:
            json.dump(meta, f)
        return step

    @classmethod
    def restore(cls, cfg, directory, *, step: Optional[int] = None,
                backend: Optional[str] = None, device="cuda") -> "Fleet":
        """Rebuild a fleet from a snapshot: program every chip from the
        recorded seeds on ``device``, replay every chip's drift history in
        its own order (round-robin: chips are independent), re-inject every
        fault event, check the digests, then load the stacked adapters,
        AdamW state, proxy baselines and step counts. ``backend`` overrides
        the recorded one. Raises ``ValueError`` before any work on a
        reference snapshot or one taken on another device type or card
        model, and after the replay when a digest differs."""
        device = resolve_device(device)
        manager, step, meta = open_snapshot(directory, step, _FLEET_META, device)
        n, counts = int(meta["n_chips"]), meta["drift_events"]
        life = manager.restore(step, {"lifecycle": {
            "teacher_seed": np.zeros((), np.int64),
            "program_seed": np.zeros((), np.int64),
            "steps": np.zeros((n,), np.int64),
            "drift_hours": np.zeros((n, max(counts, default=0)), np.float64),
            "drift_counts": np.zeros((n,), np.int64),
        }}, device="cpu")["lifecycle"]
        fleet = cls.program(cfg, (int(life["teacher_seed"]), int(life["program_seed"])),
                            n_chips=n, backend=backend or meta["backend"], device=device)
        padded = life["drift_hours"].numpy()
        for r in range(max(counts, default=0)):
            chips = [c for c in range(n) if counts[c] > r]
            fleet.advance([float(padded[c, r]) for c in chips], chips=chips)
        for spec_dict, chips in meta["fault_events"]:
            fleet.inject(FaultSpec.from_dict(spec_dict), chips=chips)
        check_digests(fleet, meta)
        restored = manager.restore(step, {"adapters": fleet.adapters,
                                          "opt": _adamw_init_stacked(fleet.adapters),
                                          "proxy_ref": fleet._gamma_norms()}, device=device)
        fleet.adapters = restored["adapters"]
        fleet.opt_state = restored["opt"]
        fleet._proxy_ref = list(restored["proxy_ref"])
        fleet.steps = [int(s) for s in life["steps"].tolist()]
        return fleet
