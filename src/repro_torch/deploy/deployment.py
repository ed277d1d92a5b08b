"""``Deployment`` — the lifecycle object from programming to serving.
Port of ``repro/deploy/deployment.py``.

* ``Deployment.program(cfg, seed, backend=..., device=...)`` — init the
  teacher from the seed and program every RRAM leaf (programming-time
  drift included); ``seed`` is an int (teacher ``seed``, codes ``seed +
  1``) or a ``(teacher_seed, program_seed)`` pair (a fleet's chip).
* ``Deployment.from_arrays(...)`` — adopt a teacher, codes and adapters
  made elsewhere (the reference package, through ``interop``); drift
  continues from those codes.
* ``dep.advance(hours)`` — the drift clock; event ``i`` of leaf ``path``
  draws from its own generator, so any history replays from the seed.
* ``dep.inject(faults)`` — device faults (``repro_torch.faults``), a
  lifecycle event like drift: the pristine codes stay as they are and
  every consumer reads ``dep.codes_view``, the codes read back through
  the composite ``FaultMap``, re-derived after every event, so stuck
  cells stay pinned through drift.
* ``dep.calibrate(batch_or_samples)`` — feature-KD calibration of the
  SRAM side-cars (cached teacher features, AdamW over the adapter tree);
  returns a ``CalibrationReport``. It runs under the ``dequant`` backend
  whatever the deployment's (the kernels have no backward), so it
  launches no kernel, and the codes are never written. On the card its
  step is one CUDA graph per call (``CompiledCalibStep``: step 1 eager,
  then a capture, then replays), as the reference jits it once per call.
  With ``registry=`` (``repro_torch.registry``) the run is recorded under
  the deployment's ``drift_signature()``, and ``warm_start=True`` seeds
  the adapters and AdamW state from the nearest stable reference first.
* ``dep.logit_mse(batch)`` — teacher/student logit MSE, the drift gap
  and what calibration recovers of it.
* ``dep.serve(accum=...)`` — merged DoRA magnitudes and, under
  ``codes``, the prepared (fused) serving tree run by the f32 or the
  int8 body; under ``codes_adc`` the raw codes through the ADC kernel.
* ``dep.snapshot(dir)`` / ``Deployment.restore(cfg, dir)`` — adapters,
  AdamW state and the lifecycle record through ``CheckpointManager``;
  the base is never stored: restore re-programs from the seeds, replays
  every drift tick, then re-injects every fault spec. The replay is
  bitwise only where the same generators draw again (the same device
  type and card model), so the snapshot records both and a digest of
  the codes, and restore refuses what it cannot reproduce.

The port runs on the card: ``device`` defaults to ``"cuda"`` and raises
when no card is present; the CPU runs only when asked for.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
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
    calibrated_fraction,
    drift_model,
    merge_adapters_for_serve,
    program_model,
    rram_bytes,
    sram_bytes,
    teacher_features,
)
from repro_torch.data.pipeline import DataConfig, global_batch_at_step
from repro_torch.deploy import serving
from repro_torch.faults.generators import FaultSpec, build_map
from repro_torch.faults.map import FaultMap, compose_maps
from repro_torch.interop import from_reference, to_tensor
from repro_torch.models import transformer as T
from repro_torch.optim.adam import AdamW, adamw_init

Pytree = Any


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no card
    present raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return device


_DEPLOYMENT_META = "deployment.json"
# the golden-ratio multiplier 0x9E3779B97F4A7C15 as a signed int64
_MIX = 0x9E3779B97F4A7C15 - (1 << 64)
_DIGEST_CHUNK = 1 << 24


def _weighted_sum(t: torch.Tensor, salt: int) -> int:
    """``sum_i byte_i * w_i`` mod 2**64 over the bytes of ``t``, each
    ``w_i`` odd and mixed from ``(salt, i)``: a changed byte changes the
    sum. On ``t``'s device, a chunk at a time."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    total = torch.zeros((), dtype=torch.int64, device=b.device)
    for a in range(0, b.numel(), _DIGEST_CHUNK):
        part = b[a:a + _DIGEST_CHUNK]
        w = torch.arange(a, a + part.numel(), dtype=torch.int64, device=b.device)
        w.add_(salt).mul_(_MIX).bitwise_or_(1)
        total += (w * part).sum()
    return int(total)


def code_digest(tree: Pytree) -> str:
    """A digest of every tensor of ``tree`` (a codes tree: the uint8
    codes, their scales and the leaves that pass through): sha1 over each
    tensor's dtype, shape and weighted byte sum, so any changed code
    changes it."""
    h = hashlib.sha1()
    for i, t in enumerate(tree_lib.tensors(tree)):
        s = _weighted_sum(t, (i + 1) << 40)
        h.update(f"{i}:{t.dtype}:{tuple(t.shape)}:{s};".encode())
    return h.hexdigest()


def device_name(device: torch.device) -> str:
    """The card's model for a CUDA device (its draws are bound to it),
    else the device type."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def seed_pair(seed) -> Tuple[int, int]:
    """``(teacher_seed, program_seed)`` from an int seed (``seed``, ``seed +
    1``, the reference's ``(PRNGKey(s), PRNGKey(s + 1))``) or an explicit
    pair (the reference's ``_key_pair``)."""
    if isinstance(seed, (tuple, list)):
        teacher, program = seed
        return int(teacher), int(program)
    return int(seed), int(seed) + 1


def open_snapshot(directory, step: Optional[int], meta_name: str, device):
    """``(manager, step, meta)`` of a snapshot the port wrote on ``device``'s
    type and card model (``step`` None: the latest). Raises before any
    work: ``FileNotFoundError`` without a step, ``ValueError`` on a
    reference snapshot (its lifecycle holds JAX keys), on one without the
    port's meta, or on another device type or card model."""
    manager = as_manager(directory)
    if step is None:
        step = manager.latest_step()
    if step is None:
        raise FileNotFoundError(f"no snapshots in {directory}")
    if "teacher_key" in manager.leaf_names(step, "lifecycle"):
        raise ValueError("this snapshot was written by the reference package: its "
                         "lifecycle holds JAX keys, which the port does not replay")
    meta_path = os.path.join(manager.directory, meta_name)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if "codes_digest" not in meta:
        raise ValueError(f"{meta_path} records no device or digest; the port "
                         "restores only snapshots it wrote")
    where = (meta["device_type"], meta["device_name"])
    if where != (device.type, device_name(device)):
        raise ValueError(
            f"the snapshot was taken on {where[1]} ({where[0]}); its generators do "
            f"not replay bitwise on {device_name(device)} ({device.type})")
    return manager, step, meta


def check_digests(replayed, meta) -> None:
    """Raise ``ValueError`` when the replayed ``codes`` or ``codes_view``
    differ from the snapshot's digests."""
    for what, tree, key in (("codes", replayed.codes, "codes_digest"),
                            ("codes_view", replayed.codes_view, "view_digest")):
        got = code_digest(tree)
        if got != meta[key]:
            raise ValueError(f"the replayed {what} differ from the snapshot's "
                             f"(digest {got}, recorded {meta[key]})")


def _program_trees(cfg, teacher_seed: int, program_seed: int, device):
    """The programming event: the teacher's params from generator
    ``teacher_seed``, their codes from ``program_seed`` (per-leaf
    streams). Returns ``(params, codes)``."""
    params = T.init_params(rram.make_generator(device, teacher_seed), cfg)
    return params, program_model(params["base"], cfg.rram, program_seed, mode="codes")


def _dequant_like(codes: Pytree, like: Pytree) -> Pytree:
    """Codes read back to floats, leaf dtypes taken from ``like``; other
    leaves pass through as the same tensors."""

    def walk(c, w):
        if isinstance(c, rram.CrossbarWeight):
            return rram.dequantize(c, dtype=w.dtype)
        if isinstance(c, dict):
            return {k: walk(v, w[k]) for k, v in c.items()}
        if isinstance(c, list):
            return [walk(v, w[i]) for i, v in enumerate(c)]
        return c

    return walk(codes, like)


def calibration_batch(cfg, batch_or_samples, seq_len: int) -> Dict:
    """The deterministic calibration batch for ``cfg``: a batch dict passes
    through as it is; an int is a calibration-set size (paper: 10
    samples), drawn by the data pipeline at step 0 on the CPU, with an
    encoder-decoder config's encoder inputs at ``seq_len`` frames and a
    vision config's ``vision_tokens`` patches, both in bf16, as the
    reference's. The same arguments always give the same batch."""
    if isinstance(batch_or_samples, dict):
        return batch_or_samples
    n = int(batch_or_samples)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=n,
                      n_calibration_samples=n,
                      enc_src_len=seq_len if cfg.encoder_layers else 0,
                      d_model=cfg.d_model if (cfg.encoder_layers or cfg.vision_tokens) else 0,
                      vision_tokens=cfg.vision_tokens)
    batch = global_batch_at_step(dcfg, 0)
    for name in ("enc_embeds", "patch_embeds"):  # as the reference's batch carries them
        if name in batch:
            batch[name] = batch[name].to(torch.bfloat16)
    return batch


def _device_batch(batch: Dict, device) -> Dict:
    """A batch of tensors or numpy arrays (bfloat16 ones by their bits) on
    ``device``; tokens as int64."""
    out = {k: v.to(device) if isinstance(v, torch.Tensor) else to_tensor(v, device)
           for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@dataclasses.dataclass
class CalibrationReport:
    """Outcome of one ``Deployment.calibrate`` call; ``to_json`` and
    ``from_json`` round-trip it exactly, so the calibration registry keeps
    it verbatim in an artifact's sidecar."""

    losses: List[float]          # per-step feature MSE (Algorithm 1 loss)
    epochs_run: int
    sram_bytes: int              # resident side-car bytes (digital SRAM)
    rram_bytes: int              # resident base bytes (analog array)
    base_params: int
    adapter_params: int
    calibrated_fraction: float   # paper's 2.34% headline
    backend: str
    drift_events: int            # drift-clock ticks seen before this calib
    initial_loss: float = float("nan")
    final_loss: float = float("nan")
    warm_started: bool = False   # adapters seeded from a registry reference
    warm_source: Optional[str] = None  # the seeding artifact ("key@vN")

    def __post_init__(self):
        if self.losses and math.isnan(self.initial_loss):
            self.initial_loss = float(self.losses[0])
        if self.losses and math.isnan(self.final_loss):
            self.final_loss = float(self.losses[-1])

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "CalibrationReport":
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "CalibrationReport":
        return cls.from_dict(json.loads(payload))

    def summary(self) -> str:
        return (
            f"calibrated {self.epochs_run} epochs: feature MSE "
            f"{self.initial_loss:.6f} -> {self.final_loss:.6f} | "
            f"sram_bytes={self.sram_bytes} "
            f"({self.calibrated_fraction:.2%} of params) "
            f"rram_bytes={self.rram_bytes} backend={self.backend}"
        )


class Deployment:
    """One RRAM deployment over its lifetime. ``self.codes`` (uint8,
    pristine) is the drift clock's ground truth; ``self.codes_view`` is
    them read back through the fault map; ``self.base`` is what forwards
    consume — the view under ``codes`` and ``codes_adc``, its float
    read-back under ``dequant``."""

    def __init__(self, cfg, backend: str, teacher_base: Pytree, codes: Pytree,
                 adapters: Pytree, teacher_seed: int, program_seed: int,
                 drift_hours: Sequence[float] = ()):
        if backend not in serving.BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; available: {serving.BACKENDS}")
        self.cfg = cfg
        self.backend = backend
        self.teacher_base = teacher_base
        self.codes = codes
        self.adapters = adapters
        self.teacher_seed = int(teacher_seed)
        self.program_seed = int(program_seed)
        self.drift_hours: List[float] = [float(h) for h in drift_hours]
        self.opt_state = None
        self.step: int = 0
        self.fault_specs: List[FaultSpec] = []
        self._fault_map: Optional[FaultMap] = None
        # the first event whose draws no seed replays (snapshot refuses)
        self._unreplayable: Optional[str] = None
        self._teacher_logits_cache = None
        self._stream = None
        self._refresh_base()

    @property
    def device(self) -> torch.device:
        return self.teacher_base["embed"]["embedding"].device

    @classmethod
    def program(cls, cfg, seed=0, *, backend: str = "dequant",
                adapters: Optional[Pytree] = None,
                device="cuda") -> "Deployment":
        """The programming event: the teacher from generator ``seed``,
        the codes from ``seed + 1`` (per-leaf streams); a pair
        ``(teacher_seed, program_seed)`` gives both (``Fleet.chip_seed``)."""
        teacher_seed, program_seed = seed_pair(seed)
        params, codes = _program_trees(cfg, teacher_seed, program_seed,
                                       resolve_device(device))
        return cls(cfg, backend, params["base"], codes,
                   params["adapters"] if adapters is None else adapters,
                   teacher_seed=teacher_seed, program_seed=program_seed)

    @classmethod
    def from_arrays(cls, cfg, teacher_base, codes, adapters, *,
                    backend: str = "codes", seed: int = 0,
                    drift_hours: Sequence[float] = (),
                    device="cuda") -> "Deployment":
        """A deployment over trees made elsewhere, given as numpy trees in
        the reference layout (``interop.from_reference``). ``drift_hours``
        is the drift history those codes already carry, so the field
        clock continues from it; later drift events draw from the port's
        streams for ``seed``. No seed replays those codes, so such a
        deployment cannot be snapshotted."""
        device = resolve_device(device)
        dep = cls(cfg, backend, from_reference(teacher_base, device),
                  from_reference(codes, device), from_reference(adapters, device),
                  teacher_seed=seed, program_seed=seed + 1,
                  drift_hours=drift_hours)
        dep._unreplayable = "Deployment.from_arrays (codes made elsewhere)"
        return dep

    def _refresh_base(self):
        # self.codes stays pristine; consumers read the faulty view,
        # derived anew after every programming, drift or injection event.
        # New tensors every time: a session made before keeps its params.
        self.codes_view = substrate.faulted_codes(self.codes, self._fault_map,
                                                  self.cfg.rram)
        if self.backend == "dequant":
            self.base = _dequant_like(self.codes_view, self.teacher_base)
        else:
            self.base = self.codes_view

    @property
    def field_hours(self) -> float:
        return float(sum(self.drift_hours))

    def advance(self, hours: float) -> "Deployment":
        """Let ``hours`` of field time pass: the codes re-drift by the
        variance increment over the cumulative clock, never rewritten.
        ``hours=0`` is a no-op; negative hours raise."""
        hours = float(hours)
        if hours < 0:
            raise ValueError(f"drift clock cannot run backwards (hours={hours})")
        if hours == 0.0:
            return self
        self.codes = drift_model(
            self.codes, self.cfg.rram, self.program_seed, hours=hours,
            event_index=len(self.drift_hours), clock_offset=self.field_hours,
        )
        self.drift_hours.append(hours)
        self._refresh_base()
        return self

    # -- fault injection ------------------------------------------------------

    def inject(self, faults: Union[FaultSpec, Sequence[FaultSpec]], *,
               draws=None) -> "Deployment":
        """Inject device faults (a ``FaultSpec`` or a sequence), recorded
        in ``fault_specs``. The new specs' maps are composed into the
        current one: the join is associative, commutative and idempotent,
        so this is bitwise the reference's rebuild from every recorded
        spec, and re-injecting a spec changes nothing. ``draws`` gives one
        spec's per-leaf uniforms ``{path: (up, un)}`` (a sequence of them,
        or ``None`` entries, for a sequence of specs); without them each
        leaf draws from its spec's stream. The pristine codes are not
        touched. Draws passed in are replayed by no seed, so a deployment
        given them cannot be snapshotted."""
        one = isinstance(faults, FaultSpec)
        specs = [faults] if one else list(faults)
        per = [None] * len(specs) if draws is None else ([draws] if one else list(draws))
        if len(per) != len(specs):
            raise ValueError(f"{len(per)} draws for {len(specs)} fault specs")
        new = compose_maps(build_map(self.codes, s, self.cfg.rram, draws=d)
                           for s, d in zip(specs, per))
        self.fault_specs.extend(specs)
        if self._unreplayable is None and any(d is not None for d in per):
            self._unreplayable = "Deployment.inject(draws=...) (draws passed in)"
        self._fault_map = compose_maps([self._fault_map, new])
        self._refresh_base()
        return self

    # -- calibration ----------------------------------------------------------

    def calib_state(self) -> CalibState:
        """The whole-model calibration state over this deployment's
        resident base; ``adopt`` syncs a result back."""
        if self.opt_state is None:
            self.opt_state = adamw_init(self.adapters)
        return CalibState(self.teacher_base, self.base, self.adapters,
                          self.opt_state, self.step)

    def adopt(self, state: CalibState) -> "Deployment":
        """Take adapters, optimizer state and step from a ``CalibState``."""
        self.adapters = state.adapters
        self.opt_state = state.opt_state
        self.step = int(state.step)
        return self

    def _calib_stream(self):
        """The card's stream for calibration warm-ups and captures, one per
        deployment (cuBLAS keeps a workspace per stream); None on the CPU."""
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def calibrate(
        self, batch_or_samples: Union[Dict, int] = 10, *,
        steps: int = 20, lr: float = 1e-3, opt: Optional[AdamW] = None,
        seq_len: int = 32, cached_teacher: Optional[bool] = None,
        loss_threshold: float = 0.0, registry=None, warm_start: bool = False,
        record: bool = True,
    ) -> CalibrationReport:
        """Algorithm 1 over the whole model: train only the SRAM side-cars
        against the frozen teacher, on the current (drifted) base.
        ``batch_or_samples`` is a batch dict or a calibration-set size
        (paper: 10 samples of ``seq_len`` tokens). Teacher features are
        cached once per call unless ``cached_teacher=False``. A
        codes-resident base runs under the differentiable ``dequant``
        backend, so no kernel launches and the codes stay as they are.
        Every step goes through one ``CompiledCalibStep``: on the card its
        first step runs eagerly, the second captures it into a CUDA graph,
        the rest replay it; the graph and its pool are released before the
        call returns. The optimizer state carries over to the next call;
        the adapters left on the deployment are copies that require no
        grad.

        With ``registry`` (a ``CalibrationRegistry``) the run is recorded
        afterwards as the next version under this deployment's ``(cfg,
        backend, drift_signature())`` key (``record=False`` skips it) and
        checked against the key's reference; with ``warm_start=True`` the
        adapters and the AdamW state are first seeded from the nearest
        stable reference (cold when the registry has none), and the report
        names it (``warm_source``)."""
        cfg = self.cfg
        opt = opt if opt is not None else AdamW(lr=lr)
        warm = None
        if registry is not None and warm_start:
            from repro_torch.registry.warmstart import seed_deployment

            warm = seed_deployment(self, registry)
        batch = _device_batch(calibration_batch(cfg, batch_or_samples, seq_len),
                              self.device)
        use_cached = True if cached_teacher is None else bool(cached_teacher)
        state = self.calib_state()
        backend_ctx = (substrate.use_backend("dequant") if self.backend != "dequant"
                       else contextlib.nullcontext())
        losses: List[float] = []
        with backend_ctx:
            feats = teacher_features(self.teacher_base, batch, cfg) if use_cached else None
            step = CompiledCalibStep(cfg, opt, state, batch, feats,
                                     stream=self._calib_stream())
            try:
                for _ in range(steps):
                    losses.append(float(step()["loss"]))
                    if loss_threshold and losses[-1] <= loss_threshold:
                        break
                state = step.state()
            finally:
                step.release()
        self.adopt(state)
        n_base, n_adapters = T.count_params({"base": self.base, "adapters": self.adapters})
        report = CalibrationReport(
            losses=losses, epochs_run=len(losses),
            sram_bytes=sram_bytes(self.adapters), rram_bytes=rram_bytes(self.base),
            base_params=n_base, adapter_params=n_adapters,
            calibrated_fraction=n_adapters / max(n_base, 1),
            backend=self.backend, drift_events=len(self.drift_hours),
            warm_started=warm is not None, warm_source=None if warm is None else warm.name,
        )
        if registry is not None and record:
            registry.record(cfg, self.backend, self.drift_signature(), adapters=self.adapters,
                            opt_state=self.opt_state, report=report)
        return report

    def drift_signature(self) -> np.ndarray:
        """This deployment's registry signature: the device feature (from
        the programming seed) and its drift and fault state
        (``registry/warmstart.drift_signature``)."""
        from repro_torch.registry.warmstart import drift_signature

        return drift_signature(self.cfg.rram, self.program_seed, field_hours=self.field_hours,
                               drift_events=len(self.drift_hours),
                               fault_events=len(self.fault_specs))

    def reset_adapters(self) -> "Deployment":
        """Discard the side-cars back to the fresh (output-preserving)
        init that ``program`` made from the teacher seed, and clear the
        optimizer. The codes and the drift clock are untouched."""
        params = T.init_params(rram.make_generator(self.device, self.teacher_seed),
                               self.cfg)
        self.adapters = params["adapters"]
        self.opt_state = None
        self.step = 0
        return self

    def _teacher_logits(self, batch: Dict) -> torch.Tensor:
        # The teacher is frozen: repeated logit_mse calls on one batch reuse
        # one forward. The cache holds the batch's values, so identity is a
        # sound key.
        leaves = tuple(batch[k] for k in sorted(batch))
        cached = self._teacher_logits_cache
        if cached is not None and len(cached[0]) == len(leaves) and all(
                a is b for a, b in zip(cached[0], leaves)):
            return cached[1]
        with torch.no_grad():
            t = T.forward({"base": self.teacher_base, "adapters": {}},
                          _device_batch(batch, self.device), self.cfg,
                          use_adapters=False).to(torch.float32)
        self._teacher_logits_cache = (leaves, t)
        return t

    def logit_mse(self, batch: Dict, *, use_adapters: bool = True) -> float:
        """Teacher/student logit MSE on ``batch`` under this deployment's
        backend: the drift gap (``use_adapters=False``) and what the
        side-cars recover of it."""
        t = self._teacher_logits(batch)
        with serving.backend_scope(self.backend, self.cfg), torch.no_grad():
            s = T.forward({"base": self.base,
                           "adapters": self.adapters if use_adapters else {}},
                          _device_batch(batch, self.device), self.cfg,
                          use_adapters=use_adapters).to(torch.float32)
        return float(torch.mean((t - s) ** 2))

    # -- persistence ----------------------------------------------------------

    def snapshot(self, directory_or_manager, *, blocking: bool = True) -> int:
        """Checkpoint the mutable lifecycle state through
        ``CheckpointManager`` (atomic, retained, optionally async):
        ``adapters``, ``opt`` (initialised if None) and ``lifecycle``
        (``teacher_seed``, ``program_seed``, ``drift_hours`` f64) at
        ``step``, and ``deployment.json`` beside the steps: the
        reference's keys (``format``, ``backend``, ``arch``,
        ``drift_events``, ``fault_events``) and what a bitwise replay
        needs: the device type, the card's model, and a digest of the
        pristine codes and of ``codes_view``. The base is not stored.
        Raises ``ValueError`` on a deployment holding draws no seed
        replays (``from_arrays``, ``inject(draws=...)``)."""
        if self._unreplayable is not None:
            raise ValueError(
                f"cannot snapshot this deployment: {self._unreplayable} holds draws "
                "that no seed replays, so restore could not re-derive its codes")
        manager = as_manager(directory_or_manager)
        if self.opt_state is None:
            self.opt_state = adamw_init(self.adapters)
        step = int(self.step)
        lifecycle = {
            "teacher_seed": np.asarray(self.teacher_seed, np.int64),
            "program_seed": np.asarray(self.program_seed, np.int64),
            "drift_hours": np.asarray(self.drift_hours, np.float64),
        }
        manager.save(step, {"adapters": self.adapters, "opt": self.opt_state,
                            "lifecycle": lifecycle}, blocking=blocking)
        meta = {
            "format": 1, "backend": self.backend,
            "arch": getattr(self.cfg, "name", None),
            "drift_events": len(self.drift_hours),
            "fault_events": [spec.to_dict() for spec in self.fault_specs],
            "device_type": self.device.type,
            "device_name": device_name(self.device),
            "codes_digest": code_digest(self.codes),
            "view_digest": code_digest(self.codes_view),
        }
        with open(os.path.join(manager.directory, _DEPLOYMENT_META), "w") as f:
            json.dump(meta, f)
        return step

    @classmethod
    def restore(cls, cfg, directory, *, step: Optional[int] = None,
                backend: Optional[str] = None, device="cuda") -> "Deployment":
        """Rebuild a deployment from a snapshot: re-program from the
        recorded seeds on ``device``, replay the drift history tick by
        tick (a 0.0 entry appends without drawing, so later ticks keep
        their event index), re-inject the recorded fault specs after it
        (a map reads shapes only, so faults commute with drift), then load
        adapters, AdamW state and ``step``. ``backend`` overrides the
        recorded binding. Raises ``ValueError`` before any work on a
        snapshot written by the reference (its lifecycle holds JAX keys)
        or on another device type or card model, and after the replay when
        the codes or the view differ from the snapshot's digest."""
        device = resolve_device(device)
        manager, step, meta = open_snapshot(directory, step, _DEPLOYMENT_META, device)
        backend = backend or meta.get("backend", "dequant")
        life = manager.restore(step, {"lifecycle": {
            "teacher_seed": np.zeros((), np.int64),
            "program_seed": np.zeros((), np.int64),
            "drift_hours": np.zeros((meta["drift_events"],), np.float64),
        }}, device="cpu")["lifecycle"]
        teacher_seed, program_seed = int(life["teacher_seed"]), int(life["program_seed"])
        params, codes = _program_trees(cfg, teacher_seed, program_seed, device)
        dep = cls(cfg, backend, params["base"], codes, params["adapters"],
                  teacher_seed=teacher_seed, program_seed=program_seed)
        for hours in life["drift_hours"].tolist():
            if hours == 0.0:
                dep.drift_hours.append(0.0)
            else:
                dep.advance(hours)
        if meta["fault_events"]:
            dep.inject([FaultSpec.from_dict(d) for d in meta["fault_events"]])
        check_digests(dep, meta)
        restored = manager.restore(step, {"adapters": dep.adapters,
                                          "opt": adamw_init(dep.adapters)}, device=device)
        dep.adapters = restored["adapters"]
        dep.opt_state = restored["opt"]
        dep.step = int(step)
        return dep

    # -- serving --------------------------------------------------------------

    def serve(self, *, accum: str = "f32", mesh=None) -> serving.ServeSession:
        """Merge the DoRA magnitudes (Algorithm 2 line 12) and bind a
        session. Under ``codes`` the params are the prepared tree (q/k/v
        and gate/up fused into single launches) and ``accum`` ("f32" or
        "int8") picks the kernel body; other backends ignore it. Under
        ``codes_adc`` the params hold the raw per-leaf codes.

        ``mesh`` (a ``launch.mesh.Mesh`` holding this rank) binds the
        session tensor-parallel: every rank of the mesh calls it, keeps
        the column blocks of the column-shardable prepared leaves for its
        place on the ``"model"`` axis, and the session's steps gather the
        columns (bitwise the single-device session). Codes backend only;
        ``session.reshard`` re-binds after an elastic degradation."""
        if accum not in ("f32", "int8"):
            raise ValueError(f"accum must be 'f32' or 'int8', got {accum!r}")
        if mesh is not None and self.backend != "codes":
            raise ValueError(
                f"mesh serving runs the prepared codes fast path; "
                f"backend={self.backend!r} is single-device")
        options = {}
        with torch.no_grad():
            merged = merge_adapters_for_serve(self.base, self.adapters)
            base = self.base
            if self.backend == "codes":
                base = substrate.prepare_base_for_serve(self.base, merged, self.cfg)
                options["accum"] = accum
        return serving.ServeSession(self, {"base": base, "adapters": merged},
                                    options=options, mesh=mesh)

    def rram_bytes(self) -> int:
        return rram_bytes(self.base)

    def sram_bytes(self) -> int:
        return sram_bytes(self.adapters)

    def calibrated_fraction(self) -> float:
        return calibrated_fraction(self.base, self.adapters)
