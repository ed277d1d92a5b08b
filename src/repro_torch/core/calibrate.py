"""Programming, drift, feature-KD calibration (paper Algorithm 1 + 2) and
serve-time merging over whole model trees. Port of
``repro/core/calibrate.py``.

Calibration is autograd over plain PyTorch ops: it runs under the
``dequant`` backend (the kernels have no backward), and only the adapter
tree receives gradients. ``make_cached_calib_step`` matches each student
block against cached teacher features; ``make_calib_step`` runs the
teacher beside the student (``transformer.feature_calibration_loss``).
Both losses have the same terms and divisor, so the two follow one
trajectory. ``CompiledCalibStep`` runs either step over static buffers,
as one CUDA graph on the card (the reference jits them).

Per-leaf streams: leaf ``path`` of a deployment with seed ``s`` draws its
programming noise from ``make_generator(s, crc32(path), 0)`` and drift
event ``i`` from ``make_generator(s, crc32(path), i + 1)`` — independent
per leaf and per event, replayable from the seed alone.
"""
from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import dora as dora_lib
from repro_torch.core import rram
from repro_torch.core.rram import RramConfig
from repro_torch.models.moe import _stacked_column_norm
from repro_torch.optim.adam import (
    AdamW,
    AdamState,
    adam_betas,
    adamw_init,
    adamw_update,
    adamw_update_,
)

Pytree = Any

# Leaf names that live in RRAM (weights that participate in MVMs).
RRAM_LEAF_NAMES = ("w", "gate_w", "up_w", "down_w")
# the MoE expert stacks among them (models/moe.py)
EXPERT_STACKS = ("gate_w", "up_w", "down_w")


def _per_matrix_leaf(path, x) -> bool:
    """A scan-stacked expert stack, (G, E, d, k): programmed and drifted
    one matrix at a time."""
    t = x.g_pos if isinstance(x, rram.CrossbarWeight) else x
    return bool(path) and path[-1] in EXPERT_STACKS and t.dim() == 4


def _is_rram_leaf(path) -> bool:
    return bool(path) and path[-1] in RRAM_LEAF_NAMES


def _crc(path) -> int:
    return zlib.crc32(tree_lib.path_str(path).encode())


def program_model(base: Pytree, cfg: RramConfig, seed: int, *,
                  mode: str = "codes",
                  noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
                  ) -> Pytree:
    """Program + drift every RRAM-resident leaf; returns the student base.
    ``mode="codes"`` keeps uint8 ``CrossbarWeight`` leaves (stacked
    scan-group leaves included); ``"dequant"`` reads them back to the
    leaf's float dtype. ``noise`` maps each leaf's path to its drift
    normals ``(n_pos, n_neg)``, in place of its stream."""
    if mode not in ("dequant", "codes"):
        raise ValueError(f"mode must be 'dequant' or 'codes', got {mode!r}")

    def leaf(path, x):
        if not _is_rram_leaf(path):
            return x
        per_matrix = _per_matrix_leaf(path, x)
        if noise is not None:
            return program_leaf(x, cfg, None, mode=mode, noise=noise[tree_lib.path_str(path)],
                                per_matrix=per_matrix)
        g = rram.make_generator(x.device, seed, _crc(path), 0)
        return program_leaf(x, cfg, g, mode=mode, per_matrix=per_matrix)

    return tree_lib.map_with_path(leaf, base)


def program_leaf(w: torch.Tensor, cfg: RramConfig, generator: Optional[torch.Generator],
                 *, mode: str = "codes",
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 per_matrix: bool = False):
    """Program ONE RRAM leaf. Stacked leaves (G, d, k), and conv leaves
    (kh, kw, cin, cout), program per matrix (the absmax is per column of
    each matrix) with one draw for the stack. ``per_matrix`` (scan-stacked
    expert stacks, (G, E, d, k)) programs one matrix at a time, each with
    its own draw from ``generator`` in order (the reference splits its key
    per matrix), so no f32 copy of a whole stack is made; ``noise`` is
    then the leaf's, indexed per matrix."""
    if per_matrix:
        def one(m, n):
            return program_leaf(m, cfg, generator, mode=mode, noise=n)

        return _per_matrix(w, one, noise)
    xw = rram.programmed_codes(w, cfg, generator, noise=noise)
    if mode == "codes":
        return xw
    return rram.dequantize(xw, dtype=w.dtype)


def _per_matrix(x, fn, noise=None):
    """``fn(matrix, its noise or None)`` over the matrices of a 4-D leaf
    (a float stack or a ``CrossbarWeight``), assembled into the leaf's
    shape: codes into one ``CrossbarWeight``, floats into one tensor."""
    codes = isinstance(x, rram.CrossbarWeight)
    shape = tuple((x.g_pos if codes else x).shape)
    lead = shape[:-2]
    out = None
    for idx in itertools.product(*(range(n) for n in lead)):
        mat = tree_lib.index(x, idx) if codes else x[idx]
        got = fn(mat, None if noise is None else (noise[0][idx], noise[1][idx]))
        if out is None:
            out = (rram.CrossbarWeight(
                       g_pos=got.g_pos.new_empty(shape), g_neg=got.g_neg.new_empty(shape),
                       scale=got.scale.new_empty(lead + tuple(got.scale.shape)))
                   if isinstance(got, rram.CrossbarWeight) else got.new_empty(shape))
        if isinstance(got, rram.CrossbarWeight):
            out.g_pos[idx].copy_(got.g_pos)
            out.g_neg[idx].copy_(got.g_neg)
            out.scale[idx].copy_(got.scale)
        else:
            out[idx].copy_(got)
    return out


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

        def drift(xw, _=None):
            return rram.apply_drift(xw, cfg, g, hours=hours, clock_offset=clock_offset,
                                    sigma=sigma)

        return _per_matrix(x, drift) if _per_matrix_leaf(path, x) else drift(x)

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


def merge_adapters_for_serve(base: Pytree, adapters: Pytree) -> Pytree:
    """Algorithm 2 line 12 over a whole model: every ``dora_m`` becomes
    ``dora_m_merged = M / ||W_r + A@B||_col``. Stacked adapters (lora_b
    (E, r, k): experts or scan groups) take the stacked norm; scan-stacked
    expert stacks (lora_b (G, E, r, k)) take it per scan group (the
    reference's ``vmap``), reading back one group of codes at a time."""

    def walk(b, a):
        if isinstance(a, dict) and "lora_a" in a:
            if "dora_m" not in a:
                return a
            w = b["w"] if isinstance(b, dict) and "w" in b else b
            m = a["dora_m"].to(torch.float32)
            lb = a["lora_b"]
            if lb.dim() == 4:
                norm = torch.stack([
                    _stacked_column_norm(tree_lib.index(w, g), a["lora_a"][g], lb[g])
                    for g in range(lb.shape[0])])
            else:
                if isinstance(w, rram.CrossbarWeight):
                    w = rram.dequantize(w)
                if lb.dim() == 2:
                    norm = dora_lib.column_norm(w, a["lora_a"], lb)
                else:
                    norm = _stacked_column_norm(w, a["lora_a"], lb)
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


# ---------------------------------------------------------------------------
# autograd over an adapter tree
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn: Callable[[Pytree], torch.Tensor], adapters: Pytree):
    """``(loss, grads)`` of ``loss_fn(adapters)`` w.r.t. every tensor of the
    adapter tree (``jax.value_and_grad``'s counterpart): the grads tree has
    the adapters' structure, zeros where a leaf takes no part. The caller's
    tensors are not modified; ``loss`` is detached."""
    leaves = [t.detach().requires_grad_(True) for t in tree_lib.tensors(adapters)]
    with torch.enable_grad():
        loss = loss_fn(tree_lib.unflatten(adapters, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), tree_lib.unflatten(adapters, grads)


# ---------------------------------------------------------------------------
# literal per-layer calibration loop (Algorithm 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerCalibResult:
    losses: list
    epochs_run: int


def calibrate_layer(
    layer_fn: Callable[[Pytree, Pytree, torch.Tensor], torch.Tensor],
    student_layer_base: Pytree,
    adapter: Pytree,
    teacher_in: torch.Tensor,
    teacher_out: torch.Tensor,
    *,
    opt: AdamW = AdamW(lr=1e-3),
    max_epochs: int = 20,
    loss_threshold: float = 0.0,
    batch_size: Optional[int] = None,
) -> Tuple[Pytree, LayerCalibResult]:
    """Algorithm 1 lines 5-10 for one layer: ``layer_fn(base, adapter, x)
    -> y`` against cached teacher features ``teacher_in/out`` (N leading);
    ``max_epochs`` epochs of full-batch Adam (``batch_size`` restores
    per-sample updates), stopping once an epoch's loss is at most
    ``loss_threshold``."""
    opt_state = adamw_init(adapter)

    def loss_fn(ad, x, y):
        d = layer_fn(student_layer_base, ad, x).to(torch.float32) - y.to(torch.float32)
        return torch.mean(d * d)

    n = teacher_in.shape[0]
    bs = batch_size or n
    losses = []
    epochs_run = 0
    for epoch in range(max_epochs):
        epoch_loss = 0.0
        for i in range(0, n, bs):
            x, y = teacher_in[i:i + bs], teacher_out[i:i + bs]
            loss, grads = value_and_grad(lambda ad: loss_fn(ad, x, y), adapter)
            adapter, opt_state = adamw_update(grads, opt_state, adapter, opt)
            epoch_loss += float(loss) * min(bs, n - i)
        epoch_loss /= n
        losses.append(epoch_loss)
        epochs_run = epoch + 1
        if epoch_loss <= loss_threshold:
            break
    return adapter, LayerCalibResult(losses=losses, epochs_run=epochs_run)


# ---------------------------------------------------------------------------
# whole-model calibration (LM stacks)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CalibState:
    """(teacher_base, student_base, adapters, opt_state, step): what one
    calibration step reads and returns."""

    teacher_base: Pytree
    student_base: Pytree
    adapters: Pytree
    opt_state: AdamState
    step: int


@torch.no_grad()
def teacher_features(teacher_base: Pytree, batch: Dict, cfg) -> Dict[str, torch.Tensor]:
    """Algorithm 1 line 3: run the frozen teacher once over the
    calibration batch and keep every block's input and the last block's
    output: ``"dec"`` (L+1, B, S, d) in the config's dtype (a vision
    config's S counts the P patches ahead of the tokens, which every block
    reads under the prefix-LM mask); for an
    encoder-decoder config also ``"enc"`` (Le+1, B, S_src, d), the encoder
    blocks' inputs and the last one's (pre-norm) output, and ``"enc_out"``
    (B, S_src, d), the normed output every decoder block reads; for an
    untied head also ``"head_in"`` (the final norm's output) and
    ``"head_out"`` (the teacher logits)."""
    from repro_torch.models import transformer as T

    h = T.L.embed(batch["tokens"], teacher_base["embed"],
                  scale_by_sqrt_dim=cfg.embed_scale)
    h, mask, _ = T._with_patches(h, T._batch_patches(batch, cfg))
    positions = torch.arange(h.shape[1], device=h.device)[None]
    out = {}
    enc_out = None
    if cfg.encoder_layers:
        he = batch["enc_embeds"].to(h.dtype)
        enc_mask, enc_pos = T._enc_inputs(he)
        enc = [he]
        for b, _ in T._enc_layers(teacher_base, {}, cfg):
            he = T.block_forward(he, b, {}, cfg, "attn", "mlp", positions=enc_pos,
                                 mask=enc_mask)
            enc.append(he)
        enc_out = T._norm(he, teacher_base["enc_norm"], cfg)
        out["enc"], out["enc_out"] = torch.stack(enc), enc_out
    feats = [h]
    for _, b, _, (mixer, ffn) in T._layers(teacher_base, T._empty_adapters(teacher_base),
                                           cfg):
        h = T.block_forward(h, b, {}, cfg, mixer, ffn, positions=positions, mask=mask,
                            enc_out=enc_out)
        feats.append(h)
    out["dec"] = torch.stack(feats)
    if not cfg.tie_lm_head:
        hn = T._norm(h, teacher_base["final_norm"], cfg)
        out["head_in"] = hn
        out["head_out"] = T.L.linear(hn, teacher_base["lm_head"], {}, cfg.adapter)
    return out


def make_cached_calib_loss(cfg):
    """The cached-teacher loss ``loss_fn(adapters, student_base, feats,
    batch)``: student block ``l`` sees ``feats["dec"][l]`` (an encoder
    block ``feats["enc"][l]``) and matches the teacher's output at ``l +
    1``; decoder blocks cross-attend to ``feats["enc_out"]``. It mirrors
    ``feature_calibration_loss`` term for term (the encoder's blocks, the
    decoder's, then the untied lm_head's logits), averaged over the same
    ``n_terms``. ``batch`` gives only a vision config's patch count (a
    static shape), which places the prefix-LM mask."""
    from repro_torch.models import transformer as T

    def loss_fn(adapters, sbase, feats, batch):
        dec = feats["dec"]
        positions = torch.arange(dec.shape[2], device=dec.device)[None]
        patches = T._batch_patches(batch, cfg)
        mask = None if patches is None else T._prefix_mask(dec.shape[2], patches.shape[1],
                                                           dec.device)
        loss = torch.zeros((), dtype=torch.float32, device=dec.device)
        n_terms = 0
        enc_out = feats.get("enc_out")
        if cfg.encoder_layers:
            enc = feats["enc"]
            enc_mask, enc_pos = T._enc_inputs(enc[0])
            for e, (b, a_) in enumerate(T._enc_layers(sbase, adapters, cfg)):
                s_out = T.block_forward(enc[e], b, a_, cfg, "attn", "mlp", positions=enc_pos,
                                        mask=enc_mask)
                loss = loss + T._mse(enc[e + 1], s_out)
            n_terms += cfg.encoder_layers
        for i, b, a_, (mixer, ffn) in T._layers(sbase, adapters, cfg):
            s_out = T.block_forward(dec[i], b, a_, cfg, mixer, ffn, positions=positions,
                                    mask=mask, enc_out=enc_out)
            loss = loss + T._mse(dec[i + 1], s_out)
            n_terms += 1
        if not cfg.tie_lm_head:
            s_logits = T.L.linear(feats["head_in"], sbase["lm_head"],
                                  adapters.get("lm_head"), cfg.adapter)
            loss = loss + T._mse(feats["head_out"], s_logits)
            n_terms += 1
        return loss / n_terms

    return loss_fn


def _advance(state: CalibState, grads: Pytree, opt: AdamW) -> CalibState:
    adapters, opt_state = adamw_update(grads, state.opt_state, state.adapters, opt)
    return CalibState(state.teacher_base, state.student_base, adapters, opt_state,
                      state.step + 1)


def make_cached_calib_step(cfg, opt: AdamW = AdamW(lr=1e-3)):
    """One step against cached teacher features: loss, gradients over the
    adapter leaves, ``adamw_update``. Teacher forward cost: 0."""
    loss_fn = make_cached_calib_loss(cfg)

    def step(state: CalibState, feats, batch):
        loss, grads = value_and_grad(
            lambda ad: loss_fn(ad, state.student_base, feats, batch), state.adapters)
        return _advance(state, grads, opt), {"loss": loss}

    return step


def make_calib_step(cfg, opt: AdamW = AdamW(lr=1e-3)):
    """One step of the fused loss (teacher and student blocks interleaved)."""
    from repro_torch.models import transformer as T

    def step(state: CalibState, batch: Dict):
        metrics = {}

        def loss_fn(adapters):
            loss, aux = T.feature_calibration_loss(
                state.teacher_base, state.student_base, adapters, batch, cfg)
            metrics.update({k: v.detach() for k, v in aux.items()})
            return loss

        loss, grads = value_and_grad(loss_fn, state.adapters)
        metrics["loss"] = loss
        return _advance(state, grads, opt), metrics

    return step


# ---------------------------------------------------------------------------
# the compiled calibration step (the reference's jitted step)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Member:
    """One student of a ``CompiledCalibStep``: its frozen base, its static
    adapter leaves (and the tree over them), its AdamW state, its step at
    the start, and the zeros made once for leaves that take no part."""

    student_base: Pytree
    leaves: list
    adapters: Pytree
    opt_state: AdamState
    start: int
    zeros: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)


class CompiledCalibStep:
    """One calibration step over static buffers: the counterpart of
    ``jax.jit(make_cached_calib_step(cfg, opt))`` (``feats`` given) and of
    ``jax.jit(make_calib_step(cfg, opt))`` (``feats=None``) in the
    reference's ``Deployment.calibrate``, with the same arithmetic.

    It owns its adapter leaves (copies of ``state.adapters`` in the tree's
    layout, scan-group stacking included, that require grad) and its AdamW
    state (copies of ``state.opt_state``, the count on the device). It
    reads the frozen inputs in place: the student base, ``batch`` (an
    encoder-decoder config's encoder inputs among them), and ``feats``
    (cached; the encoder's features among them) or the teacher base
    (fused); their addresses and
    the substrate's backend key are recorded when it is built and checked
    at every call, since a graph would read stale operands. A call is the
    loss over the static leaves under grad mode, ``torch.autograd.grad``
    (zeros, made once, for a leaf that takes no part), then
    ``adamw_update_`` into the static state; it returns the static metrics
    (``"loss"``, and ``"feature_mse"`` for the fused loss), valid until the
    next call.

    ``state`` may also be a list of states over one teacher (a fleet's
    chips, each with its own student base, adapters and AdamW state): a
    call then runs each member's step in turn, the very operations of its
    step alone, so each member's trajectory is bitwise its own step's, and
    the metrics hold one value per member. One graph holds every member's
    step, and a member's intermediates are freed before the next one's
    are made.

    On the CPU every call runs the step. On the card the first call runs
    it eagerly on ``stream``, after the current stream's work: the real
    first step, which also fills lazily made caches (``rope_frequencies``,
    cuBLAS's workspace for the stream) outside any capture; autograd runs
    the backward on the forward's stream. The second call captures the
    step on ``stream`` into a CUDA graph with a private memory pool, then
    replays it on the current stream, as every later call does; so a run
    of one step captures nothing. An error in the warm-up or the capture
    propagates, and after a failed capture every call raises: nothing
    runs eagerly instead. Capturing launches no kernel and counts none
    (``graphs.capture``); calibration runs under ``dequant``, so a step
    launches none. ``state()`` returns detached copies of the trained
    adapters and AdamW state (a list of states for a list);
    ``release()`` drops the graph and its pool.
    """

    def __init__(self, cfg, opt: AdamW, state, batch: Dict,
                 feats: Optional[Dict[str, torch.Tensor]] = None, *,
                 stream: Optional["torch.cuda.Stream"] = None):
        from repro_torch import substrate
        from repro_torch.models import transformer as T

        self.opt = opt
        self.batched = isinstance(state, (list, tuple))
        states = list(state) if self.batched else [state]
        tbase = states[0].teacher_base
        self.teacher_base = tbase
        self.batch, self.feats = batch, feats
        self.members = []
        for st in states:
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in tree_lib.tensors(st.adapters)]
            self.members.append(_Member(
                st.student_base, leaves, tree_lib.unflatten(st.adapters, leaves),
                AdamState(*(tree_lib.map_tensors(torch.clone, s) for s in st.opt_state)),
                st.step))
        if not self.batched:
            one = self.members[0]
            self.student_base, self.start = one.student_base, one.start
            self.leaves, self.adapters, self.opt_state = one.leaves, one.adapters, one.opt_state
        self.calls = 0
        self.device = self.members[0].opt_state.step.device
        self.betas = adam_betas(opt, self.device)
        if feats is not None:
            cached = make_cached_calib_loss(cfg)
            self._loss = lambda sbase, ad: (cached(ad, sbase, feats, batch), {})
            keys = ("loss",)
        else:
            self._loss = lambda sbase, ad: T.feature_calibration_loss(tbase, sbase, ad, batch,
                                                                      cfg)
            keys = ("feature_mse", "loss")
        shape = (len(states),) if self.batched else ()
        self.metrics = {k: torch.zeros(shape, dtype=torch.float32, device=self.device)
                        for k in keys}
        self.backend_key = substrate.active_backend_key()
        self._ptrs = self._input_ptrs()
        self.stream = stream
        if self.device.type == "cuda" and stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}   # kernel launches per replay
        self._failed = False

    def _input_ptrs(self) -> Tuple[int, ...]:
        frozen = [[m.student_base for m in self.members], self.batch,
                  self.teacher_base if self.feats is None else self.feats]
        return tuple(t.data_ptr() for t in tree_lib.tensors(frozen))

    def _check_inputs(self) -> None:
        from repro_torch import substrate

        if substrate.active_backend_key() != self.backend_key:
            raise RuntimeError(
                f"the calibration step was built under {self.backend_key}, called under "
                f"{substrate.active_backend_key()}: build a step under the backend it runs in")
        if self._input_ptrs() != self._ptrs:
            raise RuntimeError(
                "the calibration step's frozen inputs (bases, batch, teacher features) "
                "moved after it was built; build a new step")

    def _run(self) -> None:
        for j, m in enumerate(self.members):
            with torch.enable_grad():
                loss, aux = self._loss(m.student_base, m.adapters)
                grads = torch.autograd.grad(loss, m.leaves, allow_unused=True)
            for i, g in enumerate(grads):
                if g is None and i not in m.zeros:
                    m.zeros[i] = torch.zeros_like(m.leaves[i])
            grads = [m.zeros[i] if g is None else g for i, g in enumerate(grads)]
            for k, v in {**aux, "loss": loss}.items():
                (self.metrics[k][j] if self.batched else self.metrics[k]).copy_(v.detach())
            adamw_update_(tree_lib.unflatten(m.adapters, grads), m.opt_state, m.adapters,
                          self.opt, self.betas)
            del loss, aux, grads

    def __call__(self) -> Dict[str, torch.Tensor]:
        from repro_torch import graphs

        if self._failed:
            raise RuntimeError("the calibration step failed to capture; it does not "
                               "run eagerly")
        self._check_inputs()
        if self.device.type != "cuda":
            self._run()
        elif self.calls == 0:
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self._run()
            current.wait_stream(self.stream)
        else:
            if self.graph is None:
                # the eager first step's blocks go back to the device: the
                # capture's private pool cannot take them from the cache
                # (an MoE step reads every expert stack back in f32)
                torch.cuda.empty_cache()
                self._failed = True
                self.graph, _, self.launches = graphs.capture(self._run, self.stream)
                self._failed = False
            self.graph.replay()
            graphs.add_launch_counts(self.launches)
        self.calls += 1
        return self.metrics

    def state(self):
        """Detached copies of the adapters and the AdamW state after the
        calls so far (they alias neither the static leaves nor the pool):
        a ``CalibState``, or a list of them for a list."""
        def copy(tree):
            return tree_lib.map_tensors(lambda t: t.detach().clone(), tree)

        out = [CalibState(self.teacher_base, m.student_base, copy(m.adapters),
                          AdamState(*(copy(s) for s in m.opt_state)), m.start + self.calls)
               for m in self.members]
        return out if self.batched else out[0]

    def release(self) -> None:
        """Drop the graph: its private pool returns to the allocator."""
        self.graph = None
