"""Continuous-batching serve engine over the batched decode step. Port
of ``repro/deploy/engine.py`` for attention stacks (decoder-only,
encoder-decoder, or behind a vision prefix) and recurrent stacks (the
SSM, and RG-LRU beside local attention).

* **Slots.** A fixed ``(max_slots, max_len)`` decode cache; each
  in-flight request owns one row, finished rows are recycled.
* **Per-slot clocks.** ``pos`` is a (B,) vector: ragged prompts and
  mid-stream admission need no lockstep.
* **Chunked admission.** A prompt is admitted in ``prefill_chunk``-token
  chunks (pow-2 bucketed width, masked tail), one chunk per engine tick
  interleaved with decode ticks; the first token comes from the last
  chunk's logits and the batch-1 cache is copied into the slot's row.
* **Unchunked admission (recurrent stacks).** A recurrence's scan
  regroups its products by length, so a stack with an SSM or RG-LRU
  mixer does not chunk (``self.chunked`` False): a cold request runs one
  exact-length fused prefill, the session's compiled step of its prompt
  length (``ServeSession.prefill_fn``, a CUDA graph per length on the
  card), which writes the staging views itself; then, as after a last
  chunk, it is snapshotted and finalized at once. The prefix cache serves
  only full hits: the snapshot of a whole prompt.
* **Encoder-decoder slots.** A request carries ``enc_embeds`` (S_src, d):
  its cold admission zeroes the staging cache and runs the session's
  encoder step (``ServeSession.encode_fn``, one per source length) just
  before its first chunk, which writes every decoder layer's
  cross-attention K/V lines over ``src_len`` positions and ``enc_len``;
  they travel with the staging cache into the slot, where each row is
  masked past its own ``enc_len``. Decode ticks never run the encoder.
* **Vision-prefix slots.** A request may carry ``patch_embeds`` (P, d):
  its cold admission starts with a vision unit, a tick of its own
  (counted in ``prefill_chunks``), which zeroes the staging cache, writes
  the P patch positions' K/V there (``ServeSession.prefill_vision_fn``,
  bidirectional among themselves) and saves it into ``Request._cache``,
  since another slot's chunk may use the staging cache before this
  slot's next; the text chunks then load it and run at positions ``P +
  [a, b)``, and the slot's clock starts at ``P + prompt_len``. A vision
  config admits text-only requests too (``vision_len`` 0).
* **Shared prefix cache.** After every admission chunk the staging
  cache and the chunk's logits are cloned under a token-hash chain key
  (the reference's chain, byte for byte, seeded with the encoder input's
  bytes, then the patches'), LRU-capped at
  ``prefix_cache_entries``. A request whose prompt starts with a stored
  prefix resumes from it: a full hit copies the snapshot into the
  staging cache and runs no chunk; a partial hit at ``k`` loads a fresh
  copy of it into ``Request._cache`` and runs the chunks from ``k``
  (either skips the vision unit: the snapshot holds the patches' rows).
  Every snapshot is a copy, since the staging cache, ``Request._cache``
  and a graph's logits are written in place. A full hit, or a partial hit
  at a multiple of ``prefill_chunk``, runs the chunks a cold admission
  runs and is bitwise equal to it; a partial hit elsewhere runs other
  chunk widths, which may change the last bits of the logits. Under
  ``codes_adc`` a chunk's rows share each tile's ADC step (it tracks the
  tile's max |x|), so which rows a chunk holds changes its result: there
  the engine resumes only at multiples of ``prefill_chunk`` (the
  reference resumes anywhere). So it does for an MoE stack whose
  capacity can drop tokens: a chunk's rows share each expert's capacity
  (``moe.capacity_of`` of the chunk width), so which rows compete decides
  which are dropped.
* **One decode step for everyone.** ``step()`` advances every active
  slot with one ``decode_step``; idle rows ride along and their writes
  stay masked.
* **Compiled steps.** The decode tick, each chunk bucket and each
  unchunked prompt length are the session's registry entries
  (``ServeSession.decode_step_fn`` / ``prefill_chunk_fn`` /
  ``prefill_fn``): CUDA graphs on the card, replayed on the
  current stream. The engine leases a decode step of its own (its cache
  is the slots' cache); every chunk advances the session's batch-1
  staging cache, and a prompt of several chunks keeps its cache between
  them in ``Request._cache`` (one flat buffer, one copy each way).
  Greedy argmax, sampling and the token's copy to the host stay outside.
* **Unified retirement.** Every exit goes through ``_finish``, so
  ``generated_tokens == first_tokens + decode_tokens`` always.
* **Tensor-parallel serving and the elastic re-mesh.** Over a session
  bound to a mesh every rank runs the same engine on the same requests
  (SPMD) through the session's eager mesh steps; such an engine is
  decoder-only. ``remesh`` moves the session onto a degraded mesh after
  a host is lost, rebuilds the slots' cache by replaying every in-flight
  slot, and returns the ``ElasticPlan``; a rank the new mesh drops leaves
  the serving loop (``step`` returns False).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.deploy import serving
from repro_torch.models import moe as M

_CHUNKABLE = ("attn", "local", "swa")


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: np.ndarray               # (s,) int
    max_new: int
    temperature: float = 0.0
    key: Optional[torch.Generator] = None
    eos_id: Optional[int] = None
    enc_embeds: Optional[np.ndarray] = None   # (s_src, d) [enc-dec]
    patch_embeds: Optional[np.ndarray] = None  # (P, d) [vision prefix]
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    admitted_tick: Optional[int] = None
    submitted_at: Optional[float] = None
    ttft_seconds: Optional[float] = None   # submit -> first token
    prefix_hit_tokens: int = 0       # prompt tokens reused from the prefix cache
    _cache: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    _logits: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    _chain: Optional[List[bytes]] = dataclasses.field(default=None, repr=False)
    _spans: List[Tuple[int, int]] = dataclasses.field(default_factory=list, repr=False)
    _vision_pending: bool = dataclasses.field(default=False, repr=False)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def vision_len(self) -> int:
        return 0 if self.patch_embeds is None else int(self.patch_embeds.shape[0])


class _Lease:
    """The owner of a step leased for one call (``ServeEngine.remesh``)."""


def _row(cache: dict, slot: int) -> dict:
    """Row ``slot`` of a batched cache as a batch-1 cache of views."""
    return {key: tree_lib.map_tensors(
                (lambda t: t[:, slot:slot + 1]) if key == "body" else (lambda t: t[slot:slot + 1]),
                v)
            for key, v in cache.items()}


def _pow2_ceil(n: int) -> int:
    if n < 1:
        raise ValueError(f"need a positive size, got {n}")
    b = 1
    while b < n:
        b *= 2
    return b


class ServeEngine:
    """Slot-based continuous-batching scheduler over a ``ServeSession``."""

    def __init__(self, session, *, max_slots: int = 4, max_len: int = 128,
                 src_len: int = 0, prefill_chunk: int = 32, min_bucket: int = 8,
                 prefix_cache_entries: int = 16):
        self.session = session
        self.cfg = session.cfg
        self.chunked = all(m in _CHUNKABLE for m in self.cfg.mixer_pattern)
        if self.cfg.encoder_layers and src_len <= 0:
            raise ValueError("encoder-decoder engine needs src_len > 0 (the cross-"
                             "attention cache extent; requests may be shorter)")
        self.device = session.device
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.src_len = int(src_len) if self.cfg.encoder_layers else 0  # the cross lines' extent
        self.prefill_chunk = _pow2_ceil(int(prefill_chunk))
        self.min_bucket = min(_pow2_ceil(int(min_bucket)), self.prefill_chunk)
        self._decode = session.decode_step_fn(self.max_slots, self.max_len, owner=self,
                                              src_len=self.src_len)
        self.cache = self._decode.cache
        self._staging_flat, self._staging = session.staging_cache(self.max_len, self.src_len)
        self.prefix_cache_entries = int(prefix_cache_entries)
        # hash-chain digest -> (tokens, staging-cache clone, logits clone)
        self._prefix_cache: "OrderedDict[bytes, tuple]" = OrderedDict()
        # codes_adc digitizes each tile of rows at a step from its max |x|,
        # and an MoE chunk's rows compete for expert capacity: a resumed
        # chunk must hold the rows a cold admission's chunk holds
        moe = getattr(self.cfg, "moe", None)
        self._resume_off_boundary = (session.backend != "codes_adc"
                                     and not (moe is not None and M.can_drop(moe)))
        self.pos = np.zeros(self.max_slots, np.int64)
        self.active = np.zeros(self.max_slots, bool)
        self.last_tok = np.zeros((self.max_slots, 1), np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.max_slots
        self.pending: Deque[Request] = deque()
        self.tick = 0
        self.decode_steps = 0       # batched decode ticks run
        self.decode_seconds = 0.0   # host time inside those ticks
        self.decode_tokens = 0      # tokens produced by those ticks
        self.first_tokens = 0       # tokens sampled from admission logits
        self.completed = 0
        self.prefill_chunks = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0          # full-prompt snapshot hits
        self.prefix_partial_hits = 0  # shared-prefix (partial) hits
        self._next_rid = 0
        self.left = False           # dropped from the mesh by remesh

    @property
    def generated_tokens(self) -> int:
        return self.first_tokens + self.decode_tokens

    # -- admission -----------------------------------------------------------

    def submit(self, prompt, *, max_new: int = 16, temperature: float = 0.0,
               key: Optional[torch.Generator] = None,
               eos_id: Optional[int] = None, enc_embeds=None, patch_embeds=None) -> Request:
        """Enqueue a request; admission starts at once if a slot is free
        (a one-chunk prompt has its first token before this returns).
        ``enc_embeds`` (s_src, d), a numpy array (a leading batch axis of 1
        accepted), is an encoder-decoder request's encoder input;
        ``patch_embeds`` (P, d), likewise, a vision request's image (P =
        ``cfg.vision_tokens``), counted against ``max_len``. Their bytes,
        in the dtype given, seed the prefix cache's hash chain."""
        if self.left:
            raise RuntimeError("this rank left the mesh (remesh): its engine takes no request")
        serving._check_sampling_args(temperature, key)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise ValueError(f"prompt tokens must lie in [0, {self.cfg.vocab})")
        if self.session.mesh is not None and (enc_embeds is not None
                                              or patch_embeds is not None):
            raise ValueError("mesh serving is decoder-only: no encoder input or image")
        if self.cfg.encoder_layers:
            if enc_embeds is None:
                raise ValueError("encoder-decoder request needs enc_embeds")
            enc_embeds = np.asarray(enc_embeds)
            if enc_embeds.ndim == 3:
                enc_embeds = enc_embeds[0]
            if enc_embeds.shape[0] > self.src_len:
                raise ValueError(f"enc_embeds length {enc_embeds.shape[0]} exceeds engine "
                                 f"src_len ({self.src_len})")
            if enc_embeds.shape[0] < 1:
                raise ValueError("empty enc_embeds")
        elif enc_embeds is not None:
            raise ValueError("enc_embeds passed to a decoder-only config")
        if patch_embeds is not None:
            if not self.cfg.vision_tokens:
                raise ValueError("patch_embeds passed to a config without vision_tokens")
            patch_embeds = np.asarray(patch_embeds)
            if patch_embeds.ndim == 3:
                patch_embeds = patch_embeds[0]
            if patch_embeds.shape[0] != self.cfg.vision_tokens:
                raise ValueError(f"expected {self.cfg.vision_tokens} vision tokens, got "
                                 f"{patch_embeds.shape[0]}")
        prefix = 0 if patch_embeds is None else patch_embeds.shape[0]
        if prefix + prompt.size + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prefix + prompt.size}) + max_new ({max_new}) exceeds engine "
                f"max_len ({self.max_len})")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=int(max_new),
                      temperature=float(temperature), key=key, eos_id=eos_id,
                      enc_embeds=enc_embeds, patch_embeds=patch_embeds,
                      submitted_at=time.perf_counter())
        self._next_rid += 1
        self.pending.append(req)
        self._admit_pending()
        return req

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.max_slots) if self.slot_req[i] is None]

    def _admit_pending(self) -> None:
        while self.pending:
            free = self._free_slots()
            if not free:
                return
            slot = free[0]
            req = self.pending.popleft()
            self._start_admission(req, slot)
            self._advance_admission(slot)

    def _bucket(self, n: int) -> int:
        """Pow-2 chunk width in [min_bucket, prefill_chunk]."""
        b = self.min_bucket
        while b < n:
            b *= 2
        return b

    def _spans(self, start: int, n: int) -> List[Tuple[int, int]]:
        return [(a, min(a + self.prefill_chunk, n))
                for a in range(start, n, self.prefill_chunk)]

    def _start_admission(self, req: Request, slot: int) -> None:
        """Bind ``req`` to ``slot``, look its prompt up in the prefix cache
        and plan the chunks from the tokens it covers, behind a vision unit
        when a cold image request starts from nothing. An unchunked stack's
        cold request runs its whole prompt here (``_prefill``, one compiled
        step) and plans no unit."""
        req.slot = slot
        self.slot_req[slot] = req
        req._chain = self._hash_chain(req)
        hit = self._prefix_lookup(req)
        if not self.chunked:
            if hit < req.prompt_len:
                self._prefill(req)
            return
        req._vision_pending = hit == 0 and req.patch_embeds is not None
        req._spans = self._spans(hit, req.prompt_len)

    def _advance_admission(self, slot: int) -> None:
        """Run one admission unit for the slot (the vision prefix, or one
        prompt chunk, snapshotted), and finalize after the last (at once
        after a full prefix hit)."""
        req = self.slot_req[slot]
        if req is None or self.active[slot] or req.done:
            return
        if req._vision_pending:
            self._vision(req)
            req._vision_pending = False
            self.prefill_chunks += 1
            if req._spans:
                return
        elif req._spans:
            a, b_ = req._spans.pop(0)
            req._logits = self._chunk_call(req, a, b_)
            self.prefill_chunks += 1
            self._store_prefix(req, b_)
            if req._spans:
                return
        self._finalize_admission(slot, req)

    @torch.no_grad()
    def _chunk_call(self, req: Request, a: int, b_: int) -> torch.Tensor:
        """Tokens [a, b_) at positions ``vision_len + [a, b_)``, zero-padded
        to the bucket, through the bucket's step on the staging cache:
        zeroed for a first chunk without a vision prefix (then, for an
        encoder-decoder request, filled by its encoder admission), else
        loaded from ``req._cache``; saved back there unless this is the
        last chunk (the staging cache then holds the prompt until
        ``_finalize_admission`` copies it into the slot)."""
        n = b_ - a
        width = self._bucket(n)
        step = self.session.prefill_chunk_fn(width, self.max_len, self.src_len)
        host = np.zeros(width + 2, np.int64)
        host[:n] = req.prompt[a:b_]
        host[width:] = (req.vision_len + a, n)
        if a == 0 and req.patch_embeds is None:
            step.flat.zero_()
            if req.enc_embeds is not None:
                self._encode(req)
        else:
            step.flat.copy_(req._cache)
        logits = step(torch.from_numpy(host))
        if req._spans:
            self._save(req, step.flat)
        return logits

    @torch.no_grad()
    def _prefill(self, req: Request) -> None:
        """An unchunked stack's cold admission: the fused prefill of the
        whole prompt at batch 1, the session's step of its length, which
        fills the staging cache; snapshotted for the prefix cache. Its
        logits are the step's own, valid until the next admission of that
        length (``_finalize_admission`` follows at once)."""
        step = self.session.prefill_fn(req.prompt_len, self.max_len)
        req._logits = step(torch.tensor(req.prompt)[None])
        self._store_prefix(req, req.prompt_len)

    @staticmethod
    def _save(req: Request, flat: torch.Tensor) -> None:
        """Keep the staging cache in ``req._cache`` until its next unit."""
        if req._cache is None:
            req._cache = torch.empty_like(flat)
        req._cache.copy_(flat)

    @torch.no_grad()
    def _vision(self, req: Request) -> None:
        """The request's vision unit: the staging cache zeroed, the
        patches' K/V written at [0, P), then saved into ``req._cache``."""
        from repro_torch.interop import to_tensor

        step = self.session.prefill_vision_fn(self.max_len)
        step.flat.zero_()
        step(to_tensor(req.patch_embeds, "cpu")[None])
        self._save(req, step.flat)

    @torch.no_grad()
    def _encode(self, req: Request) -> None:
        """The request's encoder admission into the staging cache: its
        cross lines over ``[0, s_src)`` and ``enc_len``."""
        from repro_torch.interop import to_tensor

        enc = req.enc_embeds
        step = self.session.encode_fn(enc.shape[0], self.max_len, self.src_len)
        step(to_tensor(enc, "cpu")[None])

    @torch.no_grad()
    def _finalize_admission(self, slot: int, req: Request) -> None:
        """Sample the first token; activate the slot or retire at once."""
        from repro_torch.models import transformer as T

        tok, req.key = serving._next_token(req._logits, req.temperature, req.key)
        first = int(tok[0, 0])
        req.ttft_seconds = time.perf_counter() - req.submitted_at
        req.tokens.append(first)
        req.admitted_tick = self.tick
        self.first_tokens += 1
        req._cache = None
        req._logits = None
        req._chain = None
        if req.max_new <= 1 or (req.eos_id is not None and first == req.eos_id):
            self._finish(req, slot)
            return
        T.write_cache_slot(self.cache, self._staging, slot)
        self.active[slot] = True
        self.pos[slot] = req.vision_len + req.prompt_len
        self.last_tok[slot, 0] = first

    # -- prefix cache --------------------------------------------------------

    @staticmethod
    def _hash_chain(req: Request) -> List[bytes]:
        """``chain[k]`` names the request's first ``k`` prompt tokens (and
        the whole encoder input and image, part of position 0's context):
        the key of a snapshot with exactly ``k`` tokens admitted (the
        reference's chain, byte for byte: the encoder input's bytes, then
        the patches', as numpy's ``tobytes`` lays them out, in the dtype the
        caller gave)."""
        h = hashlib.sha1(b"rimc-prefix-v1")
        for inputs in (getattr(req, "enc_embeds", None), getattr(req, "patch_embeds", None)):
            if inputs is not None:
                h.update(np.ascontiguousarray(inputs).tobytes())
        chain = [h.digest()]
        for t in req.prompt:
            h = hashlib.sha1(chain[-1])
            h.update(int(t).to_bytes(8, "little", signed=True))
            chain.append(h.digest())
        return chain

    def _prefix_lookup(self, req: Request) -> int:
        """The longest stored prefix of the request's prompt (under
        ``codes_adc`` the whole prompt or a multiple of ``prefill_chunk``;
        for an unchunked stack the whole prompt only):
        the number of prompt tokens it covers (0 when cold). A full hit
        copies the snapshot into the staging cache, which
        ``_finalize_admission`` copies into the slot next; a partial hit
        stages a fresh copy in ``req._cache``, which the next chunk loads.
        The stored tensors are never handed out to be written."""
        if self.prefix_cache_entries <= 0:
            return 0
        self.prefix_lookups += 1
        n = req.prompt_len
        for k in range(n, 0, -1) if self.chunked else (n,):
            if k < n and k % self.prefill_chunk and not self._resume_off_boundary:
                continue
            entry = self._prefix_cache.get(req._chain[k])
            if entry is None:
                continue
            toks, cache, logits = entry
            if toks.shape[0] != k or not np.array_equal(toks, req.prompt[:k]):
                continue  # a hash collision: a miss
            self._prefix_cache.move_to_end(req._chain[k])
            req._logits = logits
            req.prefix_hit_tokens = k
            if k == n:
                self._staging_flat.copy_(cache)
                self.prefix_hits += 1
            else:
                req._cache = cache.clone()
                self.prefix_partial_hits += 1
            return k
        return 0

    def _store_prefix(self, req: Request, k: int) -> None:
        """Snapshot the admission after ``k`` prompt tokens: clones of the
        staging cache and of the chunk's logits (both are written again by
        the next chunk)."""
        if self.prefix_cache_entries <= 0:
            return
        key = req._chain[k]
        if key in self._prefix_cache:
            self._prefix_cache.move_to_end(key)
            return
        self._prefix_cache[key] = (req.prompt[:k].copy(), self._staging_flat.clone(),
                                   req._logits.clone())
        while len(self._prefix_cache) > self.prefix_cache_entries:
            self._prefix_cache.popitem(last=False)

    def prefix_cache_bytes(self) -> int:
        """Device bytes the stored snapshots hold."""
        return sum(c.numel() * c.element_size() + lg.numel() * lg.element_size()
                   for _, c, lg in self._prefix_cache.values())

    # -- decode tick ---------------------------------------------------------

    @torch.no_grad()
    def step(self) -> bool:
        """Admit what fits, advance every admitting slot by one chunk,
        then every active slot by one token (one call of the leased decode
        step). False when idle, and on a rank that ``remesh`` dropped."""
        if self.left:
            return False
        self._admit_pending()
        for slot in range(self.max_slots):
            req = self.slot_req[slot]
            if req is not None and not self.active[slot] and not req.done:
                self._advance_admission(slot)
        if not self.active.any():
            busy = bool(self.pending) or any(
                r is not None and not r.done for r in self.slot_req)
            if busy:
                self.tick += 1
            return busy
        t0 = time.perf_counter()
        logits = self._decode(torch.from_numpy(np.stack([self.last_tok[:, 0], self.pos])))
        greedy = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        n_live = int(self.active.sum())
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            if req.temperature > 0:
                tok, req.key = serving._next_token(
                    logits[slot:slot + 1], req.temperature, req.key)
                t = int(tok[0, 0])
            else:
                t = int(greedy[slot])
            req.tokens.append(t)
            self.pos[slot] += 1
            self.last_tok[slot, 0] = t
            hit_eos = req.eos_id is not None and t == req.eos_id
            out_of_room = int(self.pos[slot]) + 1 >= self.max_len
            if len(req.tokens) >= req.max_new or hit_eos or out_of_room:
                self._finish(req, slot)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        self.decode_tokens += n_live
        self.tick += 1
        return True

    def _finish(self, req: Request, slot: Optional[int] = None) -> None:
        """The single retirement path."""
        req.done = True
        req.slot = None
        self.completed += 1
        if slot is not None:
            self.slot_req[slot] = None
            self.active[slot] = False

    def run(self) -> None:
        """Admit and step until every submitted request retired."""
        while self.step():
            pass

    # -- elastic degradation -------------------------------------------------

    @torch.no_grad()
    def remesh(self, new_mesh=None, *, n_failed_hosts: int = 1):
        """A host dropped mid-serve: re-bind the session to the degraded
        mesh and rebuild the slots' cache by replaying every in-flight slot
        from its deterministic lifecycle, the prompt and the tokens already
        emitted. Returns the ``ElasticPlan``. Every rank of the old mesh
        calls it at the same tick.

        Without ``new_mesh`` the session's mesh loses its trailing
        ``n_failed_hosts`` data-axis rows (``launch.mesh.make_elastic_mesh``);
        the model axis keeps its ranks in order, so the params are sharded
        as before and the replayed streams are bitwise the undisturbed
        engine's. A rank the new mesh does not hold leaves the serving loop
        here: its engine steps no more.

        Replay runs each slot's admission again, the prompt through the
        chunks (or the one fused prefill of an unchunked stack) that its
        admission ran (the prefix cache's snapshot at ``k`` tokens was made
        by the chunks of ``[0, k)``), then feeds each emitted token but the
        pending one at its original position through a decode step of the
        engine's batch, the slot in its own row: the launches of the
        original ticks, at their row count. Rows are independent, but an
        MoE stack whose capacity can drop tokens couples them, and there
        the replay is not exact. Host state (clocks, the pending token,
        the requests' generators) carries over untouched."""
        from repro_torch.launch.mesh import make_elastic_mesh
        from repro_torch.models import transformer as T
        from repro_torch.runtime.fault import ElasticPlan

        mesh = self.session.mesh
        if new_mesh is None:
            if mesh is None:
                raise ValueError(
                    "remesh needs either an explicit new_mesh or a session "
                    "already bound to a mesh to degrade")
            plan = ElasticPlan.plan(n_failed_hosts, self.tick, rows=int(mesh.shape["data"]),
                                    cols=int(mesh.shape["model"]))
            new_mesh = make_elastic_mesh(n_failed_hosts, base_mesh=mesh)
        else:
            dropped = 0
            if mesh is not None and "data" in mesh.shape:
                dropped = int(mesh.shape["data"]) - int(new_mesh.shape.get("data", 1))
            plan = ElasticPlan(failed_hosts=max(dropped, 0),
                               new_mesh_shape=tuple(new_mesh.ranks.shape),
                               restore_step=self.tick, notes="explicit re-mesh")
        if not new_mesh.member:
            self.left = True
            return plan
        live = [r for r in (*self.slot_req, *self.pending) if r is not None]
        if any(r.enc_embeds is not None or r.patch_embeds is not None for r in live):
            raise ValueError("mesh serving is decoder-only: a request in flight carries an "
                             "encoder input or an image")
        self.session.reshard(new_mesh)
        self._decode = self.session.decode_step_fn(self.max_slots, self.max_len, owner=self,
                                                   src_len=self.src_len)
        self.cache = self._decode.cache
        lease = _Lease()  # a second decode step: the replay's own rows
        replay = self.session.decode_step_fn(self.max_slots, self.max_len, owner=lease,
                                             src_len=self.src_len)
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            self._replay_admission(req)
            T.write_cache_slot(replay.cache, self._staging, slot)
            pos0 = req.vision_len + req.prompt_len
            host = np.zeros((2, self.max_slots), np.int64)
            for j, t in enumerate(req.tokens[:-1]):
                host[:, slot] = (t, pos0 + j)
                replay(torch.from_numpy(host))
            T.write_cache_slot(self.cache, _row(replay.cache, slot), slot)
        return plan

    def _replay_admission(self, req: Request) -> None:
        """Rebuild ``req``'s admitted batch-1 cache in the staging cache,
        bitwise what its admission left there: the fused prefill of its
        prompt for an unchunked stack, else its chunks from a zeroed
        cache. Under a mesh a request carries no encoder input or image."""
        if not self.chunked:
            self.session.prefill_fn(req.prompt_len, self.max_len)(
                torch.tensor(req.prompt)[None])
            return
        k = req.prefix_hit_tokens
        self._staging_flat.zero_()
        for a, b_ in self._spans(0, k) + self._spans(k, req.prompt_len):
            n = b_ - a
            width = self._bucket(n)
            host = np.zeros(width + 2, np.int64)
            host[:n] = req.prompt[a:b_]
            host[width:] = (req.vision_len + a, n)
            self.session.prefill_chunk_fn(width, self.max_len, self.src_len)(
                torch.from_numpy(host))

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def compile_count(self) -> int:
        """The session's compiled steps (``ServeSession.compile_count``):
        flat across requests once every shape has been seen."""
        return self.session.compile_count()

    def stats(self) -> dict:
        return {
            "ticks": self.tick,
            "decode_steps": self.decode_steps,
            "decode_seconds": self.decode_seconds,
            "decode_tokens": self.decode_tokens,
            "first_tokens": self.first_tokens,
            "generated_tokens": self.generated_tokens,
            "completed": self.completed,
            "prefill_chunks": self.prefill_chunks,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_partial_hits": self.prefix_partial_hits,
            "decode_tok_per_s": (self.decode_tokens / self.decode_seconds
                                 if self.decode_seconds > 0 else float("nan")),
            "compile_count": self.compile_count(),
        }
