"""Continuous-batching serve engine over the batched decode step. Port
of ``repro/deploy/engine.py`` for decoder-only attention stacks (the
shared prefix cache, ``remesh`` and encoder/vision slots wait).

* **Slots.** A fixed ``(max_slots, max_len)`` decode cache; each
  in-flight request owns one row, finished rows are recycled.
* **Per-slot clocks.** ``pos`` is a (B,) vector: ragged prompts and
  mid-stream admission need no lockstep.
* **Chunked admission.** A prompt is admitted in ``prefill_chunk``-token
  chunks (pow-2 bucketed width, masked tail), one chunk per engine tick
  interleaved with decode ticks; the first token comes from the last
  chunk's logits and the batch-1 cache is copied into the slot's row.
* **One decode step for everyone.** ``step()`` advances every active
  slot with one ``decode_step``; idle rows ride along and their writes
  stay masked.
* **Unified retirement.** Every exit goes through ``_finish``, so
  ``generated_tokens == first_tokens + decode_tokens`` always.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.deploy import serving

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
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    admitted_tick: Optional[int] = None
    submitted_at: Optional[float] = None
    ttft_seconds: Optional[float] = None   # submit -> first token
    _cache: Optional[dict] = dataclasses.field(default=None, repr=False)
    _logits: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    _spans: List[Tuple[int, int]] = dataclasses.field(default_factory=list, repr=False)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


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
                 prefill_chunk: int = 32, min_bucket: int = 8):
        from repro_torch.models import transformer as T

        self.session = session
        self.cfg = session.cfg
        if not all(m in _CHUNKABLE for m in self.cfg.mixer_pattern):
            raise NotImplementedError("the engine admits attention stacks only")
        self.device = session.device
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.prefill_chunk = _pow2_ceil(int(prefill_chunk))
        self.min_bucket = min(_pow2_ceil(int(min_bucket)), self.prefill_chunk)
        self.cache = T.init_cache(self.cfg, self.max_slots, self.max_len, self.device)
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
        self._next_rid = 0

    @property
    def generated_tokens(self) -> int:
        return self.first_tokens + self.decode_tokens

    # -- admission -----------------------------------------------------------

    def submit(self, prompt, *, max_new: int = 16, temperature: float = 0.0,
               key: Optional[torch.Generator] = None,
               eos_id: Optional[int] = None) -> Request:
        """Enqueue a request; admission starts at once if a slot is free
        (a one-chunk prompt has its first token before this returns)."""
        serving._check_sampling_args(temperature, key)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds engine "
                f"max_len ({self.max_len})")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise ValueError(f"prompt tokens must lie in [0, {self.cfg.vocab})")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=int(max_new),
                      temperature=float(temperature), key=key, eos_id=eos_id,
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
        from repro_torch.models import transformer as T

        req.slot = slot
        self.slot_req[slot] = req
        req._cache = T.init_cache(self.cfg, 1, self.max_len, self.device)
        req._spans = self._spans(0, req.prompt_len)

    def _advance_admission(self, slot: int) -> None:
        """Run one prompt chunk for the slot; finalize after the last."""
        req = self.slot_req[slot]
        if req is None or self.active[slot] or req.done:
            return
        a, b_ = req._spans.pop(0)
        with self.session.scope():
            req._logits, req._cache = self._chunk_call(req._cache, req.prompt, a, b_)
        self.prefill_chunks += 1
        if not req._spans:
            self._finalize_admission(slot, req)

    @torch.no_grad()
    def _chunk_call(self, cache, prompt, a, b_):
        """Tokens [a, b_) at positions [a, b_), zero-padded to the bucket."""
        from repro_torch.models import transformer as T

        n = b_ - a
        toks = np.zeros((1, self._bucket(n)), np.int64)
        toks[0, :n] = prompt[a:b_]
        dev = self.device
        return T.prefill_chunk(
            self.session.params, torch.as_tensor(toks, device=dev), cache,
            torch.tensor([a], device=dev), torch.tensor([n], device=dev),
            self.cfg, self.max_len,
        )

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
        one = req._cache
        req._cache = None
        req._logits = None
        if req.max_new <= 1 or (req.eos_id is not None and first == req.eos_id):
            self._finish(req, slot)
            return
        T.write_cache_slot(self.cache, one, slot)
        self.active[slot] = True
        self.pos[slot] = req.prompt_len
        self.last_tok[slot, 0] = first

    # -- decode tick ---------------------------------------------------------

    @torch.no_grad()
    def step(self) -> bool:
        """Admit what fits, advance every admitting slot by one chunk,
        then every active slot by one token. False when idle."""
        from repro_torch.models import transformer as T

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
        dev = self.device
        with self.session.scope():
            logits, self.cache = T.decode_step(
                self.session.params, self.cache,
                torch.as_tensor(self.last_tok, device=dev),
                torch.as_tensor(self.pos, device=dev), self.cfg)
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

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

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
            "decode_tok_per_s": (self.decode_tokens / self.decode_seconds
                                 if self.decode_seconds > 0 else float("nan")),
        }
