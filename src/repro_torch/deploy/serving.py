"""Serving half of the deployment lifecycle: backend scoping, fused
prefill, the reference generation loop, the compiled-step registry and
``ServeSession``. Port of ``repro/deploy/serving.py``.

The registry's twin of the reference's jitted steps is a CUDA graph: a
session builds its decode tick, its admission chunk, the fused prefill of
an unchunked (recurrent) stack's admission (``"prefill"``, one per prompt
length), for an encoder-decoder config its encoder admission
(``"encode"``, one per source length, as the reference's jit retraces per
shape) and for a vision config its vision admission
(``"prefill_vision"``) once per ``(kind, active_backend_key(), batch,
width, max_len, src_len)`` (``StepRegistry``, ``CompiledStep``) and
replays them. ``ServeSession.prefill``, the module-level
``prefill_and_cache`` and ``generate`` loop stay eager. Everything runs
under ``torch.no_grad()``.

A session bound to a mesh (``ServeSession(mesh=)``, ``reshard``) serves
tensor-parallel: its params hold this rank's column blocks
(``substrate.ShardedPrepared``), whose outputs every rank gathers over
gloo. It keeps one step registry per mesh, as the reference keys its
steps on the mesh, and runs those steps eagerly on the card: a gloo
collective cannot be captured into a CUDA graph. Each mesh step is built
once and never captured; the single-device registry keeps its graphs.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import graphs, substrate
from repro_torch import tree as tree_lib

BACKENDS = ("dequant", "codes", "codes_adc")


def backend_scope(backend: str, cfg=None, **options):
    """Context manager binding the substrate backend and its options
    (every backend binds explicitly, ``dequant`` included). With the
    model config, ``codes_adc`` takes its ``code_max``/``adc_bits`` from
    ``cfg.rram``; an explicit option that conflicts with it raises."""
    if backend == "codes_adc" and cfg is not None:
        options["code_max"], options["adc_bits"] = substrate.resolve_adc_limits(
            cfg.rram, options.get("code_max"), options.get("adc_bits"))
    return substrate.use_backend(backend, **options)


@torch.no_grad()
def prefill_and_cache(params, tokens: torch.Tensor, cfg, max_len: int, enc_embeds=None,
                      patch_embeds=None, mesh=None):
    """Fused prefill: ONE forward over the prompt fills every layer's K/V
    (and, after the encoder over ``enc_embeds``, its cross lines; with
    ``patch_embeds`` (B, P, d), the vision prefix's K/V at [0, P) first).
    Returns ``(last_logits (B, 1, V), cache)``. ``mesh``: the mesh that
    ``params`` (a sharded serve tree) are placed on; the mesh path is
    decoder-only."""
    from repro_torch.models import transformer as T

    if mesh is not None and (enc_embeds is not None or patch_embeds is not None):
        raise ValueError("mesh serving is decoder-only (no enc_embeds/patch_embeds)")
    if cfg.encoder_layers and enc_embeds is None:
        raise ValueError("encoder-decoder config needs enc_embeds")
    return T.prefill(params, tokens, cfg, int(max_len), enc_embeds, patch_embeds)


def _next_token(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]):
    """Greedy or temperature sampling of the next token (B, 1) from
    ``logits[:, -1]``; returns (token, generator)."""
    last = logits[:, -1].to(torch.float32)
    if temperature > 0 and generator is not None:
        probs = torch.softmax(last / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)
        return tok, generator
    return torch.argmax(last, dim=-1)[:, None], generator


def _check_sampling_args(temperature: float, generator) -> None:
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 needs a torch.Generator")
    if temperature == 0 and generator is not None:
        raise ValueError(
            "a generator was passed but temperature == 0 samples greedily "
            "and would ignore it; pass temperature > 0 or drop the generator"
        )


@torch.no_grad()
def generate(params, prompt: torch.Tensor, cfg, *, gen_len: int = 16,
             temperature: float = 0.0, key: Optional[torch.Generator] = None,
             enc_embeds: Optional[torch.Tensor] = None,
             patch_embeds: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, float]:
    """Reference single-stream loop: fused prefill, then ``gen_len - 1``
    decode steps. Returns ``(tokens (B, gen_len), dt)``; ``dt`` covers
    the decode steps only (each ends in a device-to-host token copy).
    ``patch_embeds`` (B, P, d) puts a vision prefix ahead of the prompt;
    the decode clock then starts at ``P + S``. The plain parity loop over
    bare params: it stays eager (no registry, no graph)."""
    from repro_torch.models import transformer as T

    _check_sampling_args(temperature, key)
    if gen_len < 1:
        raise ValueError(f"gen_len must be >= 1, got {gen_len}")
    b, s = prompt.shape
    prefix = 0 if patch_embeds is None else patch_embeds.shape[1]
    logits, cache = prefill_and_cache(params, prompt, cfg, prefix + s + gen_len, enc_embeds,
                                      patch_embeds)
    tok, key = _next_token(logits, temperature, key)
    out = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        pos = torch.full((b,), prefix + s + i, dtype=torch.int64, device=prompt.device)
        logits, cache = T.decode_step(params, cache, tok, pos, cfg)
        tok, key = _next_token(logits, temperature, key)
        out.append(tok.cpu().numpy())
    dt = time.perf_counter() - t0
    return np.concatenate(out, axis=1).astype(np.int32), dt


# ---------------------------------------------------------------------------
# compiled-step registry (CUDA graphs)
# ---------------------------------------------------------------------------
#
# A graph bakes in the addresses of the params it read and of the buffers
# it advances, so the registry lives on the session, not in a module-level
# dict: a session's ``params`` must stay in place once a step is captured
# (``Deployment.serve`` builds a fresh tree and a fresh session; calibrate,
# then serve again). The registry records the params' addresses at its
# first lookup and raises at any later lookup or capture that finds them
# moved. Graphs of one session share one memory pool, so they must not
# replay at once on two streams: the engine issues every step on the
# current stream, one after another.


class CompiledStep:
    """One registry entry: a step function over static buffers.

    ``inputs`` is one tensor on the step's device whose views are the
    step's arguments (int64; the encoder admission's frames and the
    vision admission's patches in the config's dtype); ``fn()`` runs the
    step on them, advances ``cache`` (views of ``flat``) in place and
    returns the logits.
    ``step(host)`` copies ``host`` (the layout of ``inputs``) in and runs
    the step. On the CPU every call runs ``fn``. On the card the first
    call runs ``fn`` eagerly on the registry's capture stream (the warm-up,
    and this call's result), then captures it into a CUDA graph of the
    registry's pool; every later call replays the graph and returns its
    static logits, valid until the next call. Capturing launches nothing:
    the kernels' launch counters are restored after it, and each replay
    adds the launches its capture recorded. An error in warm-up or capture
    propagates, and a step whose capture failed raises on every later
    call: nothing runs on eagerly.

    A step of a mesh's registry (``StepRegistry(eager=True)``) runs ``fn``
    on every call, on the card too, and is never captured: its collectives
    go through gloo, which a CUDA graph cannot hold. That is its design,
    not a fallback: no capture is attempted."""

    def __init__(self, registry: "StepRegistry", key: tuple, fn: Callable[[], torch.Tensor],
                 inputs: torch.Tensor, flat: Optional[torch.Tensor] = None,
                 cache: Optional[dict] = None):
        self.registry = registry
        self.key = key
        self.fn = fn
        self.inputs = inputs
        self.flat, self.cache = flat, cache
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}   # kernel launches per replay
        self._owner = None                   # weakref of the leasing engine
        self._failed = False

    @property
    def eager(self) -> bool:
        """Runs its function on every call: on the CPU, or a mesh's step."""
        return self.registry.eager or self.inputs.device.type != "cuda"

    @property
    def compiled(self) -> bool:
        """Captured (card), or built (CPU, or a mesh's eager step)."""
        return self.graph is not None or self.eager

    def lease(self, owner) -> bool:
        """Hand the step to ``owner`` unless a live owner holds it; the
        cache is zeroed, as ``init_cache`` would give it. The lease ends
        when ``owner`` is collected."""
        if self._owner is not None and self._owner() is not None:
            return False
        self._owner = weakref.ref(owner)
        if self.flat is not None:
            self.flat.zero_()
        return True

    def __call__(self, host: torch.Tensor) -> torch.Tensor:
        if self._failed:
            raise RuntimeError(f"step {self.key} failed to capture; it does not run eagerly")
        self.inputs.copy_(host)
        if self.eager:
            return self.fn()
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        graphs.add_launch_counts(self.launches)
        return self.out

    def _warm_up_and_capture(self) -> torch.Tensor:
        reg = self.registry
        stream = reg.capture_stream()
        current = torch.cuda.current_stream(self.inputs.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = self.fn()
        reg.check_params()
        self._failed = True
        self.graph, self.out, self.launches = graphs.capture(self.fn, stream, reg.pool())
        self._failed = False
        current.wait_stream(stream)
        return out


class StepRegistry:
    """A session's compiled steps: ``key -> [CompiledStep, ...]`` (several
    when engines alive at once lease steps of one key), the graphs' memory
    pool and capture stream, and the addresses of the params the graphs
    read (checked on the CPU too, so that a test there sees what the card
    would refuse). ``params`` returns the session's params tree. A mesh's
    registry is ``eager``: its steps are built once and never captured."""

    def __init__(self, device, params: Callable[[], dict], *, eager: bool = False):
        self.device = torch.device(device)
        self._params = params
        self.eager = eager
        self._ptrs: Optional[Tuple[int, ...]] = None
        self._steps: Dict[tuple, List[CompiledStep]] = {}
        self._pool = None
        self._stream = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def check_params(self) -> None:
        """Record the params' addresses at the first check (the first
        lookup); raise when a later one (every lookup and capture) finds
        them moved: captured graphs would read stale operands."""
        ptrs = tuple(t.data_ptr() for t in tree_lib.tensors(self._params()))
        if self._ptrs is None:
            self._ptrs = ptrs
        elif ptrs != self._ptrs:
            raise RuntimeError(
                "the session's params moved after its steps were captured; "
                "serve a new session (Deployment.serve) instead of rebinding params")

    def get(self, key: tuple, build: Callable[[], CompiledStep], owner=None) -> CompiledStep:
        """The step of ``key``: shared when ``owner`` is None, else a step
        leased to ``owner`` (built when every step of the key is held)."""
        steps = self._steps.setdefault(key, [])
        self.check_params()
        if owner is None and steps:
            return steps[0]
        for step in steps:
            if step.lease(owner):
                return step
        step = build()
        steps.append(step)
        if owner is not None:
            step.lease(owner)
        return step

    def __iter__(self):
        return (s for steps in self._steps.values() for s in steps)

    def compile_count(self) -> int:
        """Graphs captured on the card; steps built on the CPU or of a
        mesh."""
        return sum(s.compiled for s in self)


def _fold(generator: torch.Generator, i: int) -> torch.Generator:
    """An independent generator for request ``i`` of one call."""
    from repro_torch.core.rram import make_generator

    return make_generator(generator.device, generator.initial_seed(), i)


class ServeSession:
    """A deployment bound for serving: adapters merged, backend scope
    applied around every call. ``params`` is the ``{"base", "adapters"}``
    tree the transformer consumes; ``options`` are the backend options
    every call runs under (``accum`` for ``codes``).

    ``mesh`` binds the session tensor-parallel (``reshard``); the
    unsharded tree stays in ``_host_params``, the source of every
    re-mesh."""

    def __init__(self, deployment, params, options: Optional[dict] = None, mesh=None):
        self.deployment = deployment
        self._host_params = params
        self.params = params
        self.options = dict(options or {})
        self.mesh = None
        self.shard_stats: Optional[dict] = None
        self._auto_key_calls = 0
        # one registry per mesh (None: single-device, CUDA graphs)
        self._registries = {None: StepRegistry(deployment.device, lambda: self.params)}
        self._staging: Dict[Tuple[int, int], Tuple[torch.Tensor, dict]] = {}
        if mesh is not None:
            self.reshard(mesh)

    @property
    def steps(self) -> StepRegistry:
        """The step registry of the session's current mesh."""
        return self._registries[self.mesh]

    def reshard(self, mesh):
        """(Re)bind this session to ``mesh``: wrap every column-shardable
        prepared leaf (``substrate.shard_prepared_for_serve``) and keep
        this rank's blocks (``substrate.place_serve_params``); ``None``
        returns to the single-device tree and its graphs. The mesh gets a
        fresh registry of eager steps, built on first use. Codes backend
        and decoder-only configs; the mesh must hold this rank, on the
        deployment's device."""
        if mesh is None:
            self.mesh, self.params, self.shard_stats = None, self._host_params, None
            return self
        if self.backend != "codes":
            raise ValueError(
                f"mesh serving runs the prepared codes fast path; "
                f"backend={self.backend!r} is single-device")
        if self.cfg.encoder_layers:
            raise ValueError("mesh serving is decoder-only (no encoder)")
        if not mesh.member:
            raise ValueError(f"{mesh} does not hold this rank")
        if mesh.device != self.device:
            raise ValueError(f"{mesh} places this rank on {mesh.device}; the deployment "
                             f"is on {self.device}")
        wrapped, stats = substrate.shard_prepared_for_serve(self._host_params, mesh)
        self.params = substrate.place_serve_params(wrapped, mesh)
        self.mesh, self.shard_stats = mesh, stats
        self._registries[mesh] = StepRegistry(self.device, lambda: self.params, eager=True)
        return self

    def _decoder_only(self, what: str) -> None:
        if self.mesh is not None:
            raise ValueError(f"mesh serving is decoder-only (no {what})")

    @property
    def cfg(self):
        return self.deployment.cfg

    @property
    def backend(self) -> str:
        return self.deployment.backend

    @property
    def device(self) -> torch.device:
        return self.deployment.device

    def scope(self):
        """The backend scope of every call: the deployment's backend, its
        config's ADC limits and the session's options."""
        return backend_scope(self.backend, self.cfg, **self.options)

    def _sampling_key(self, temperature: float, key):
        """A generator derived from the deployment seed when the caller
        asks for temperature sampling without one."""
        if temperature > 0 and key is None:
            from repro_torch.core.rram import make_generator

            self._auto_key_calls += 1
            key = make_generator(self.device, self.deployment.program_seed,
                                 self._auto_key_calls)
        _check_sampling_args(temperature, key)
        return key

    # -- compiled steps (the reference's decode_step_fn / prefill_fn /
    # prefill_chunk_fn / encode_fn); ``src_len`` is the cross lines' extent,
    # 0 without an encoder

    def _key(self, kind: str, batch: int, width: int, max_len: int, src_len: int = 0) -> tuple:
        with self.scope():
            return (kind, substrate.active_backend_key(), batch, width, max_len, src_len)

    def decode_step_fn(self, batch: int, max_len: int, *, owner,
                       src_len: int = 0) -> CompiledStep:
        """The decode tick over a ``(batch, max_len, src_len)`` cache of its
        own, leased to ``owner`` (an engine). Inputs: row 0 the (B, 1)
        tokens, row 1 the (B,) per-slot clocks."""
        from repro_torch.models import transformer as T

        def build():
            flat, cache = T.init_flat_cache(self.cfg, batch, max_len, self.device, src_len)
            inputs = torch.zeros((2, batch), dtype=torch.int64, device=self.device)
            tokens, pos = inputs[0].view(batch, 1), inputs[1]

            @torch.no_grad()
            def fn():
                with self.scope():
                    return T.decode_step(self.params, cache, tokens, pos, self.cfg)[0]
            return CompiledStep(self.steps, key, fn, inputs, flat, cache)

        key = self._key("decode", batch, 1, max_len, src_len)
        return self.steps.get(key, build, owner=owner)

    def staging_cache(self, max_len: int, src_len: int = 0) -> Tuple[torch.Tensor, dict]:
        """The batch-1 cache (flat buffer, tree of views) that every
        admission chunk and encoder admission of ``(max_len, src_len)``
        advances."""
        from repro_torch.models import transformer as T

        if (max_len, src_len) not in self._staging:
            self._staging[max_len, src_len] = T.init_flat_cache(self.cfg, 1, max_len,
                                                                self.device, src_len)
        return self._staging[max_len, src_len]

    def encode_fn(self, s_src: int, max_len: int, src_len: int) -> CompiledStep:
        """The encoder admission of an ``s_src``-frame input: runs the
        encoder and writes every decoder layer's cross lines and
        ``enc_len`` into ``staging_cache(max_len, src_len)``
        (``transformer.encode_into_cache``). Inputs: the (1, s_src, d)
        frames in the config's dtype. One step per source length."""
        from repro_torch.models import transformer as T

        self._decoder_only("encoder")
        if not 0 < s_src <= src_len:
            raise ValueError(f"an encoder input of {s_src} frames does not fit src_len "
                             f"{src_len}")

        def build():
            flat, cache = self.staging_cache(max_len, src_len)
            inputs = torch.zeros((1, s_src, self.cfg.d_model), dtype=self.cfg.dtype,
                                 device=self.device)

            @torch.no_grad()
            def fn():
                with self.scope():
                    return T.encode_into_cache(self.params, cache, inputs, self.cfg)["enc_len"]
            return CompiledStep(self.steps, key, fn, inputs, flat, cache)

        key = self._key("encode", 1, s_src, max_len, src_len)
        return self.steps.get(key, build)

    def prefill_vision_fn(self, max_len: int) -> CompiledStep:
        """The vision admission: the ``cfg.vision_tokens`` patches through
        every layer at positions [0, P), attending to each other
        bidirectionally, their K/V written into ``staging_cache(max_len)``
        (``transformer.prefill_vision``). Inputs: the (1, P, d) patches in
        the config's dtype. It returns the staging buffer itself: the step
        computes no logits."""
        from repro_torch.models import transformer as T

        self._decoder_only("vision prefix")
        p_ = self.cfg.vision_tokens
        if not p_:
            raise ValueError(f"{self.cfg.name} has no vision prefix (vision_tokens 0)")

        def build():
            flat, cache = self.staging_cache(max_len)
            inputs = torch.zeros((1, p_, self.cfg.d_model), dtype=self.cfg.dtype,
                                 device=self.device)

            @torch.no_grad()
            def fn():
                with self.scope():
                    T.prefill_vision(self.params, inputs, cache, self.cfg, max_len)
                return flat
            return CompiledStep(self.steps, key, fn, inputs, flat, cache)

        key = self._key("prefill_vision", 1, p_, max_len)
        return self.steps.get(key, build)

    def prefill_fn(self, seq: int, max_len: int) -> CompiledStep:
        """The fused prefill of a ``seq``-token prompt (the reference's
        ``prefill_fn``, one step per prompt length as its jit retraces per
        shape): one forward over the whole prompt writes every layer's
        cache into ``staging_cache(max_len)``, every byte of it
        (``transformer.prefill(cache=)``). Inputs: the (1, seq) tokens. It
        returns the (1, 1, vocab) last logits. An encoder-decoder or vision
        config is refused: the engine admits those in chunks."""
        from repro_torch.models import transformer as T

        if self.cfg.encoder_layers or self.cfg.vision_tokens:
            raise ValueError(f"{self.cfg.name} admits in chunks: prefill_fn takes no "
                             "encoder input or vision prefix")
        if not 0 < seq <= max_len:
            raise ValueError(f"a prompt of {seq} tokens does not fit max_len {max_len}")

        def build():
            flat, cache = self.staging_cache(max_len)
            inputs = torch.zeros((1, seq), dtype=torch.int64, device=self.device)

            @torch.no_grad()
            def fn():
                with self.scope():
                    return T.prefill(self.params, inputs, self.cfg, max_len, cache=cache)[0]
            return CompiledStep(self.steps, key, fn, inputs, flat, cache)

        key = self._key("prefill", 1, seq, max_len)
        return self.steps.get(key, build)

    def prefill_chunk_fn(self, width: int, max_len: int, src_len: int = 0) -> CompiledStep:
        """The admission chunk of bucket ``width``: advances
        ``staging_cache(max_len, src_len)`` by tokens at ``pos0 .. pos0 +
        n_valid``. Inputs: the (1, width) tokens, then ``pos0`` and
        ``n_valid``."""
        from repro_torch.models import transformer as T

        def build():
            flat, cache = self.staging_cache(max_len, src_len)
            inputs = torch.zeros((width + 2,), dtype=torch.int64, device=self.device)
            tokens = inputs[:width].view(1, width)
            pos0, n_valid = inputs[width:width + 1], inputs[width + 1:]

            @torch.no_grad()
            def fn():
                with self.scope():
                    return T.prefill_chunk(self.params, tokens, cache, pos0, n_valid,
                                           self.cfg, max_len)[0]
            return CompiledStep(self.steps, key, fn, inputs, flat, cache)

        key = self._key("prefill_chunk", 1, width, max_len, src_len)
        return self.steps.get(key, build)

    def compile_count(self) -> int:
        """Steps compiled so far: CUDA graphs captured on the card, steps
        built on the CPU. Flat across repeated same-shape requests."""
        return self.steps.compile_count()

    def prefill(self, tokens, max_len: int, enc_embeds=None, patch_embeds=None):
        with self.scope():
            return prefill_and_cache(self.params, tokens, self.cfg, max_len, enc_embeds,
                                     patch_embeds, mesh=self.mesh)

    def generate(self, prompt, *, gen_len: int = 16, temperature: float = 0.0,
                 key: Optional[torch.Generator] = None, enc_embeds=None, patch_embeds=None
                 ) -> Tuple[np.ndarray, float]:
        """Each prompt row becomes one request on a throwaway engine, all
        admitted at tick 0 — the production serving path; an
        encoder-decoder config takes ``enc_embeds`` (B, S_src, d) and a
        vision config ``patch_embeds`` (B, P, d), numpy arrays: row ``i`` is
        request ``i``'s encoder input or image."""
        from repro_torch.deploy.engine import ServeEngine

        key = self._sampling_key(temperature, key)
        prompt = np.asarray(torch.as_tensor(prompt).cpu())
        b, s = prompt.shape
        src_len = 0 if enc_embeds is None else enc_embeds.shape[1]
        prefix = 0 if patch_embeds is None else patch_embeds.shape[1]
        engine = ServeEngine(self, max_slots=b, max_len=prefix + s + gen_len, src_len=src_len)
        reqs = [engine.submit(
                    prompt[i], max_new=gen_len, temperature=temperature,
                    key=None if key is None else _fold(key, i),
                    enc_embeds=None if enc_embeds is None else enc_embeds[i],
                    patch_embeds=None if patch_embeds is None else patch_embeds[i])
                for i in range(b)]
        engine.run()
        toks = np.stack([np.asarray(r.tokens, np.int32) for r in reqs])
        return toks, engine.decode_seconds

    def describe(self) -> str:
        """Resident RRAM bytes, SRAM side-car bytes and the calibrated
        fraction, read from the deployment's own (unprepared) trees."""
        dep = self.deployment
        kind = "measured resident" if self.backend != "dequant" else "estimated"
        return (
            f"backend={self.backend} device={self.device} "
            f"rram_bytes={dep.rram_bytes()} ({kind}) "
            f"sram_bytes={dep.sram_bytes()} "
            f"calibrated_params={dep.calibrated_fraction():.2%}"
        )
