"""Serving half of the deployment lifecycle: backend scoping, fused
prefill, the reference generation loop and ``ServeSession``. Port of
``repro/deploy/serving.py``.

PyTorch runs eagerly, so the reference's compiled-step registry has no
counterpart here; the engine still buckets chunk widths to powers of two
so that a later CUDA-graph slice captures a bounded set of shapes.
Everything runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import substrate

BACKENDS = ("dequant", "codes")


def backend_scope(backend: str):
    """Context manager binding the substrate backend (every backend binds
    explicitly, ``dequant`` included)."""
    return substrate.use_backend(backend)


@torch.no_grad()
def prefill_and_cache(params, tokens: torch.Tensor, cfg, max_len: int):
    """Fused prefill: ONE forward over the prompt fills every layer's K/V.
    Returns ``(last_logits (B, 1, V), cache)``."""
    from repro_torch.models import transformer as T

    return T.prefill(params, tokens, cfg, int(max_len))


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
             temperature: float = 0.0, key: Optional[torch.Generator] = None
             ) -> Tuple[np.ndarray, float]:
    """Reference single-stream loop: fused prefill, then ``gen_len - 1``
    decode steps. Returns ``(tokens (B, gen_len), dt)``; ``dt`` covers
    the decode steps only (each ends in a device-to-host token copy)."""
    from repro_torch.models import transformer as T

    _check_sampling_args(temperature, key)
    if gen_len < 1:
        raise ValueError(f"gen_len must be >= 1, got {gen_len}")
    b, s = prompt.shape
    logits, cache = prefill_and_cache(params, prompt, cfg, s + gen_len)
    tok, key = _next_token(logits, temperature, key)
    out = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        pos = torch.full((b,), s + i, dtype=torch.int64, device=prompt.device)
        logits, cache = T.decode_step(params, cache, tok, pos, cfg)
        tok, key = _next_token(logits, temperature, key)
        out.append(tok.cpu().numpy())
    dt = time.perf_counter() - t0
    return np.concatenate(out, axis=1).astype(np.int32), dt


def _fold(generator: torch.Generator, i: int) -> torch.Generator:
    """An independent generator for request ``i`` of one call."""
    from repro_torch.core.rram import make_generator

    return make_generator(generator.device, generator.initial_seed(), i)


class ServeSession:
    """A deployment bound for serving: adapters merged, backend scope
    applied around every call. ``params`` is the ``{"base", "adapters"}``
    tree the transformer consumes."""

    def __init__(self, deployment, params):
        self.deployment = deployment
        self.params = params
        self._auto_key_calls = 0

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
        return backend_scope(self.backend)

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

    def prefill(self, tokens, max_len: int):
        with self.scope():
            return prefill_and_cache(self.params, tokens, self.cfg, max_len)

    def generate(self, prompt, *, gen_len: int = 16, temperature: float = 0.0,
                 key: Optional[torch.Generator] = None) -> Tuple[np.ndarray, float]:
        """Each prompt row becomes one request on a throwaway engine, all
        admitted at tick 0 — the production serving path."""
        from repro_torch.deploy.engine import ServeEngine

        key = self._sampling_key(temperature, key)
        prompt = np.asarray(torch.as_tensor(prompt).cpu())
        b, s = prompt.shape
        engine = ServeEngine(self, max_slots=b, max_len=s + gen_len)
        reqs = [engine.submit(
                    prompt[i], max_new=gen_len, temperature=temperature,
                    key=None if key is None else _fold(key, i))
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
