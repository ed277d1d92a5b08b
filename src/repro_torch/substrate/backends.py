"""Pluggable execution backends over resident crossbar codes. Port of
``repro/substrate/backends.py`` (``codes_adc`` waits with its kernel).

* ``codes``   — the deployment path: the fused CUDA kernel reads the
                uint8 codes and applies the DoRA epilogue.
* ``dequant`` — read the codes back to floats per call and run plain
                PyTorch (differentiable w.r.t. the adapters).

``use_backend`` binds the ambient backend for ``CrossbarWeight`` leaves;
``models/layers.py::linear`` dispatches here for every such leaf. The
ambient binding is per thread.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from repro_torch.core import dora as dora_lib
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import CrossbarWeight, dequantize
from repro_torch.substrate import exec as X
from repro_torch.substrate.prepared import (
    PreparedCrossbar,
    prepared_ref_forward,
    rimc_linear_prepared,
)

DEFAULT_BACKEND = "codes"

_REGISTRY: Dict[str, "Backend"] = {}
_ACTIVE = threading.local()


class Backend:
    """One way to execute Y = f(X, resident codes, adapter)."""

    name: str = "abstract"

    def linear(self, x, xw, adapter: Optional[dict], acfg: AdapterConfig):
        raise NotImplementedError


def register_backend(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown substrate backend {name!r}; "
            f"available: {available_backends()}"
        ) from None


def available_backends():
    return tuple(sorted(_REGISTRY))


@contextlib.contextmanager
def use_backend(name: str):
    """Bind the ambient backend for ``CrossbarWeight``/``PreparedCrossbar``
    leaves."""
    get_backend(name)
    prev = getattr(_ACTIVE, "name", None)
    _ACTIVE.name = name
    try:
        yield
    finally:
        _ACTIVE.name = prev


def active_backend_name() -> str:
    return getattr(_ACTIVE, "name", None) or DEFAULT_BACKEND


def crossbar_linear(x, xw, adapter: Optional[dict], acfg: AdapterConfig, *,
                    backend: Optional[str] = None):
    """Execute one RimcLinear over resident codes through the selected
    backend (explicit ``backend=`` ignores the ambient scope)."""
    name = backend if backend is not None else active_backend_name()
    return get_backend(name).linear(x, xw, adapter or {}, acfg)


def _gamma_for(xw: CrossbarWeight, adapter: dict, acfg) -> Optional[torch.Tensor]:
    """(1, N) DoRA epilogue scale, or None for LoRA/no adapter."""
    if not adapter or acfg.kind != "dora":
        return None
    if "dora_m_merged" in adapter:
        return adapter["dora_m_merged"].to(torch.float32)[None, :]
    return X.dora_gamma(xw, adapter)


def _zero_adapter(k: int, n: int, device) -> dict:
    """Rank-1 all-zero side-car: the fused kernel serves adapter-less
    layers without a second kernel."""
    return {
        "lora_a": torch.zeros((k, 1), dtype=torch.float32, device=device),
        "lora_b": torch.zeros((1, n), dtype=torch.float32, device=device),
    }


@register_backend
class DequantBackend(Backend):
    """Read the codes back to floats per call; plain PyTorch forward."""

    name = "dequant"

    def linear(self, x, xw, adapter, acfg):
        if isinstance(xw, PreparedCrossbar):
            return prepared_ref_forward(x, xw)
        return dora_lib.adapted_forward(x, dequantize(xw), adapter, acfg)


@register_backend
class CodesBackend(Backend):
    """Deployment path: the fused CUDA kernel over resident uint8 codes
    (its plain version for tensors on the CPU)."""

    name = "codes"

    def linear(self, x, xw, adapter, acfg):
        if isinstance(xw, PreparedCrossbar):
            return rimc_linear_prepared(x, xw)
        gamma = _gamma_for(xw, adapter, acfg)
        k, n = xw.g_pos.shape[-2:]
        if not adapter or acfg.kind == "none":
            adapter = _zero_adapter(k, n, xw.g_pos.device)
        if gamma is None:
            gamma = torch.ones((1, n), dtype=torch.float32, device=xw.g_pos.device)
        return X.rimc_linear(x, xw, adapter, gamma)
