"""Pluggable execution backends over resident crossbar codes. Port of
``repro/substrate/backends.py``.

* ``codes``     — the deployment path: the fused CUDA kernel reads the
                  uint8 codes and applies the DoRA epilogue (option
                  ``accum="f32"|"int8"`` picks its body).
* ``dequant``   — read the codes back to floats per call and run plain
                  PyTorch (differentiable w.r.t. the adapters).
* ``codes_adc`` — the ADC-faithful crossbar kernel (a saturating ADC per
                  256-row array tile), then the DoRA low-rank path and
                  magnitude applied digitally (options ``rram_cfg``,
                  ``code_max``, ``adc_bits``).

``use_backend(name, **options)`` binds the ambient backend and its
options for ``CrossbarWeight`` leaves; ``models/layers.py::linear``
dispatches here for every such leaf. The ambient binding is per thread.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from repro_torch.core import dora as dora_lib
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import CrossbarWeight, RramConfig, dequantize
from repro_torch.substrate import exec as X
from repro_torch.substrate import prepared as P
from repro_torch.substrate.prepared import (
    PreparedCrossbar,
    ShardedPrepared,
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
def use_backend(name: str, **options):
    """Bind the ambient backend, and the keyword ``options`` its
    ``linear`` takes, for ``CrossbarWeight``/``PreparedCrossbar`` leaves."""
    get_backend(name)
    prev = getattr(_ACTIVE, "val", None)
    _ACTIVE.val = (name, options)
    try:
        yield
    finally:
        _ACTIVE.val = prev


def active_backend_name() -> str:
    val = getattr(_ACTIVE, "val", None)
    return val[0] if val else DEFAULT_BACKEND


def active_options() -> dict:
    """The ambient backend's options (empty outside any scope)."""
    val = getattr(_ACTIVE, "val", None)
    return dict(val[1]) if val else {}


def active_backend_key() -> tuple:
    """Hashable ``(name, sorted options)`` identity of the ambient
    backend: what the serving step registry keys on, since the options
    change what a step computes as the name does (``accum="int8"`` against
    the f32 body)."""
    val = getattr(_ACTIVE, "val", None)
    name, options = val if val else (DEFAULT_BACKEND, {})
    return (name, tuple(sorted(options.items())))


def crossbar_linear(x, xw, adapter: Optional[dict], acfg: AdapterConfig, *,
                    backend: Optional[str] = None):
    """Execute one RimcLinear over resident codes through the selected
    backend. An explicit ``backend=`` ignores the ambient scope and its
    options; the ambient scope's options go to the backend's ``linear``."""
    if backend is not None:
        return get_backend(backend).linear(x, xw, adapter or {}, acfg)
    return get_backend(active_backend_name()).linear(
        x, xw, adapter or {}, acfg, **active_options())


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
        if isinstance(xw, ShardedPrepared):
            raise TypeError(
                "dequant reads full-extent prepared leaves; a sharded "
                "serve tree only executes inside the codes backend's "
                "tensor-parallel steps"
            )
        if isinstance(xw, PreparedCrossbar):
            return prepared_ref_forward(x, xw)
        return dora_lib.adapted_forward(x, dequantize(xw), adapter, acfg)


@register_backend
class CodesBackend(Backend):
    """Deployment path: the fused CUDA kernel over resident uint8 codes
    (its plain version for tensors on the CPU). A ``ShardedPrepared`` leaf
    runs the kernel on this rank's column block, planned for the whole
    leaf, then gathers the columns over the rank's subgroup
    (``prepared.tp_column_allgather``): bitwise the unsharded launch."""

    name = "codes"

    def linear(self, x, xw, adapter, acfg, *, accum="f32"):
        if isinstance(xw, ShardedPrepared):
            y = rimc_linear_prepared(x, xw.local, accum=accum, plan_n=xw.n_total)
            return P.tp_column_allgather(y, xw.n_total, xw.group)
        if isinstance(xw, PreparedCrossbar):
            return rimc_linear_prepared(x, xw, accum=accum)
        gamma = _gamma_for(xw, adapter, acfg)
        k, n = xw.g_pos.shape[-2:]
        if not adapter or acfg.kind == "none":
            adapter = _zero_adapter(k, n, xw.g_pos.device)
        if gamma is None:
            gamma = torch.ones((1, n), dtype=torch.float32, device=xw.g_pos.device)
        return X.rimc_linear(x, xw, adapter, gamma, accum=accum)


_ADC_DEFAULTS = RramConfig()


def resolve_adc_limits(rram_cfg, code_max, adc_bits):
    """The ADC limits ``(code_max, adc_bits)`` of ``codes_adc``: the
    deployment's ``RramConfig`` when given (an explicit value that
    conflicts with it raises), else the explicit values, else the
    defaults of ``RramConfig()``."""
    if rram_cfg is not None:
        for name, explicit, want in (
            ("code_max", code_max, rram_cfg.code_max),
            ("adc_bits", adc_bits, rram_cfg.adc_bits),
        ):
            if explicit is not None and int(explicit) != int(want):
                raise ValueError(
                    f"codes_adc {name}={explicit} conflicts with the "
                    f"deployment's RramConfig.{name}={want}; the RramConfig "
                    f"is the single source of truth — drop the override or "
                    f"change the config"
                )
        return int(rram_cfg.code_max), int(rram_cfg.adc_bits)
    return (
        int(_ADC_DEFAULTS.code_max if code_max is None else code_max),
        int(_ADC_DEFAULTS.adc_bits if adc_bits is None else adc_bits),
    )


@register_backend
class CodesAdcBackend(Backend):
    """ADC-faithful analog chain: the saturating ADC per 256-row array
    activation (``kernels/crossbar_mvm.py``), its output rounded to x's
    dtype, then the DoRA low-rank path and magnitude applied digitally in
    f32 — the paper's periphery split. Reads raw per-leaf codes."""

    name = "codes_adc"

    def linear(self, x, xw, adapter, acfg, *, rram_cfg=None, code_max=None,
               adc_bits=None):
        code_max, adc_bits = resolve_adc_limits(rram_cfg, code_max, adc_bits)
        if isinstance(xw, (PreparedCrossbar, ShardedPrepared)):
            raise TypeError(
                "codes_adc reads raw per-leaf codes; prepared (fused) trees "
                "are codes-backend serving artifacts"
            )
        y = X.rimc_mvm_adc(x, xw, code_max=code_max, adc_bits=adc_bits)
        y = y.to(torch.float32)
        if adapter and "lora_a" in adapter:
            a = adapter["lora_a"].to(torch.float32)
            b = adapter["lora_b"].to(torch.float32)
            y = y + (x.to(torch.float32) @ a) @ b
        gamma = _gamma_for(xw, adapter, acfg)
        if gamma is not None:
            y = y * gamma
        return y.to(x.dtype)
