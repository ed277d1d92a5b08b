"""DoRA / LoRA adapters for RIMC calibration (paper §III-C, Algorithm 2).
Port of ``repro/core/dora.py``: the linear adapters, their int8 PTQ and
parameter count, and the conv adapters of the ResNet reproduction.

  LoRA:  Y = X @ W_r + (X @ A) @ B                            (eq. 5)
  DoRA:  Y = M ∘ normalize(X @ W_r + (X @ A) @ B)             (training)
         Y = M' ∘ (X @ W_r + (X @ A) @ B),  M' = M / ||W_r + A@B||_col

A is kaiming-uniform, B starts at zero and M at the column norm of the
drifted base, so a fresh adapter is output-preserving.

A conv weight (kh, kw, cin, cout), HWIO as in the reference, is the
matmul weight (kh*kw*cin, cout) over im2col patches: the low-rank path is
a (kh, kw, cin, r) conv with the base's stride and padding, then ``@ B``,
and M scales output channels. Activations are NHWC; the convs run NCHW
inside (``conv2d_nhwc``) with JAX's "SAME" pads, which put the odd pixel
after (a stride-2 3x3 conv on an even input pads 0 before, 1 after).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import _div


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    rank: int = 4
    kind: str = "dora"          # 'dora' | 'lora' | 'none'
    dtype: torch.dtype = torch.float32


def param_ratio(d: int, k: int, r: int) -> float:
    """Eq. 7: proportion of new parameters introduced by DoRA."""
    return (d * r + r * k + k) / (d * k)


def _init(generator, a_shape, d: int, k: int, cfg: AdapterConfig, w_base,
          uniforms) -> dict:
    """A = U(-1/sqrt(d), 1/sqrt(d)) of ``a_shape`` from ``uniforms`` (U(0,
    1) draws) or ``generator``, B = 0 (r, k), M = the column norms of
    ``w_base`` as (d, k)."""
    if cfg.kind == "none":
        return {}
    device = uniforms.device if uniforms is not None else generator.device
    bound = 1.0 / math.sqrt(d)
    u = uniforms if uniforms is not None else torch.rand(
        a_shape, generator=generator, device=device, dtype=torch.float32)
    # jax.random.uniform's max(lo, u * (hi - lo) + lo), its multiply-add
    # rounded once as XLA's fused one is: exact in f64, then to f32
    lo = torch.tensor(-bound, dtype=torch.float32, device=device)
    span = torch.tensor(bound, dtype=torch.float32, device=device) - lo
    a = (u.to(torch.float64) * span.to(torch.float64) + lo.to(torch.float64)).to(torch.float32)
    a = torch.maximum(a, lo).to(cfg.dtype)
    b = torch.zeros((cfg.rank, k), dtype=cfg.dtype, device=device)
    out = {"lora_a": a, "lora_b": b}
    if cfg.kind == "dora":
        if w_base is not None:
            m = torch.linalg.vector_norm(w_base.to(torch.float32).reshape(-1, k), dim=0)
        else:
            m = torch.ones((k,), dtype=torch.float32, device=device)
        out["dora_m"] = m.to(cfg.dtype)
    return out


def init_adapter(
    generator: Optional[torch.Generator],
    d: int,
    k: int,
    cfg: AdapterConfig,
    w_base: Optional[torch.Tensor] = None,
    *,
    uniforms: Optional[torch.Tensor] = None,
) -> dict:
    """(A, B, M) per Algorithm 2 line 2, on ``generator``'s device (or
    ``uniforms``', the (d, r) U(0, 1) draws of A when given)."""
    return _init(generator, (d, cfg.rank), d, k, cfg, w_base, uniforms)


def column_norm(
    w_base: torch.Tensor, a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """||W_r + A@B||_2 per column without forming W + A@B:
    norm² = colnorm²(W) + 2·col(Wᵀ(A@B)) + colnorm²(A@B)."""
    wf = w_base.to(torch.float32)
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    w_sq = torch.sum(wf * wf, dim=0)
    wta = wf.T @ af                                   # (k, r)
    cross = torch.einsum("kr,rk->k", wta, bf)
    ab_sq = torch.sum((af @ bf) ** 2, dim=0)
    return torch.sqrt(torch.clamp_min(w_sq + 2.0 * cross + ab_sq, eps))


def adapted_forward(
    x: torch.Tensor,
    w_base: torch.Tensor,
    adapter: dict,
    cfg: AdapterConfig,
    *,
    merged_norm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Base + adapter forward (Algorithm 2 lines 5-7) in ``x``'s dtype.
    A merged adapter (``dora_m_merged``) applies its static per-column
    scale; otherwise the norm is ``merged_norm`` or recomputed."""
    dt = x.dtype
    y = x @ w_base.to(dt)
    if cfg.kind == "none" or not adapter:
        return y
    y = y + (x @ adapter["lora_a"].to(dt)) @ adapter["lora_b"].to(dt)
    if cfg.kind == "lora":
        return y
    if "dora_m_merged" in adapter:
        return y * adapter["dora_m_merged"].to(dt)
    m = adapter["dora_m"].to(torch.float32)
    norm = (
        column_norm(w_base, adapter["lora_a"], adapter["lora_b"])
        if merged_norm is None else merged_norm
    )
    return y * (m / norm).to(dt)


def merge_magnitude(
    w_base: torch.Tensor, adapter: dict, cfg: AdapterConfig
) -> Optional[torch.Tensor]:
    """Algorithm 2 line 12: ||W_r + A@B|| for inference, or None for
    non-DoRA adapters."""
    if cfg.kind != "dora" or not adapter:
        return None
    return column_norm(w_base, adapter["lora_a"], adapter["lora_b"])


def quantize_adapter_int8(adapter: dict) -> dict:
    """Paper §III-C: adapters are stored int8 at inference. Symmetric
    per-tensor PTQ: ``{name: (codes_int8, scale_f32)}``. Both divisions
    are by a tensor, so the card's codes are the CPU's."""
    out = {}
    for name, v in adapter.items():
        absmax = torch.clamp_min(v.abs().amax(), 1e-8)
        scale = _div(absmax, 127.0)
        codes = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
        out[name] = (codes, scale)
    return out


def dequantize_adapter_int8(qadapter: dict, dtype=torch.float32) -> dict:
    return {name: (codes.to(torch.float32) * scale).to(dtype)
            for name, (codes, scale) in qadapter.items()}


def adapter_param_count(d: int, k: int, cfg: AdapterConfig) -> int:
    if cfg.kind == "none":
        return 0
    n = d * cfg.rank + cfg.rank * k
    if cfg.kind == "dora":
        n += k
    return n


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """JAX's "SAME" pads of one spatial axis: out = ceil(size / s), the
    total ``max((out - 1) * s + k - size, 0)``, its odd pixel after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1),
                padding: str = "SAME") -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, stride, padding)`` with NHWC ``x``
    and HWIO ``w``; NHWC out."""
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[1], kh, stride[0]),
                          same_pads(x.shape[2], kw, stride[1]))
        if t or b or l or r:
            xc = F.pad(xc, (l, r, t, b))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride))
    return y.permute(0, 2, 3, 1)


def init_conv_adapter(
    generator: Optional[torch.Generator],
    kh: int,
    kw: int,
    cin: int,
    cout: int,
    cfg: AdapterConfig,
    w_base: Optional[torch.Tensor] = None,
    *,
    uniforms: Optional[torch.Tensor] = None,
) -> dict:
    """The conv adapter: A (kh, kw, cin, r), B (r, cout), M (cout,) the
    column norms of the (kh*kw*cin, cout) base; ``uniforms`` are A's U(0,
    1) draws when given."""
    return _init(generator, (kh, kw, cin, cfg.rank), kh * kw * cin, cout, cfg, w_base,
                 uniforms)


def conv_column_norm(w_base: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """||W + A@B||_2 per output channel, W and A as (kh*kw*cin, .)."""
    cout = w_base.shape[-1]
    wf = w_base.to(torch.float32).reshape(-1, cout)
    ab = a.to(torch.float32).reshape(-1, a.shape[-1]) @ b.to(torch.float32)
    return torch.sqrt(torch.clamp_min(torch.sum((wf + ab) ** 2, dim=0), eps))


def adapted_conv_forward(
    x: torch.Tensor,
    w_base: torch.Tensor,
    adapter: dict,
    cfg: AdapterConfig,
    *,
    stride: Sequence[int] = (1, 1),
    padding: str = "SAME",
) -> torch.Tensor:
    """NHWC conv through the drifted base and its DoRA/LoRA side-car."""
    y = conv2d_nhwc(x, w_base.to(x.dtype), stride, padding)
    if cfg.kind == "none" or not adapter:
        return y
    xa = conv2d_nhwc(x, adapter["lora_a"].to(x.dtype), stride, padding)
    y = y + xa @ adapter["lora_b"].to(x.dtype)
    if cfg.kind == "lora":
        return y
    m = adapter["dora_m"].to(torch.float32)
    norm = conv_column_norm(w_base, adapter["lora_a"], adapter["lora_b"])
    return y * (m / norm).to(x.dtype)
