"""Attention over RimcLinear projections. Port of the dense half of
``repro/models/attention.py``: MHA/GQA with optional qk-norm (qwen3),
causal and sliding-window masks, the per-slot KV cache, decode and
chunked prefill. MLA, cross-attention and the vision prefix wait.

Attention is plain PyTorch here, as it is plain jnp in the reference;
``_sdpa`` mirrors its precision: logits and probabilities in the compute
dtype, max and sum in f32.

The decode and chunk paths write K/V into the cache IN PLACE (the
reference builds new buffers): the cache tensors passed in are updated
and returned.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dora import AdapterConfig
from repro_torch.models import layers as L

NEG_INF = -2.3819763e38  # the reference's mask constant; finite in bf16


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    window: Optional[int] = None
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        if self.softmax_scale is not None:
            return self.softmax_scale
        return self.head_dim ** -0.5


def init_attention(generator: torch.Generator, cfg: AttentionConfig,
                   acfg: AdapterConfig, dtype=torch.bfloat16) -> Tuple[Dict, Dict]:
    base: Dict = {}
    adapters: Dict = {}
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    for name, d_in, d_out in (("q", cfg.d_model, nq), ("k", cfg.d_model, nkv),
                              ("v", cfg.d_model, nkv), ("o", nq, cfg.d_model)):
        base[name], adapters[name] = L.init_linear(
            generator, d_in, d_out, acfg, dtype=dtype)
    if cfg.qk_norm:
        base["q_norm"] = L.init_rmsnorm(cfg.head_dim, generator.device)
        base["k_norm"] = L.init_rmsnorm(cfg.head_dim, generator.device)
    return base, adapters


def _qkv_proj(x, base, a, cfg: AttentionConfig, acfg):
    """(q, k, v): one launch when the serve tree fused them ("_qkv")."""
    if "_qkv" in base:
        qkv = L.linear(x, base["_qkv"], None, acfg)
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        return qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    return (
        L.linear(x, base["q"], a.get("q"), acfg),
        L.linear(x, base["k"], a.get("k"), acfg),
        L.linear(x, base["v"], a.get("v"), acfg),
    )


def causal_mask(q_len: int, kv_len: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) bool; queries are the last q_len kv positions."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = kv_pos <= q_pos
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    return mask


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float. Multiplying a
    ``dtype`` tensor by it rounds the exact product once, as the
    reference's ``x * jnp.asarray(value, dtype)`` does, and a Python
    scalar needs no host-to-device copy."""
    return float(torch.tensor(value, dtype=dtype))


def _sdpa(q, k, v, scale: float, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, T, KVH, d); mask broadcastable to
    (B, KVH, G, S, T). Grouped-query attention."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k) * _rounded(scale, q.dtype)
    if mask is not None:
        while mask.dim() < logits.dim():
            mask = mask[None]
        logits = torch.where(mask, logits, _rounded(NEG_INF, logits.dtype))
    lmax = torch.amax(logits.to(torch.float32), dim=-1, keepdim=True)
    p = torch.exp(logits - lmax.to(logits.dtype))
    denom = torch.sum(p.to(torch.float32), dim=-1, keepdim=True)
    probs = (p / denom.to(p.dtype)).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, -1)


def _project(x, base, a, cfg: AttentionConfig, acfg, positions):
    """q, k, v with head layout, qk-norm and rope applied."""
    b_, s, _ = x.shape
    q, k, v = _qkv_proj(x, base, a, cfg, acfg)
    q = q.reshape(b_, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b_, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b_, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, base["q_norm"])
        k = L.rms_norm(k, base["k_norm"])
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(x, base, adapters, cfg: AttentionConfig, acfg: AdapterConfig,
              positions: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None, return_kv: bool = False):
    """Full-sequence causal self-attention (training / prefill)."""
    a = adapters or {}
    b_, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project(x, base, a, cfg, acfg, positions)
    if mask is None:
        mask = causal_mask(s, s, cfg.window, device=x.device)
    out = _sdpa(q, k, v, cfg.scale, mask)
    y = L.linear(out.reshape(b_, s, -1), base["o"], a.get("o"), acfg)
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig, device,
                  dtype=torch.bfloat16) -> Dict:
    """One layer's cache; sliding-window layers keep only the window."""
    length = max_len if cfg.window is None else min(cfg.window, max_len)
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _as_pos_vector(pos, batch: int, device) -> torch.Tensor:
    """Per-slot clocks as a (B,) int64 tensor; a scalar broadcasts."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    if pos.dim() == 0:
        pos = pos.expand(batch)
    return pos


def _cache_write(buf: torch.Tensor, val: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write one position per batch row (in place) at ``pos[b] % length``."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, pos % buf.shape[1]] = val[:, 0].to(buf.dtype)
    return buf


def _cache_mask(pos: torch.Tensor, length: int, window: Optional[int]) -> torch.Tensor:
    """(B, length) valid entries after writing position ``pos[b]``."""
    idx = torch.arange(length, device=pos.device)[None, :]
    valid = idx <= pos[:, None]
    if window is not None:
        valid = valid | (pos >= length)[:, None]
    return valid


def prefill_kv_cache(kv: Dict, batch: int, max_len: int, cfg: AttentionConfig,
                     dtype=torch.bfloat16) -> Dict:
    """A fresh decode cache holding full-sequence prefill K/V; rolling
    buffers keep the last ``length`` positions at their wrapped slots."""
    device = kv["k"].device
    cache = init_kv_cache(batch, max_len, cfg, device, dtype)
    s = kv["k"].shape[1]
    for name, buf in cache.items():
        length = buf.shape[1]
        start = max(0, s - length)
        idx = torch.arange(start, s, device=device)
        buf[:, idx % length] = kv[name][:, start:].to(buf.dtype)
    return cache


def decode_attention(x, cache: Dict, pos, base, adapters, cfg: AttentionConfig,
                     acfg: AdapterConfig) -> Tuple[torch.Tensor, Dict]:
    """One token per row against the cache; row b at clock ``pos[b]``."""
    a = adapters or {}
    b_ = x.shape[0]
    pos = _as_pos_vector(pos, b_, x.device)
    q, k, v = _project(x, base, a, cfg, acfg, pos[:, None])
    k_buf = _cache_write(cache["k"], k, pos)
    v_buf = _cache_write(cache["v"], v, pos)
    valid = _cache_mask(pos, k_buf.shape[1], cfg.window)
    out = _sdpa(q, k_buf, v_buf, cfg.scale, valid[:, None, None, None, :])
    y = L.linear(out.reshape(b_, 1, -1), base["o"], a.get("o"), acfg)
    return y, {"k": k_buf, "v": v_buf}


def chunk_attention(x, cache: Dict, pos0, n_valid, base, adapters,
                    cfg: AttentionConfig, acfg: AdapterConfig, *,
                    max_len: int) -> Tuple[torch.Tensor, Dict]:
    """Advance the cache by one C-token chunk (padded tail allowed):
    write the valid rows' K/V at their absolute positions, attend each
    query against everything written so far."""
    a = adapters or {}
    b_, c, _ = x.shape
    length = cache["k"].shape[1]
    if length < max_len:
        raise NotImplementedError(
            "chunked prefill into a rolling (sliding-window) cache is not ported"
        )
    pos0 = _as_pos_vector(pos0, b_, x.device)
    n_valid = _as_pos_vector(n_valid, b_, x.device)
    i = torch.arange(c, device=x.device)[None, :]
    positions = pos0[:, None] + i                      # (B, C)
    q, k, v = _project(x, base, a, cfg, acfg, positions)
    live = i < n_valid[:, None]                        # padded tail is dropped
    rows = torch.arange(b_, device=x.device)[:, None].expand(b_, c)
    cache["k"][rows[live], positions[live]] = k[live].to(cache["k"].dtype)
    cache["v"][rows[live], positions[live]] = v[live].to(cache["v"].dtype)
    j = torch.arange(length, device=x.device)[None, None, :]
    allow = j <= positions[:, :, None]                 # (B, C, T)
    if cfg.window is not None:
        allow = allow & (j > positions[:, :, None] - cfg.window)
    out = _sdpa(q, cache["k"], cache["v"], cfg.scale, allow[:, None, None])
    y = L.linear(out.reshape(b_, c, -1), base["o"], a.get("o"), acfg)
    return y, {"k": cache["k"], "v": cache["v"]}
