"""Attention over RimcLinear projections. Port of
``repro/models/attention.py``: MHA/GQA with optional qk-norm (qwen3),
causal and sliding-window masks, the prefix-LM mask of a vision prefix
(paligemma: keys below the prefix open to every query), the per-slot
KV cache (rolling for sliding-window layers), decode and chunked
prefill; cross-attention over an encoder's output (seamless-m4t), whose
K/V the serving cache holds once per decoder layer (``"xk"``/``"xv"``),
masked per slot by the valid source length; and MLA, multi-head latent attention
(deepseek-v2-lite): a low-rank joint KV compression whose post-norm
latent and shared roped key are what the cache holds, up-projected to
per-head K and V over the whole buffer at every step (the reference's
non-absorbed form).

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
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import dora
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
    is_cross: bool = False  # cross-attention: K/V from the encoder's output
    softmax_scale: Optional[float] = None
    # MLA (deepseek-v2): low-rank KV joint compression + decoupled rope
    mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def scale(self) -> float:
        if self.softmax_scale is not None:
            return self.softmax_scale
        if self.mla:
            return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
        return self.head_dim ** -0.5


def init_attention(generator: Optional[torch.Generator], cfg: AttentionConfig,
                   acfg: AdapterConfig, dtype=torch.bfloat16, *,
                   draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[Dict, Dict]:
    """``draws`` (MLA only) gives the draws instead of ``generator``, as
    ``_init_mla`` takes them."""
    if cfg.mla:
        return _init_mla(generator, cfg, acfg, dtype, draws=draws)
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


def _init_mla(generator: Optional[torch.Generator], cfg: AttentionConfig,
              acfg: AdapterConfig, dtype, *,
              draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[Dict, Dict]:
    """Leaves ``q`` (full-rank, as in the lite model), ``kv_down`` (d ->
    kv_lora + the shared rope key's dims), ``kv_norm``, ``k_up``, ``v_up``
    and ``o``. ``draws`` gives, per leaf, the standard normals (d_in,
    d_out) under its name and A's U(0, 1) draws (d_in, r) under
    ``"<name>/lora_a"``."""
    device = generator.device if draws is None else next(iter(draws.values())).device
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    h = cfg.num_heads
    base: Dict = {}
    adapters: Dict = {}
    for name, d_in, d_out in (
            ("q", cfg.d_model, h * qk_head),
            ("kv_down", cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            ("k_up", cfg.kv_lora_rank, h * cfg.qk_nope_head_dim),
            ("v_up", cfg.kv_lora_rank, h * cfg.v_head_dim),
            ("o", h * cfg.v_head_dim, cfg.d_model)):
        if draws is None:
            base[name], adapters[name] = L.init_linear(generator, d_in, d_out, acfg,
                                                       dtype=dtype)
            continue
        w = (draws[name].to(torch.float32) * d_in ** -0.5).to(dtype)
        base[name] = {"w": w}
        adapters[name] = dora.init_adapter(None, d_in, d_out, acfg, w_base=w,
                                           uniforms=draws.get(f"{name}/lora_a"))
    base["kv_norm"] = L.init_rmsnorm(cfg.kv_lora_rank, device)
    return base, adapters


def _qkv_proj(x, kv_src, base, a, cfg: AttentionConfig, acfg):
    """(q, k, v): q from ``x``, k and v from ``kv_src`` (``x`` itself
    but for cross-attention); one launch when the serve tree fused them
    ("_qkv", self-attention only: cross trees keep their leaves)."""
    if "_qkv" in base:
        qkv = L.linear(x, base["_qkv"], None, acfg)
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        return qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    return (
        L.linear(x, base["q"], a.get("q"), acfg),
        L.linear(kv_src, base["k"], a.get("k"), acfg),
        L.linear(kv_src, base["v"], a.get("v"), acfg),
    )


def _mla_q_kv_proj(x, base, a, cfg: AttentionConfig, acfg):
    """(q, joint kv): one launch when the serve tree fused them ("_q_kvd")."""
    if "_q_kvd" in base:
        out = L.linear(x, base["_q_kvd"], None, acfg)
        nq = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        return out[..., :nq], out[..., nq:]
    return (L.linear(x, base["q"], a.get("q"), acfg),
            L.linear(x, base["kv_down"], a.get("kv_down"), acfg))


def _mla_up_proj(c_kv, base, a, cfg: AttentionConfig, acfg):
    """(k_nope, v) from the latent: one launch when fused ("_kup_vup")."""
    if "_kup_vup" in base:
        out = L.linear(c_kv, base["_kup_vup"], None, acfg)
        nk = cfg.num_heads * cfg.qk_nope_head_dim
        return out[..., :nk], out[..., nk:]
    return (L.linear(c_kv, base["k_up"], a.get("k_up"), acfg),
            L.linear(c_kv, base["v_up"], a.get("v_up"), acfg))


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


def _project(x, base, a, cfg: AttentionConfig, acfg, positions, kv_src=None):
    """q, k, v with head layout and qk-norm applied, and rope unless the
    attention is cross (K/V from ``kv_src``, never roped)."""
    b_, s, _ = x.shape
    kv_src = x if kv_src is None else kv_src
    t = kv_src.shape[1]
    q, k, v = _qkv_proj(x, kv_src, base, a, cfg, acfg)
    q = q.reshape(b_, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b_, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b_, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, base["q_norm"])
        k = L.rms_norm(k, base["k_norm"])
    if not cfg.is_cross:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(x, base, adapters, cfg: AttentionConfig, acfg: AdapterConfig,
              positions: Optional[torch.Tensor] = None,
              kv_input: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None, return_kv: bool = False):
    """Full-sequence attention (training / prefill): causal self-attention
    unless ``mask`` overrides it (the encoder passes an all-true one), or,
    for a cross config, bidirectional over ``kv_input`` (the encoder's
    output) by default."""
    a = adapters or {}
    b_, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.mla:
        return _mla_attention(x, base, a, cfg, acfg, positions, mask, return_kv)
    q, k, v = _project(x, base, a, cfg, acfg, positions,
                       kv_input if cfg.is_cross else None)
    if mask is None and not cfg.is_cross:
        mask = causal_mask(s, s, cfg.window, device=x.device)
    out = _sdpa(q, k, v, cfg.scale, mask)
    y = L.linear(out.reshape(b_, s, -1), base["o"], a.get("o"), acfg)
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def _mla_project(x, base, a, cfg: AttentionConfig, acfg, positions):
    """q (B, S, H, nope + rope) with its rope part roped, and what the
    cache holds: the post-norm latent (B, S, kv_lora) and the roped key
    shared across heads (B, S, rope)."""
    b_, s, _ = x.shape
    q, kv = _mla_q_kv_proj(x, base, a, cfg, acfg)
    q = q.reshape(b_, s, cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_rope = L.apply_rope(q[..., cfg.qk_nope_head_dim:], positions, cfg.rope_theta)
    q = torch.cat([q[..., :cfg.qk_nope_head_dim], q_rope], dim=-1)
    c_kv = L.rms_norm(kv[..., :cfg.kv_lora_rank], base["kv_norm"])
    k_rope = L.apply_rope(kv[..., None, cfg.kv_lora_rank:], positions, cfg.rope_theta)
    return q, c_kv, k_rope[:, :, 0, :]


def _mla_expand(c_kv, k_rope, base, a, cfg: AttentionConfig, acfg):
    """Per-head K (nope | shared rope) and V over every row of the
    latent buffer (B, T, kv_lora)."""
    b_, t, _ = c_kv.shape
    k_nope, v = _mla_up_proj(c_kv, base, a, cfg, acfg)
    k_nope = k_nope.reshape(b_, t, cfg.num_heads, cfg.qk_nope_head_dim)
    v = v.reshape(b_, t, cfg.num_heads, cfg.v_head_dim)
    k_rope = k_rope[:, :, None, :].expand(b_, t, cfg.num_heads, cfg.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope], dim=-1), v


def _mla_attention(x, base, a, cfg: AttentionConfig, acfg, positions, mask,
                   return_kv: bool):
    b_, s, _ = x.shape
    q, c_kv, k_rope = _mla_project(x, base, a, cfg, acfg, positions)
    k, v = _mla_expand(c_kv, k_rope, base, a, cfg, acfg)
    if mask is None:
        mask = causal_mask(s, s, cfg.window, device=x.device)
    out = _sdpa(q, k, v, cfg.scale, mask)
    y = L.linear(out.reshape(b_, s, -1), base["o"], a.get("o"), acfg)
    if return_kv:  # what the decode cache holds, as _mla_decode writes it
        return y, {"c_kv": c_kv, "k_rope": k_rope}
    return y


# ---------------------------------------------------------------------------
# cross-attention cache (encoder-decoder serving)
# ---------------------------------------------------------------------------
#
# The encoder's K/V never change after admission, so the serving cache holds
# them once per decoder layer ("xk"/"xv", post-qk-norm, never roped: what
# ``attention(kv_input=)`` computes inline) over a padded source extent, and
# each slot's tail past its valid length ``enc_len`` is masked: a masked
# logit is NEG_INF, so its exp is exactly 0 in the f32 sum.


def init_cross_cache(batch: int, src_len: int, cfg: AttentionConfig, device,
                     dtype=torch.bfloat16) -> Dict:
    """One decoder layer's encoder K/V lines."""
    shape = (batch, src_len, cfg.num_kv_heads, cfg.head_dim)
    return {"xk": torch.zeros(shape, dtype=dtype, device=device),
            "xv": torch.zeros(shape, dtype=dtype, device=device)}


def cross_kv(enc_out, base, adapters, cfg: AttentionConfig, acfg: AdapterConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cacheable half of cross-attention: K/V over the encoder output
    (B, S_src, d), as ``attention(kv_input=enc_out)`` computes them. Cross
    trees keep their per-leaf projections (no fused ``_qkv``)."""
    a = adapters or {}
    b_, t, _ = enc_out.shape
    k = L.linear(enc_out, base["k"], a.get("k"), acfg)
    v = L.linear(enc_out, base["v"], a.get("v"), acfg)
    k = k.reshape(b_, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b_, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = L.rms_norm(k, base["k_norm"])
    return k, v


def cross_attention_cached(x, cache: Dict, enc_len, base, adapters, cfg: AttentionConfig,
                           acfg: AdapterConfig) -> torch.Tensor:
    """Cross-attention of ``x`` (B, S, d: a decode tick or a chunk) against
    the cached lines ``cache["xk"]``/``["xv"]`` (B, T_src, kvh, hd), row b
    masked past ``enc_len[b]``."""
    a = adapters or {}
    b_, s, _ = x.shape
    q = L.linear(x, base["q"], a.get("q"), acfg)
    q = q.reshape(b_, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, base["q_norm"])
    t = cache["xk"].shape[1]
    valid = torch.arange(t, device=x.device)[None, :] < enc_len[:, None]  # (B, T_src)
    out = _sdpa(q, cache["xk"], cache["xv"], cfg.scale, valid[:, None, None, None, :])
    return L.linear(out.reshape(b_, s, -1), base["o"], a.get("o"), acfg)


def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig, device,
                  dtype=torch.bfloat16) -> Dict:
    """One layer's cache; sliding-window layers keep only the window. MLA
    caches the latent and the shared rope key, always at full length: the
    MLA chunk path has no rolling canvas, so a window is refused. A cross
    config keeps no self cache (its lines are ``init_cross_cache``'s)."""
    if cfg.is_cross:
        return {}
    if cfg.mla:
        if cfg.window is not None:
            raise NotImplementedError("MLA with a sliding window is not supported")
        return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                                      device=device)}
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
                     dtype=torch.bfloat16, cache: Optional[Dict] = None) -> Dict:
    """A decode cache holding full-sequence prefill K/V (or MLA latents);
    rolling buffers keep the last ``length`` positions at their wrapped
    slots. A fresh one, or ``cache`` (one layer's ``init_kv_cache``
    buffers) written in place, every byte of it: the slots the prompt does
    not fill get zeros, as a fresh buffer holds them. The indices are
    static, so a CUDA graph can capture the write."""
    first = next(iter(kv.values()))
    if cache is None:
        cache = init_kv_cache(batch, max_len, cfg, first.device, dtype)
    s = first.shape[1]
    for name in kv:
        buf = cache[name]
        length = buf.shape[1]
        start = max(0, s - length)
        idx = torch.arange(start, s, device=buf.device)
        buf[:, idx % length] = kv[name][:, start:].to(buf.dtype)
        buf[:, s:].zero_()  # empty once the prompt fills the buffer
    return cache


def decode_attention(x, cache: Dict, pos, base, adapters, cfg: AttentionConfig,
                     acfg: AdapterConfig) -> Tuple[torch.Tensor, Dict]:
    """One token per row against the cache; row b at clock ``pos[b]``."""
    a = adapters or {}
    b_ = x.shape[0]
    pos = _as_pos_vector(pos, b_, x.device)
    if cfg.mla:
        return _mla_decode(x, cache, pos, base, a, cfg, acfg)
    q, k, v = _project(x, base, a, cfg, acfg, pos[:, None])
    k_buf = _cache_write(cache["k"], k, pos)
    v_buf = _cache_write(cache["v"], v, pos)
    valid = _cache_mask(pos, k_buf.shape[1], cfg.window)
    out = _sdpa(q, k_buf, v_buf, cfg.scale, valid[:, None, None, None, :])
    y = L.linear(out.reshape(b_, 1, -1), base["o"], a.get("o"), acfg)
    return y, {"k": k_buf, "v": v_buf}


def _mla_decode(x, cache: Dict, pos, base, a, cfg: AttentionConfig, acfg):
    """One token a row: write its latent and rope key at ``pos[b]`` (in
    place), then up-project the whole buffer and attend over it."""
    b_ = x.shape[0]
    q, c_kv, k_rope = _mla_project(x, base, a, cfg, acfg, pos[:, None])
    c_buf = _cache_write(cache["c_kv"], c_kv, pos)
    r_buf = _cache_write(cache["k_rope"], k_rope, pos)
    k, v = _mla_expand(c_buf, r_buf, base, a, cfg, acfg)
    valid = _cache_mask(pos, c_buf.shape[1], cfg.window)
    out = _sdpa(q, k, v, cfg.scale, valid[:, None, None, None, :])
    y = L.linear(out.reshape(b_, 1, -1), base["o"], a.get("o"), acfg)
    return y, {"c_kv": c_buf, "k_rope": r_buf}


def _chunk_write(cache: Dict, new: Dict, pos0: torch.Tensor,
                 n_valid: torch.Tensor) -> None:
    """Write rows ``i < n_valid[b]`` of each chunk leaf ``new[name]`` (B,
    C, ...) at positions ``pos0[b] + i`` of ``cache[name]`` (in place);
    the padded tail is dropped. A dense blend over the cache length: every
    shape is fixed and nothing is read on the host, so a CUDA graph can
    hold it, and a bucket that runs past the cache's end writes nothing
    out of range."""
    first = next(iter(new.values()))
    b_, c = first.shape[:2]
    length = cache[next(iter(new))].shape[1]
    t = torch.arange(length, device=first.device)[None, :]           # (1, T)
    write = (t >= pos0[:, None]) & (t < (pos0 + n_valid)[:, None])  # (B, T)
    i = (t - pos0[:, None]).clamp(0, c - 1)                         # (B, T)
    for name, val in new.items():
        tail = (1,) * (val.dim() - 2)
        idx = i.view(b_, length, *tail).expand(b_, length, *val.shape[2:])
        buf = cache[name]
        buf.copy_(torch.where(write.view(b_, length, *tail),
                              val.gather(1, idx).to(buf.dtype), buf))


def chunk_attention(x, cache: Dict, pos0, n_valid, base, adapters,
                    cfg: AttentionConfig, acfg: AdapterConfig, *,
                    max_len: int, prefix: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Advance the cache by one C-token chunk (padded tail allowed):
    write the valid rows' K/V at their absolute positions, attend each
    query against everything written so far. ``prefix`` (static) opens
    keys ``j < prefix`` to every query: the vision prefix's bidirectional
    block (a rolling cache refuses it, as the reference's does).

    A rolling (sliding-window) cache shorter than ``max_len`` cannot take
    the chunk directly: a chunk longer than the window, or one across the
    wrap, would overwrite a slot an earlier query of it still reads. So,
    as the reference does, the chunk is written into an absolute-position
    canvas of ``max_len`` gathered from the rolling buffer (position j
    holds slot ``j % length``), attends there, and the freshest position
    of each residue class is gathered back into the buffer. Slots the
    chunk never reached keep their value (the gather walks back to the
    previous occupant); slots ahead of the clock take a clipped canvas
    entry and stay masked until the row's clock reaches them. Every shape
    is fixed and the buffer is written in place, so a CUDA graph can
    hold it."""
    a = adapters or {}
    b_, c, _ = x.shape
    pos0 = _as_pos_vector(pos0, b_, x.device)
    n_valid = _as_pos_vector(n_valid, b_, x.device)
    i = torch.arange(c, device=x.device)[None, :]
    positions = pos0[:, None] + i                      # (B, C)
    if cfg.mla:
        return _mla_chunk(x, cache, positions, pos0, n_valid, base, a, cfg, acfg, prefix)
    length = cache["k"].shape[1]
    rolling = length < max_len
    if prefix and rolling:
        raise ValueError("prefix-LM chunks need a non-rolling cache")
    q, k, v = _project(x, base, a, cfg, acfg, positions)
    if rolling:
        canvas_at = torch.arange(max_len, device=x.device) % length
        kv = {name: cache[name][:, canvas_at] for name in ("k", "v")}
    else:
        kv = cache
    _chunk_write(kv, {"k": k, "v": v}, pos0, n_valid)
    j = torch.arange(kv["k"].shape[1], device=x.device)[None, None, :]
    allow = j <= positions[:, :, None]                 # (B, C, T)
    if cfg.window is not None:
        allow = allow & (j > positions[:, :, None] - cfg.window)
    if prefix:
        allow = allow | (j < prefix)
    out = _sdpa(q, kv["k"], kv["v"], cfg.scale, allow[:, None, None])
    if rolling:
        pos_max = (pos0 + n_valid - 1)[:, None]        # (B, 1)
        m = torch.arange(length, device=x.device)[None, :]
        src = torch.clamp(pos_max - torch.remainder(pos_max - m, length), 0, max_len - 1)
        src = src[:, :, None, None].expand(b_, length, *k.shape[2:])
        for name in ("k", "v"):
            cache[name].copy_(kv[name].gather(1, src))
    y = L.linear(out.reshape(b_, c, -1), base["o"], a.get("o"), acfg)
    return y, {"k": cache["k"], "v": cache["v"]}


def _mla_chunk(x, cache: Dict, positions, pos0, n_valid, base, a, cfg: AttentionConfig,
               acfg, prefix: int = 0) -> Tuple[torch.Tensor, Dict]:
    """The MLA chunk step: write the valid rows' latents and rope keys at
    their absolute positions (in place), then up-project the whole buffer
    as ``_mla_decode`` does and attend causally. The MLA cache never
    rolls (``init_kv_cache``)."""
    b_, c, _ = x.shape
    q, c_kv, k_rope = _mla_project(x, base, a, cfg, acfg, positions)
    _chunk_write(cache, {"c_kv": c_kv, "k_rope": k_rope}, pos0, n_valid)
    k, v = _mla_expand(cache["c_kv"], cache["k_rope"], base, a, cfg, acfg)
    j = torch.arange(cache["c_kv"].shape[1], device=x.device)[None, None, :]
    allow = j <= positions[:, :, None]                 # (B, C, T)
    if prefix:
        allow = allow | (j < prefix)
    out = _sdpa(q, k, v, cfg.scale, allow[:, None, None])
    y = L.linear(out.reshape(b_, c, -1), base["o"], a.get("o"), acfg)
    return y, {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]}
