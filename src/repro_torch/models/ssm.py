"""Mamba-1 selective SSM block (falcon-mamba-7b). Port of
``repro/models/ssm.py``.

The four dense projections (in/x/dt/out) are RimcLinear leaves: the
paper's DoRA side-car applies to them as to attention, and under
``codes``/``codes_adc`` they run through the crossbar kernels. The
``a_log``/``d_skip``/``conv``/``dt_bias`` leaves are per-channel digital
peripherals, frozen during calibration like norm scales.

The selective scan is plain PyTorch, chunked as the reference's: chunks
carried one after another, a log-depth (Hillis-Steele) scan of the
``(a_t, b_t)`` pairs within each. It regroups the products otherwise than
the reference's ``associative_scan``, so the two agree to f32 rounding,
not bitwise. Every f32 contraction is an elementwise product and a sum,
never a matmul, so none of them can run in TF32.

Two paths round differently, as the reference's do: prefill rounds the
causal conv to the activations' dtype before the SiLU (``_causal_conv``),
decode applies the SiLU in f32 and then rounds (``ssm_decode``).

Under autograd (calibration) ``ssm_block`` recomputes itself in the
backward (``torch.utils.checkpoint``): at falcon-mamba's width one
(rows, d_inner, N) f32 tensor of the scan holds 168 MB at 10 x 32 rows,
and the scan's levels would keep a dozen of them per layer. The reference
runs the same stack under ``remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core import dora
from repro_torch.core.dora import AdapterConfig
from repro_torch.models import layers as L

_LEAVES = ("in_proj", "x_proj", "dt_proj", "out_proj")


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_model: int
    d_inner: int  # typically 2 * d_model
    state_dim: int = 16
    conv_kernel: int = 4
    dt_rank: int = 0  # 0 -> d_model // 16
    chunk: int = 128  # within-chunk parallel scan size

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def _leaf_shapes(cfg: SsmConfig) -> Dict[str, Tuple[int, int]]:
    return {"in_proj": (cfg.d_model, 2 * cfg.d_inner),
            "x_proj": (cfg.d_inner, cfg.dt_rank_ + 2 * cfg.state_dim),
            "dt_proj": (cfg.dt_rank_, cfg.d_inner),
            "out_proj": (cfg.d_inner, cfg.d_model)}


def init_ssm(generator: Optional[torch.Generator], cfg: SsmConfig, acfg: AdapterConfig,
             dtype=torch.bfloat16, *,
             draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[Dict, Dict]:
    """The four linear leaves and the f32 peripherals. ``draws`` gives the
    draws instead of ``generator``: per leaf the standard normals (d_in,
    d_out) under its name and A's U(0, 1) draws (d_in, r) under
    ``"<name>/lora_a"``; the conv taps' standard normals (K, d_inner)
    under ``"conv_w"`` and ``dt``'s U(0, 1) draws (d_inner,) under
    ``"dt"``."""
    device = generator.device if draws is None else next(iter(draws.values())).device
    base: Dict = {}
    adapters: Dict = {}
    for name, (d_in, d_out) in _leaf_shapes(cfg).items():
        if draws is None:
            base[name], adapters[name] = L.init_linear(generator, d_in, d_out, acfg,
                                                       dtype=dtype)
            continue
        w = (draws[name].to(torch.float32) * d_in ** -0.5).to(dtype)
        base[name] = {"w": w}
        adapters[name] = dora.init_adapter(None, d_in, d_out, acfg, w_base=w,
                                           uniforms=draws.get(f"{name}/lora_a"))

    def draw(name, shape, fn):
        if draws is not None:
            return draws[name].to(torch.float32)
        return fn(shape, generator=generator, device=device, dtype=torch.float32)

    k, d, n = cfg.conv_kernel, cfg.d_inner, cfg.state_dim
    base["conv_w"] = draw("conv_w", (k, d), torch.randn) * (k ** -0.5)
    base["conv_b"] = torch.zeros((d,), dtype=torch.float32, device=device)
    # S4D-real init: A = -(1..N) per channel
    a_init = torch.arange(1, n + 1, dtype=torch.float32, device=device)[None, :].repeat(d, 1)
    base["a_log"] = torch.log(a_init)
    base["d_skip"] = torch.ones((d,), dtype=torch.float32, device=device)
    # jax.random.uniform(lo, hi): max(lo, u * (hi - lo) + lo)
    u = draw("dt", (d,), torch.rand)
    lo = torch.tensor(1e-3, dtype=torch.float32, device=u.device)
    span = torch.tensor(1e-1, dtype=torch.float32, device=u.device) - lo
    dt = torch.maximum(u * span + lo, lo)
    base["dt_bias"] = torch.log(torch.exp(dt) - 1.0 + 1e-9)
    return base, adapters


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C): the taps
    added in f32 in the reference's order (``sum_j w[j] * x[t - (K-1) +
    j]``), rounded once to ``x.dtype``."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + xp[:, j:j + s, :] * w[j][None, None, :].to(torch.float32)
    return (out + b[None, None, :].to(torch.float32)).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_params(x: torch.Tensor, base: Dict, a: Dict, cfg: SsmConfig, acfg: AdapterConfig):
    """Input-dependent dt (f32, softplus applied), B and C (f32): the
    selection mechanism."""
    r, n = cfg.dt_rank_, cfg.state_dim
    proj = L.linear(x, base["x_proj"], a.get("x_proj"), acfg)
    dt_low = proj[..., :r].contiguous()  # a strided view: the kernels take dense x
    b_sel = proj[..., r:r + n]
    c_sel = proj[..., r + n:]
    dt = L.linear(dt_low, base["dt_proj"], a.get("dt_proj"), acfg)
    dt = _softplus(dt.to(torch.float32) + base["dt_bias"][None, None, :])
    return dt, b_sel.to(torch.float32), c_sel.to(torch.float32)


def _scan_in_chunk(a_t: torch.Tensor, b_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the pairs ``(a, b)`` under
    ``(al, bl) . (ar, br) = (al * ar, ar * bl + br)``, in log2(c)
    doubling steps."""
    c = a_t.shape[1]
    off = 1
    while off < c:
        b_t = torch.cat([b_t[:, :off], a_t[:, off:] * b_t[:, :-off] + b_t[:, off:]], dim=1)
        a_t = torch.cat([a_t[:, :off], a_t[:, off:] * a_t[:, :-off]], dim=1)
        off *= 2
    return a_t, b_t


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b_sel: torch.Tensor, c_sel: torch.Tensor, d_skip: torch.Tensor,
                   chunk: int = 128, h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked parallel selective scan: ``(y (B, S, d_inner) f32, h_final
    (B, d_inner, N) f32)``. x (B, S, d), dt (B, S, d) f32 after the
    softplus, a_log (d, N), b_sel/c_sel (B, S, N), d_skip (d,). The tail is
    padded with zeros: a zero dt gives ``a_t = 1`` and ``b_t = 0`` there,
    so ``h_final`` is the state after position S - 1."""
    f32 = torch.float32
    bsz, s, d = x.shape
    neg_a = -torch.exp(a_log.to(f32))  # (d, N)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    xs = x.to(f32)
    if pad:
        xs, dt, b_sel, c_sel = (F.pad(t, (0, 0, 0, pad)) for t in (xs, dt, b_sel, c_sel))
    h = torch.zeros((bsz, d, neg_a.shape[1]), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    ys = []
    for i in range(0, s + pad, chunk):
        xc, dtc = xs[:, i:i + chunk], dt[:, i:i + chunk]
        bc, cc = b_sel[:, i:i + chunk], c_sel[:, i:i + chunk]
        a_t = torch.exp(dtc[..., None] * neg_a[None, None])            # (B, c, d, N)
        b_t = (dtc * xc)[..., None] * bc[:, :, None, :]                 # (B, c, d, N)
        a_cum, b_cum = _scan_in_chunk(a_t, b_t)
        hs = a_cum * h[:, None] + b_cum
        ys.append(torch.sum(hs * cc[:, :, None, :], dim=-1))           # (B, c, d)
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + xs[:, :s] * d_skip[None, None].to(f32)
    return y, h


def conv_tail(x: torch.Tensor, kernel: int, dtype=torch.float32) -> torch.Tensor:
    """The last ``kernel - 1`` positions of a conv-branch input (zeros on
    the left of a short sequence): the rolling conv window a decode cache
    carries after a full-sequence prefill."""
    k = kernel - 1
    b, s, c = x.shape
    if s >= k:
        tail = x[:, s - k:]
    else:
        tail = torch.cat([torch.zeros((b, k - s, c), dtype=x.dtype, device=x.device), x], dim=1)
    return tail.to(dtype)


def _ssm_forward(x: torch.Tensor, base: Dict, a: Dict, cfg: SsmConfig, acfg: AdapterConfig):
    """``(out, h_final, xs_raw)`` of the block over the whole sequence."""
    xz = L.linear(x, base["in_proj"], a.get("in_proj"), acfg)
    xs_raw, z = torch.chunk(xz, 2, dim=-1)
    xs = F.silu(_causal_conv(xs_raw, base["conv_w"], base["conv_b"]))
    dt, b_sel, c_sel = _ssm_params(xs, base, a, cfg, acfg)
    y, h_fin = selective_scan(xs, dt, base["a_log"], b_sel, c_sel, base["d_skip"], cfg.chunk)
    y = y.to(x.dtype) * F.silu(z)
    return L.linear(y, base["out_proj"], a.get("out_proj"), acfg), h_fin, xs_raw


def _trains(adapters: Dict) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_lib.tensors(adapters))


def ssm_block(x: torch.Tensor, base: Dict, adapters: Optional[Dict], cfg: SsmConfig,
              acfg: AdapterConfig, *, return_state: bool = False):
    """The block over (B, S, d_model); with ``return_state`` also its
    decode cache after the last position: ``{"h": (B, d_inner, N) f32,
    "conv": (B, K-1, d_inner) f32}``. When the side-cars train, the block
    is recomputed in the backward rather than kept."""
    a = adapters or {}
    if not return_state and _trains(a):
        from torch.utils.checkpoint import checkpoint

        from repro_torch import substrate

        # the recompute runs in the backward, on the autograd engine's
        # device thread on the card: bind the forward's backend there too
        scope = (substrate.active_backend_name(), substrate.active_options())

        def forward(x_):
            with substrate.use_backend(scope[0], **scope[1]):
                return _ssm_forward(x_, base, a, cfg, acfg)[0]

        return checkpoint(forward, x, use_reentrant=False, preserve_rng_state=False)
    out, h_fin, xs_raw = _ssm_forward(x, base, a, cfg, acfg)
    if return_state:
        return out, {"h": h_fin, "conv": conv_tail(xs_raw, cfg.conv_kernel)}
    return out


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_ssm_cache(batch: int, cfg: SsmConfig, device, dtype=torch.float32) -> Dict:
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.state_dim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner), dtype=dtype,
                                device=device)}


def ssm_decode(x: torch.Tensor, cache: Dict, base: Dict, adapters: Optional[Dict],
               cfg: SsmConfig, acfg: AdapterConfig) -> Tuple[torch.Tensor, Dict]:
    """One token per row, x (B, 1, d_model): the conv over the cached
    window and the input, one recurrence step. ``cache``'s ``h`` and
    ``conv`` are advanced in place; returns ``(out, cache)``."""
    f32 = torch.float32
    a = adapters or {}
    xz = L.linear(x, base["in_proj"], a.get("in_proj"), acfg)
    xs, z = torch.chunk(xz, 2, dim=-1)  # (B, 1, d_inner)
    window = torch.cat([cache["conv"], xs.to(cache["conv"].dtype)], dim=1)   # (B, K, d)
    conv_out = torch.sum(window.to(f32) * base["conv_w"][None], dim=1) + base["conv_b"]
    xs1 = F.silu(conv_out)[:, None, :].to(x.dtype)  # (B, 1, d_inner)
    dt, b_sel, c_sel = _ssm_params(xs1, base, a, cfg, acfg)
    neg_a = -torch.exp(base["a_log"].to(f32))
    dt0 = dt[:, 0]  # (B, d)
    x0 = xs1[:, 0].to(f32)
    a_t = torch.exp(dt0[..., None] * neg_a[None])
    b_t = (dt0 * x0)[..., None] * b_sel[:, 0, None, :]
    h = a_t * cache["h"] + b_t
    y = torch.sum(h * c_sel[:, 0, None, :], dim=-1)
    y = y + x0 * base["d_skip"][None]
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    out = L.linear(y, base["out_proj"], a.get("out_proj"), acfg)
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
