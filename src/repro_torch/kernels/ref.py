"""Plain PyTorch versions of the port's kernels (the correctness
contract). Port of ``repro/kernels/ref.py`` and of the jnp helpers of
``repro/kernels/dora_linear.py``: the CPU path of every kernel wrapper,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card;
and the step-by-step oracles that ``models/ssm.py``'s chunked selective
scan and ``models/rglru.py``'s log-depth RG-LRU scan are held against."""
from __future__ import annotations

import torch


def dora_linear_ref(x, g_pos, g_neg, scale, a, b, gamma, out_dtype=torch.float32):
    """Y = (X @ ((G+ - G-) * scale) + (X @ A) @ B) * gamma, all in f32."""
    xf = x.to(torch.float32)
    w = (g_pos.to(torch.float32) - g_neg.to(torch.float32)) * scale
    y = xf @ w
    y = y + (xf @ a.to(torch.float32)) @ b.to(torch.float32)
    return (y * gamma).to(out_dtype)


def _div(a, divisor: float):
    """``a / divisor`` as an IEEE division. A Python number as divisor
    lets PyTorch's CUDA kernel multiply by its rounded reciprocal, which
    differs from the division in the last bit."""
    return a / a.new_full((), divisor)


def quantize_rows(x):
    """Per-row symmetric s8 quantization: x ~= xq * xs, xs f32 (M, 1).
    Divides (not by a reciprocal) and rounds half to even, as the
    reference does, so xq and xs match it bitwise."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=1, keepdim=True)
    xs = _div(torch.clamp(absmax, min=1e-30), 127.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def recode_s8(g):
    """Offset recode u8 codes to s8 (``g - 128``); the offsets cancel in
    ``(G+ - 128) - (G- - 128)``."""
    if g.dtype == torch.int8:
        return g
    return (g.to(torch.int16) - 128).to(torch.int8)


def int8_dot(xq, g_pos, g_neg):
    """The int32 accumulator ``xq @ (G+ - G-)`` of the int8 body, as a
    float64 product of integer-valued operands: exact while every sum
    stays below 2^53 (it is below K * 127 * 255 < 2^31 here), on the CPU
    and on the card alike."""
    w = recode_s8(g_pos).to(torch.float64) - recode_s8(g_neg).to(torch.float64)
    return (xq.to(torch.float64) @ w).to(torch.int32)


def dora_linear_int8_ref(x, g_pos, g_neg, scale, a, b, gamma):
    """The int8 body (``accum="int8"``): x quantized per row to s8, an
    exact int32 dot against the differential codes, and the f32 epilogue
    ``(f32(acc) * xs * scale + ((xq @ A) * xs) @ B) * gamma``."""
    xq, xs = quantize_rows(x)
    acc = int8_dot(xq, g_pos, g_neg)
    xa = xq.to(torch.float32) @ a.to(torch.float32)
    low = (xa * xs) @ b.to(torch.float32)
    y = acc.to(torch.float32) * xs * scale + low
    return y * gamma


def _adc_tiles(x, bm, rows):
    """x as f32 zero-padded to whole tiles, (tile, block, bm, rows)."""
    m, k = x.shape
    nb, nt = -(-m // bm), -(-k // rows)
    xf = x.new_zeros((nb * bm, nt * rows), dtype=torch.float32)
    xf[:m, :k] = x.to(torch.float32)
    return xf.reshape(nb, bm, nt, rows).permute(2, 0, 1, 3)


def adc_steps(x, *, code_max=255, adc_bits=8, bm=128, rows=256):
    """The ADC step of every (``rows``-row tile, ``bm``-row block) of x,
    (tiles, blocks, 1, 1) f32: ``rows * code_max * max|x_tile| /
    (adc_max * 16)`` in the reference's order of f32 operations."""
    adc_max = 2.0 ** (adc_bits - 1) - 1.0
    xt = _adc_tiles(x, bm, rows)
    x_absmax = torch.clamp(torch.amax(torch.abs(xt), dim=(2, 3), keepdim=True), min=1e-8)
    return _div(rows * code_max * x_absmax, adc_max * 16.0)


def crossbar_mvm_ref(x, g_pos, g_neg, scale, *, code_max=255, adc_bits=8,
                     bm=128, rows=256, out_dtype=torch.float32):
    """ADC-faithful crossbar MVM, tile by tile: for each (``bm`` rows) x
    (``rows``-row array) tile, the differential current x @ (G+ - G-) in
    f32 is digitized by a saturating ADC whose step tracks the tile's
    max |x|; the digitized partials accumulate over K tiles in ascending
    order, then the per-column scale applies. Ragged M and K are padded
    with zeros to whole tiles, as the reference's ``rimc_mvm_adc`` pads
    them (a zero changes neither a current nor a max |x|); ``rows``
    stays the full array height in the step of a partial last tile."""
    m, k = x.shape
    n = g_pos.shape[1]
    adc_max = 2.0 ** (adc_bits - 1) - 1.0
    xt = _adc_tiles(x, bm, rows)
    nt, nb = xt.shape[:2]
    w = xt.new_zeros((nt * rows, n))
    w[:k] = g_pos.to(torch.float32) - g_neg.to(torch.float32)
    cur = xt @ w.reshape(nt, 1, rows, n)
    step = adc_steps(x, code_max=code_max, adc_bits=adc_bits, bm=bm, rows=rows)
    cur = torch.clamp(torch.round(cur / step), -adc_max, adc_max) * step
    acc = cur[0]
    for t in range(1, nt):
        acc = acc + cur[t]
    return (acc.reshape(nb * bm, n)[:m] * scale).to(out_dtype)


def adc_disagreement(got, want, x, scale, *, code_max=255, adc_bits=8, bm=128,
                     rows=256, rtol=1e-4, atol=1e-6):
    """How two ADC MVMs of the same inputs disagree: ``(bad, flips)``.
    The f32 current of a tile may be summed in another order, which can
    move it across a rounding boundary of the ADC; an output then differs
    by one step of one of its tiles times its column scale. ``flips``
    counts such outputs, ``bad`` the outputs that are neither within
    ``rtol``/``atol`` nor one step apart."""
    diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
    close = diff <= atol + rtol * want.to(torch.float32).abs()
    idx = torch.nonzero(~close, as_tuple=True)
    if idx[0].numel() == 0:
        return 0, 0
    steps = adc_steps(x, code_max=code_max, adc_bits=adc_bits, bm=bm, rows=rows)
    per_row = steps[:, :, 0, 0].t().repeat_interleave(bm, dim=0)  # (rows of x, tiles)
    one = per_row[idx[0]] * scale.reshape(-1)[idx[1]].abs()[:, None]
    off = (diff[idx][:, None] - one).abs() <= 1e-4 * one
    flips = int(off.any(dim=1).sum())
    return int(idx[0].numel()) - flips, flips


def selective_scan_ref(x, dt, a_log, b_sel, c_sel, d_skip, h0=None):
    """Sequential (step-by-step) selective scan in f32: ``(y (B, S, D),
    h_final (B, D, N))``. Shapes: x/dt (B, S, D), a_log (D, N), b_sel/c_sel
    (B, S, N), d_skip (D,), h0 (B, D, N) or None (zeros)."""
    bsz, s, d = x.shape
    n = a_log.shape[-1]
    f32 = torch.float32
    neg_a = -torch.exp(a_log.to(f32))
    h = torch.zeros((bsz, d, n), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    ys = []
    for t in range(s):
        dt_t = dt[:, t].to(f32)
        x_t = x[:, t].to(f32)
        a_t = torch.exp(dt_t[..., None] * neg_a[None])
        b_t = (dt_t * x_t)[..., None] * b_sel[:, t, None, :].to(f32)
        h = a_t * h + b_t
        y = torch.sum(h * c_sel[:, t, None, :].to(f32), dim=-1)
        ys.append(y + x_t * d_skip[None].to(f32))
    return torch.stack(ys, dim=1), h


def rglru_scan_ref(a_t, b_t, h0=None):
    """Sequential (step-by-step) RG-LRU recurrence ``h_t = a_t * h_{t-1} +
    b_t`` in f32: ``(h (B, S, D), h_final (B, D))``. Shapes: a_t/b_t (B, S,
    D), h0 (B, D) or None (zeros)."""
    bsz, s, d = a_t.shape
    f32 = torch.float32
    h = torch.zeros((bsz, d), dtype=f32, device=a_t.device) if h0 is None else h0.to(f32)
    hs = []
    for t in range(s):
        h = a_t[:, t].to(f32) * h + b_t[:, t].to(f32)
        hs.append(h)
    return torch.stack(hs, dim=1), h
