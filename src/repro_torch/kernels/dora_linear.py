"""Fused RIMC-DoRA linear: the CUDA kernel's binding and wrappers.

Computes, in one pass over the crossbar codes (paper eq. 2 + eq. 6):

    Y = (X @ W_r + (X @ A) @ B) * gamma,    W_r = (G+ - G-) * scale

Port of ``repro/kernels/dora_linear.py``: the source is
``csrc/dora_linear.cu``, its note says what bounds it on the card.

* ``dora_linear_gemv`` — decode-shaped launcher, ``M <= GEMV_MAX_M``; the
  f32 body with bf16 x and the int8 body with any x run on the tensor
  cores (``mma.sync`` bf16 or u8 x s8) in one launch each, with K split
  into the parts ``autotune.gemv_plan`` says (the int8 body after a pass
  for its row scales from ``GEMV_INT8_PRESCALE_ROWS`` rows); f32 x with
  the f32 body above ``NARROW_MAX_N`` columns runs a SIMT body behind a
  prologue.
* ``dora_linear`` — prefill-shaped launcher, tiled over M and N; the
  int8 body, and the f32 body with bf16 x, run on the tensor cores
  (``mma.sync`` s8 x u8 or bf16), with tiles and K splits from
  ``autotune.tiled_tiles``; f32 x with the f32 body above
  ``NARROW_MAX_N`` columns runs a SIMT body.
* Either launcher, f32 x with the f32 body at ``N <= NARROW_MAX_N`` (the
  MoE routers, ``autotune.use_narrow``): one launch of the narrow body,
  K split into the parts ``autotune.narrow_plan`` says, X @ A in the same
  pass, the parts added in a fixed order in the same launch.

Both take ``accum``: ``"f32"`` (exact f32 products of x and the codes)
or ``"int8"`` (x quantized per row to s8, an exact int32 accumulator, the
scales folded into the f32 epilogue). Unlike the reference, the int8
body reads the uint8 codes themselves: no s8 recode is stored.

A tensor on the CPU takes the plain version (``ref.dora_linear_ref``,
``ref.dora_linear_int8_ref``); a CUDA tensor launches the kernel or
raises — there is no fallback. Neither has a backward: an operand
that requires grad under grad mode raises on every device
(``build.refuse_autograd``). Each launcher counts its launches per
body (``launch_counts``: ``"dora_linear_gemv"``, ``"dora_linear"`` for
f32, with a ``"/int8"`` suffix for int8), so a run can show which kernel
its main path went through; ``f32x_launch_counts`` tallies apart the
share of them whose x was float32 (the MoE router's, keys with a
``"/f32x"`` suffix; those of the f32 body at ``N <= NARROW_MAX_N`` are
the narrow body's launches). The library is built at first use
(``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.build import CudaLibrary, device_of, refuse_autograd, tickets
from repro_torch.kernels.ref import dora_linear_int8_ref, dora_linear_ref

MAX_RANK = 256  # the X @ A prologue gives each rank at least one thread

def counter(name: str, accum: str) -> str:
    """The launch-count key of a launcher running one body."""
    return name if accum == "f32" else f"{name}/{accum}"


_LAUNCHES: Dict[str, int] = {
    counter(name, accum): 0
    for accum in autotune.ACCUMS for name in ("dora_linear_gemv", "dora_linear")
}


F32X = "/f32x"
# the launches of _LAUNCHES whose x was float32, keyed name + F32X
_F32X_LAUNCHES: Dict[str, int] = {name + F32X: 0 for name in _LAUNCHES}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per launcher and body since the last reset."""
    return dict(_LAUNCHES)


def f32x_launch_counts() -> Dict[str, int]:
    """The share of ``launch_counts`` whose x was float32, per key with
    ``F32X`` appended."""
    return dict(_F32X_LAUNCHES)


def reset_launch_counts() -> None:
    for table in (_LAUNCHES, _F32X_LAUNCHES):
        for name in table:
            table[name] = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (keys of ``launch_counts`` or ``f32x_launch_counts``)
    to the counters: a CUDA graph's replay adds the launches its capture
    recorded, since a replay runs no wrapper."""
    for name, n in counts.items():
        (_F32X_LAUNCHES if name.endswith(F32X) else _LAUNCHES)[name] += n


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    operands = [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.rimc_dora_linear_gemv.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.rimc_dora_linear_gemv.restype = i32
    lib.rimc_dora_linear_tiled.argtypes = operands + [ptr, ptr, ptr] + [i32] * 7 + [ptr]
    lib.rimc_dora_linear_tiled.restype = i32
    lib.rimc_dora_linear_gemv_mma.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
    lib.rimc_dora_linear_gemv_mma.restype = i32
    lib.rimc_dora_linear_gemv_int8.argtypes = operands + [ptr] * 3 + [i32] * 7 + [ptr]
    lib.rimc_dora_linear_gemv_int8.restype = i32
    lib.rimc_dora_linear_narrow.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.rimc_dora_linear_narrow.restype = i32
    lib.rimc_xa_scratch.argtypes = [i32, i32, i32]
    lib.rimc_xa_scratch.restype = i32
    lib.rimc_gemv_mma_sems.argtypes = [i32]
    lib.rimc_gemv_mma_sems.restype = i32
    lib.rimc_capture_id.argtypes = [ptr, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.rimc_capture_id.restype = i32


LIB = CudaLibrary("dora_linear.cu", _bind)
build = LIB.load
build_info = LIB.info

# the tickets of the tensor-core GEMVs and the narrow body (build.tickets),
# zeros that every launch leaves as it found them: (capture id, tensor) per
# (device, stream)
_SEMS: Dict[tuple, tuple] = {}


def _check(x, g_pos, g_neg, scale, a, b, gamma):
    """Validate the kernel's operand contract; returns (m, k, n, r)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    n = g_pos.shape[-1]
    r = a.shape[-1]
    want = {
        "g_pos": (g_pos, (k, n), torch.uint8),
        "g_neg": (g_neg, (k, n), torch.uint8),
        "scale": (scale, (1, n), torch.float32),
        "a": (a, (k, r), torch.float32),
        "b": (b, (r, n), torch.float32),
        "gamma": (gamma, (1, n), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"adapter rank must be in [1, {MAX_RANK}], got {r}")
    for name, t in [("x", x)] + [(nm, v[0]) for nm, v in want.items()]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return m, k, n, r


def _launch(kind: str, accum: str, x, g_pos, g_neg, scale, a, b, gamma, plan_n=None):
    m, k, n, r = _check(x, g_pos, g_neg, scale, a, b, gamma)
    # the launch policy (narrow or not, parts of K, tiles) is the whole
    # leaf's for a column block, so that its columns sum in the same order;
    # buffers and tickets are the block's own
    plan_n = n if plan_n is None else int(plan_n)
    lib = build()
    int8 = accum == "int8"
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if autotune.use_narrow(plan_n, accum, x.dtype == torch.float32):
        # one sum per slab of K, column and row: the N columns and the R
        # ranks, each rounded up to 4
        slabs = -(-k // autotune.MIN_SPLIT_ROWS)
        ws = torch.empty((slabs, m, -(-n // 4) * 4 + -(-r // 4) * 4), **f32)
        sem = tickets(_SEMS, lib.rimc_capture_id, x.device, stream,
                      -(-m // autotune.NARROW_ROWS))
        err = lib.rimc_dora_linear_narrow(
            *(t.data_ptr() for t in (x, g_pos, g_neg, scale, a, b, gamma, out, ws, sem)),
            m, k, n, r, autotune.narrow_plan(m, n, k), stream,
        )
        return _launched(kind, accum, x, err, out)
    # X @ A partials over K chunks, written by the kernel's prologue
    xa = torch.empty((lib.rimc_xa_scratch(m, k, r),), **f32)
    xs = torch.empty((m,), **f32) if int8 else None  # int8 row scales
    ptrs = [t.data_ptr() for t in (g_pos, g_neg, scale, a, b, gamma, out, xa)]
    head = [x.data_ptr(), int(x.dtype == torch.bfloat16)]
    xs_ptr = None if xs is None else xs.data_ptr()
    if kind == "dora_linear_gemv" and (int8 or x.dtype == torch.bfloat16):
        parts = autotune.gemv_plan(m, plan_n, k, accum)
        # each K part's raw sums (f32, int32 for int8), added in part order
        # by the strip's last block
        ws = torch.empty((parts, m, n), dtype=torch.int32 if int8 else torch.float32,
                         device=x.device)
        sem = tickets(_SEMS, lib.rimc_capture_id, x.device, stream,
                      lib.rimc_gemv_mma_sems(n))
        rows = autotune.gemv_rows(m)
        if int8:
            err = lib.rimc_dora_linear_gemv_int8(
                *head, *ptrs, xs_ptr, ws.data_ptr(), sem.data_ptr(), m, k, n, r, rows,
                parts, int(autotune.gemv_int8_prescale(m)), stream,
            )
        else:
            err = lib.rimc_dora_linear_gemv_mma(
                x.data_ptr(), *ptrs, ws.data_ptr(), sem.data_ptr(), m, k, n, r, rows, parts,
                stream,
            )
    elif kind == "dora_linear_gemv":
        rows = autotune.gemv_rows(m)
        xt = torch.empty((k, rows), **f32)  # X^T, zero rows past M
        err = lib.rimc_dora_linear_gemv(
            x.data_ptr(), *ptrs, xt.data_ptr(), m, k, n, r, rows, stream
        )
    else:
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device) if int8 else None
        # the tensor-core bodies (int8; f32 with bf16 x) split K when their
        # tiles alone leave SMs idle; the parts' raw sums go through ws,
        # summed in order. f32 x with the f32 body (SIMT) ignores the plan.
        plan = autotune.tiled_tiles(m, plan_n, k, accum)
        ws = None
        if plan.splits(k) > 1 and (int8 or x.dtype == torch.bfloat16):
            ws = torch.empty((plan.splits(k), m, n),
                             dtype=torch.int32 if int8 else torch.float32, device=x.device)
        err = lib.rimc_dora_linear_tiled(
            *head, *ptrs, None if xq is None else xq.data_ptr(), xs_ptr,
            None if ws is None else ws.data_ptr(), m, k, n, r, int(int8),
            plan.bm, plan.k_split, stream,
        )
    return _launched(kind, accum, x, err, out)


def _launched(kind: str, accum: str, x, err: int, out):
    """Raise on a failed launch, else count it (and its f32-x share)."""
    if err != 0:
        raise RuntimeError(f"{kind} ({accum}) launch failed: cudaError {err}")
    _LAUNCHES[counter(kind, accum)] += 1
    if x.dtype == torch.float32:
        _F32X_LAUNCHES[counter(kind, accum) + F32X] += 1
    return out


def _dispatch(kind: str, accum: str, x, g_pos, g_neg, scale, a, b, gamma, plan_n=None):
    if accum not in autotune.ACCUMS:
        raise ValueError(f"accum must be one of {autotune.ACCUMS}, got {accum!r}")
    refuse_autograd(kind, x, g_pos, g_neg, scale, a, b, gamma)
    device = device_of(x, g_pos, g_neg, scale, a, b, gamma)
    if device.type == "cpu":
        ref = dora_linear_ref if accum == "f32" else dora_linear_int8_ref
        return ref(x, g_pos, g_neg, scale, a, b, gamma)
    if device.type != "cuda":
        raise ValueError(f"no {kind} kernel for device {device}")
    return _launch(kind, accum, x, g_pos, g_neg, scale, a, b, gamma, plan_n)


def dora_linear(x, g_pos, g_neg, scale, a, b, gamma, *, accum: str = "f32",
                plan_n=None) -> torch.Tensor:
    """Tiled launcher: x (M, K) f32|bf16; g_pos/g_neg (K, N) u8; scale,
    gamma (1, N) f32; a (K, r) f32; b (r, N) f32 -> (M, N) f32.
    ``plan_n`` (N by default): the width the launch policy is chosen for,
    the whole leaf's when the operands are a column block of it."""
    return _dispatch("dora_linear", accum, x, g_pos, g_neg, scale, a, b, gamma, plan_n)


def dora_linear_gemv(x, g_pos, g_neg, scale, a, b, gamma, *, accum: str = "f32",
                     plan_n=None) -> torch.Tensor:
    """Decode launcher (M <= GEMV_MAX_M): the operands and ``plan_n`` of
    ``dora_linear``."""
    if x.shape[0] > autotune.GEMV_MAX_M:
        raise ValueError(
            f"dora_linear_gemv takes at most {autotune.GEMV_MAX_M} rows, "
            f"got {x.shape[0]}"
        )
    return _dispatch("dora_linear_gemv", accum, x, g_pos, g_neg, scale, a, b, gamma, plan_n)
