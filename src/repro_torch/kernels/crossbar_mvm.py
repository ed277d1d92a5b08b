"""ADC-faithful analog crossbar MVM: the CUDA kernel's binding and wrapper.

Simulates the analog signal chain of an RIMC macro (paper Sec. II-A) at
tile granularity: each 256-row array tile is one crossbar activation
whose differential column current ``x_tile @ (G+ - G-)`` is formed in
f32 and digitized by a saturating ``adc_bits`` ADC, with a step that
tracks max |x| over the (128-row block, tile):

    step = 256 * code_max * max|x_tile| / (adc_max * 16)

The digitized partials accumulate over the K tiles and the per-column
scale applies at the end. Port of ``repro/kernels/crossbar_mvm.py``
(whose docstring's ``/ 64`` is wrong; its code divides by 16, as here).
The source is ``csrc/crossbar_mvm.cu``: bf16 x (what the dense leaves
pass) runs its tensor-core body in one launch, K split into the ordered
parts of ``autotune.adc_plan``; f32 x at N <= ``autotune.NARROW_MAX_N``
(the MoE routers, ``autotune.use_adc_narrow``) its narrow body in one
launch, K split into the parts of ``autotune.adc_narrow_plan``; f32 x above
it the SIMT body (three launches).

A tensor on the CPU takes the plain version (``ref.crossbar_mvm_ref``);
a CUDA tensor launches the kernel or raises — there is no fallback.
It has no backward: an operand that requires grad under grad mode
raises on every device (``build.refuse_autograd``).
``launch_counts`` counts the calls that launch (one each, whatever the
body); ``f32x_launch_counts`` the share of them whose x was float32 (the
MoE router's).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.build import CudaLibrary, device_of, refuse_autograd, tickets
from repro_torch.kernels.ref import crossbar_mvm_ref

F32X = "/f32x"
_LAUNCHES: Dict[str, int] = {"crossbar_mvm": 0}
_F32X_LAUNCHES: Dict[str, int] = {"crossbar_mvm" + F32X: 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def f32x_launch_counts() -> Dict[str, int]:
    """The share of ``launch_counts`` whose x was float32 (``F32X``
    appended to the key)."""
    return dict(_F32X_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["crossbar_mvm"] = 0
    _F32X_LAUNCHES["crossbar_mvm" + F32X] = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (keys of ``launch_counts`` or ``f32x_launch_counts``)
    to the counters: a CUDA graph's replay adds the launches its capture
    recorded, since a replay runs no wrapper."""
    for name, n in counts.items():
        (_F32X_LAUNCHES if name.endswith(F32X) else _LAUNCHES)[name] += n


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rimc_crossbar_mvm.argtypes = [ptr] * 7 + [i32] * 3 + [f32] * 3 + [ptr]
    lib.rimc_crossbar_mvm.restype = i32
    lib.rimc_crossbar_mvm_mma.argtypes = [ptr] * 7 + [i32] * 4 + [f32] * 3 + [ptr]
    lib.rimc_crossbar_mvm_mma.restype = i32
    lib.rimc_adc_mma_sems.argtypes = [i32, i32]
    lib.rimc_adc_mma_sems.restype = i32
    lib.rimc_adc_mma_scratch.argtypes = [i32] * 4
    lib.rimc_adc_mma_scratch.restype = ctypes.c_longlong
    lib.rimc_crossbar_mvm_narrow.argtypes = [ptr] * 7 + [i32] * 4 + [f32] * 3 + [ptr]
    lib.rimc_crossbar_mvm_narrow.restype = i32
    lib.rimc_adc_narrow_sems.argtypes = [i32]
    lib.rimc_adc_narrow_sems.restype = i32
    lib.rimc_adc_capture_id.argtypes = [ptr, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.rimc_adc_capture_id.restype = i32
    lib.rimc_adc_step_scratch.argtypes = [i32, i32]
    lib.rimc_adc_step_scratch.restype = i32
    lib.rimc_adc_part_scratch.argtypes = [i32, i32, i32]
    lib.rimc_adc_part_scratch.restype = ctypes.c_longlong


LIB = CudaLibrary("crossbar_mvm.cu", _bind)
build = LIB.load
build_info = LIB.info

# the tickets of the tensor-core and narrow bodies, zeros that every launch
# leaves as it found them: (capture id, tensor) per (device, stream)
_SEMS: Dict[tuple, tuple] = {}


def _check(x, g_pos, g_neg, scale):
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    n = g_pos.shape[-1]
    want = {
        "g_pos": (g_pos, (k, n), torch.uint8),
        "g_neg": (g_neg, (k, n), torch.uint8),
        "scale": (scale, (1, n), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("g_pos", g_pos), ("g_neg", g_neg), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return m, k, n


def _launch(x, g_pos, g_neg, scale, code_max: int, adc_bits: int):
    m, k, n = _check(x, g_pos, g_neg, scale)
    lib = build()
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), **f32)
    adc_max = 2.0 ** (adc_bits - 1) - 1.0
    consts = (float(autotune.ADC_ARRAY_ROWS * code_max), adc_max * 16.0, adc_max)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (x, g_pos, g_neg, scale, out)]
    if x.dtype == torch.bfloat16:
        parts = autotune.adc_plan(m, k, n)
        ws = sem = None
        if parts > 1:
            # part 0's running sum and each later tile's digitized partial,
            # added in tile order by the strip's last block
            ws = torch.empty((lib.rimc_adc_mma_scratch(m, k, n, parts),), **f32)
            sem = tickets(_SEMS, lib.rimc_adc_capture_id, x.device, stream,
                          lib.rimc_adc_mma_sems(m, n))
        err = lib.rimc_crossbar_mvm_mma(
            *ptrs, None if ws is None else ws.data_ptr(),
            None if sem is None else sem.data_ptr(), m, k, n, parts, *consts, stream,
        )
    elif autotune.use_adc_narrow(n, x.dtype == torch.float32):
        # every tile's digitized partial, added in tile order by the row
        # block's last block
        ws = torch.empty((lib.rimc_adc_part_scratch(m, k, n),), **f32)
        sem = tickets(_SEMS, lib.rimc_adc_capture_id, x.device, stream,
                      lib.rimc_adc_narrow_sems(m))
        err = lib.rimc_crossbar_mvm_narrow(
            *ptrs, ws.data_ptr(), sem.data_ptr(), m, k, n, autotune.adc_narrow_plan(m, k, n),
            *consts, stream,
        )
    else:
        step = torch.empty((lib.rimc_adc_step_scratch(m, k),), **f32)
        part = torch.empty((lib.rimc_adc_part_scratch(m, k, n),), **f32)
        err = lib.rimc_crossbar_mvm(*ptrs, step.data_ptr(), part.data_ptr(), m, k, n,
                                    *consts, stream)
    if err != 0:
        raise RuntimeError(f"crossbar_mvm launch failed: cudaError {err}")
    _LAUNCHES["crossbar_mvm"] += 1
    if x.dtype == torch.float32:
        _F32X_LAUNCHES["crossbar_mvm" + F32X] += 1
    return out


def crossbar_mvm(x, g_pos, g_neg, scale, *, code_max: int = 255,
                 adc_bits: int = 8) -> torch.Tensor:
    """x (M, K) f32|bf16; g_pos/g_neg (K, N) u8; scale (1, N) f32 ->
    (M, N) f32. ``code_max``/``adc_bits`` come from the ``RramConfig``."""
    refuse_autograd("crossbar_mvm", x, g_pos, g_neg, scale)
    device = device_of(x, g_pos, g_neg, scale)
    if device.type == "cpu":
        return crossbar_mvm_ref(
            x, g_pos, g_neg, scale, code_max=code_max, adc_bits=adc_bits,
            bm=autotune.ADC_BLOCK_ROWS, rows=autotune.ADC_ARRAY_ROWS,
        )
    if device.type != "cuda":
        raise ValueError(f"no crossbar_mvm kernel for device {device}")
    return _launch(x, g_pos, g_neg, scale, int(code_max), int(adc_bits))
