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
The source is ``csrc/crossbar_mvm.cu``.

A tensor on the CPU takes the plain version (``ref.crossbar_mvm_ref``);
a CUDA tensor launches the kernel or raises — there is no fallback.
``launch_counts`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.build import CudaLibrary, device_of
from repro_torch.kernels.ref import crossbar_mvm_ref

_LAUNCHES: Dict[str, int] = {"crossbar_mvm": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["crossbar_mvm"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rimc_crossbar_mvm.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                      i32, i32, i32, i32, f32, f32, f32, ptr]
    lib.rimc_crossbar_mvm.restype = i32
    lib.rimc_adc_step_scratch.argtypes = [i32, i32]
    lib.rimc_adc_step_scratch.restype = i32
    lib.rimc_adc_part_scratch.argtypes = [i32, i32, i32]
    lib.rimc_adc_part_scratch.restype = ctypes.c_longlong


LIB = CudaLibrary("crossbar_mvm.cu", _bind)
build = LIB.load
build_info = LIB.info


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
    step = torch.empty((lib.rimc_adc_step_scratch(m, k),), **f32)
    part = torch.empty((lib.rimc_adc_part_scratch(m, k, n),), **f32)
    adc_max = 2.0 ** (adc_bits - 1) - 1.0
    err = lib.rimc_crossbar_mvm(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g_pos.data_ptr(),
        g_neg.data_ptr(), scale.data_ptr(), out.data_ptr(), step.data_ptr(),
        part.data_ptr(), m, k, n, autotune.adc_tile_rows(m),
        float(autotune.ADC_ARRAY_ROWS * code_max), adc_max * 16.0, adc_max,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"crossbar_mvm launch failed: cudaError {err}")
    _LAUNCHES["crossbar_mvm"] += 1
    return out


def crossbar_mvm(x, g_pos, g_neg, scale, *, code_max: int = 255,
                 adc_bits: int = 8) -> torch.Tensor:
    """x (M, K) f32|bf16; g_pos/g_neg (K, N) u8; scale (1, N) f32 ->
    (M, N) f32. ``code_max``/``adc_bits`` come from the ``RramConfig``."""
    device = device_of(x, g_pos, g_neg, scale)
    if device.type == "cpu":
        return crossbar_mvm_ref(
            x, g_pos, g_neg, scale, code_max=code_max, adc_bits=adc_bits,
            bm=autotune.ADC_BLOCK_ROWS, rows=autotune.ADC_ARRAY_ROWS,
        )
    if device.type != "cuda":
        raise ValueError(f"no crossbar_mvm kernel for device {device}")
    return _launch(x, g_pos, g_neg, scale, int(code_max), int(adc_bits))
