"""Fused RIMC-DoRA linear: the CUDA kernel's build, binding and wrappers.

Computes, in one pass over the crossbar codes (paper eq. 2 + eq. 6):

    Y = (X @ W_r + (X @ A) @ B) * gamma,    W_r = (G+ - G-) * scale

Port of ``repro/kernels/dora_linear.py`` (``accum="f32"``): the source
is ``csrc/dora_linear.cu``, its note says what bounds it on the card.

* ``dora_linear_gemv`` — decode-shaped launcher, ``M <= GEMV_MAX_M``.
* ``dora_linear`` — prefill-shaped launcher, tiled over M.

A tensor on the CPU takes the plain version (``ref.dora_linear_ref``);
a CUDA tensor launches the kernel or raises — there is no fallback. Each
launcher counts its launches (``launch_counts``), so a run can show that
its main path went through the kernel.

The library is compiled with ``nvcc`` at first use into ``_build/``
beside this file (named by the source's hash) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.ref import dora_linear_ref

_SRC = Path(__file__).resolve().parent / "csrc" / "dora_linear.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

MAX_RANK = 256  # the X @ A prologue gives each rank at least one thread

_LAUNCHES: Dict[str, int] = {"dora_linear_gemv": 0, "dora_linear": 0}
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per launcher since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def find_nvcc() -> Optional[str]:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.
    Raises ``RuntimeError`` when ``nvcc`` is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): cannot "
                f"build {_SRC.name}; the CUDA kernel has no fallback"
            )
        src = _SRC.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"libdora_linear_{digest}.so"
        t0 = time.perf_counter()
        log = ""
        compiled = not lib_path.exists()
        if compiled:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {_SRC.name}:\n{log}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        operands = [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.rimc_dora_linear_gemv.argtypes = operands + [ptr, i32, i32, i32, i32, i32, ptr]
        lib.rimc_dora_linear_gemv.restype = i32
        lib.rimc_dora_linear_tiled.argtypes = operands + [i32, i32, i32, i32, ptr]
        lib.rimc_dora_linear_tiled.restype = i32
        lib.rimc_xa_scratch.argtypes = [i32, i32, i32]
        lib.rimc_xa_scratch.restype = i32
        build_info.update(
            path=str(lib_path), seconds=time.perf_counter() - t0, log=log,
            compiled=compiled,
        )
        _lib = lib
        return lib


def _device(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    return devices.pop()


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


def _launch(kind: str, x, g_pos, g_neg, scale, a, b, gamma):
    m, k, n, r = _check(x, g_pos, g_neg, scale, a, b, gamma)
    lib = build()
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), **f32)
    # X @ A partials over K chunks, written by the kernel's prologue
    xa = torch.empty((lib.rimc_xa_scratch(m, k, r),), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (g_pos, g_neg, scale, a, b, gamma, out, xa)]
    head = [x.data_ptr(), int(x.dtype == torch.bfloat16)]
    if kind == "dora_linear_gemv":
        rows = autotune.gemv_rows(m)
        xt = torch.empty((k, rows), **f32)  # X^T, zero rows past M
        err = lib.rimc_dora_linear_gemv(
            *head, *ptrs, xt.data_ptr(), m, k, n, r, rows, stream
        )
    else:
        err = lib.rimc_dora_linear_tiled(*head, *ptrs, m, k, n, r, stream)
    if err != 0:
        raise RuntimeError(f"{kind} launch failed: cudaError {err}")
    _LAUNCHES[kind] += 1
    return out


def _dispatch(kind: str, x, g_pos, g_neg, scale, a, b, gamma):
    device = _device(x, g_pos, g_neg, scale, a, b, gamma)
    if device.type == "cpu":
        return dora_linear_ref(x, g_pos, g_neg, scale, a, b, gamma)
    if device.type != "cuda":
        raise ValueError(f"no {kind} kernel for device {device}")
    return _launch(kind, x, g_pos, g_neg, scale, a, b, gamma)


def dora_linear(x, g_pos, g_neg, scale, a, b, gamma) -> torch.Tensor:
    """Tiled launcher: x (M, K) f32|bf16; g_pos/g_neg (K, N) u8; scale,
    gamma (1, N) f32; a (K, r) f32; b (r, N) f32 -> (M, N) f32."""
    return _dispatch("dora_linear", x, g_pos, g_neg, scale, a, b, gamma)


def dora_linear_gemv(x, g_pos, g_neg, scale, a, b, gamma) -> torch.Tensor:
    """Decode launcher (M <= GEMV_MAX_M): the operands of
    ``dora_linear``."""
    if x.shape[0] > autotune.GEMV_MAX_M:
        raise ValueError(
            f"dora_linear_gemv takes at most {autotune.GEMV_MAX_M} rows, "
            f"got {x.shape[0]}"
        )
    return _dispatch("dora_linear_gemv", x, g_pos, g_neg, scale, a, b, gamma)
