"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source has a plain C interface: it is compiled with ``nvcc`` for
sm_90a into a shared library in ``_build/`` beside this file, named by
the hash of the source and the flags, and loaded with ctypes. The build
runs at first use, never at import; a missing ``nvcc`` or a failed build
raises — a CUDA kernel has no fallback.
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
from typing import Callable, Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> Optional[str]:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc")


class CudaLibrary:
    """One ``csrc`` source: built once per source hash, loaded once per
    process. ``bind`` sets the ctypes signatures of its C functions;
    ``info`` holds the library path, build seconds and the nvcc log."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.src = CSRC / source
        self.bind = bind
        self.info: Dict[str, object] = {}
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            nvcc = find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): cannot "
                    f"build {self.src.name}; the CUDA kernel has no fallback"
                )
            src = self.src.read_bytes()
            digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            lib_path = BUILD_DIR / f"lib{self.src.stem}_{digest}.so"
            t0 = time.perf_counter()
            log = ""
            compiled = not lib_path.exists()
            if compiled:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.src)],
                    capture_output=True, text=True,
                )
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed building {self.src.name}:\n{log}")
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            self.bind(lib)
            self.info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                             log=log, compiled=compiled)
            self._lib = lib
            return lib


def device_of(*tensors):
    """The one device all ``tensors`` lie on; raises if there are several."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    return devices.pop()


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd would record a call of kernel ``name``: the
    kernels have no backward, and on the card they return a tensor with no
    ``grad_fn``, so a loss through them would train nothing without a
    word. The CPU's plain version is refused alike, so that a test on the
    CPU sees what the card would do. Calibration reads the codes back
    under the ``dequant`` backend (``Deployment.calibrate`` does)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an operand requires grad under grad mode; "
            "calibrate under the 'dequant' backend (Deployment.calibrate does), "
            "or call it under torch.no_grad()"
        )


def tickets(held: Dict[tuple, tuple], capture_id, device, stream: int,
            count: int) -> torch.Tensor:
    """``count`` int32 tickets for a launch on ``stream``: zeros that every
    launch leaves zero, so launches sharing them must not overlap. Eager
    launches share their stream's, which run in order. A CUDA graph gets
    its own, allocated (and zeroed, one small node a graph) where its
    capture first needs them, so graphs may replay on any streams at once.
    ``held`` maps (device, stream) to (capture id, tensor); ``capture_id``
    is a library's export that gives the id of the capture running on a
    stream (0 when none is)."""
    capture = ctypes.c_ulonglong(0)
    err = capture_id(stream, ctypes.byref(capture))
    if err != 0:
        raise RuntimeError(f"stream capture query failed: cudaError {err}")
    entry = held.get((device, stream))
    if entry is None or entry[0] != capture.value or entry[1].numel() < count:
        entry = held[(device, stream)] = (
            capture.value, torch.zeros((count,), dtype=torch.int32, device=device))
    return entry[1]
