"""Launch policy for the fused crossbar kernels on Hopper.

Replaces ``repro/kernels/autotune.py``, whose tile plans were sized for
a TPU's VMEM and matrix unit. The CUDA kernels fix their own tiles
(``kernels/csrc/dora_linear.cu``) and mask ragged edges, so nothing is
ever padded and the only decisions left are:

* which launcher runs: the GEMV launcher while all M rows fit one block
  (``M <= GEMV_MAX_M``, the dispatch rule the reference keeps), the
  tiled launcher above it;
* the GEMV launcher's row bucket: the power of two the kernel is
  instantiated for (each thread holds that many f32 accumulators).
"""
from __future__ import annotations

# largest M the GEMV launcher takes; above it the tiled launcher runs
GEMV_MAX_M = 64

# the GEMV kernel's row-bucket instantiations (dora_linear.cu)
GEMV_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def use_gemv(m: int) -> bool:
    return m <= GEMV_MAX_M


def gemv_rows(m: int) -> int:
    """Smallest instantiated row bucket that holds ``m`` rows."""
    for bucket in GEMV_ROW_BUCKETS:
        if m <= bucket:
            return bucket
    raise ValueError(f"GEMV launcher takes at most {GEMV_MAX_M} rows, got {m}")
