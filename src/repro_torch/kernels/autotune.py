"""Launch policy for the crossbar kernels on Hopper.

Replaces ``repro/kernels/autotune.py``, whose tile plans were sized for
a TPU's VMEM and matrix unit. The CUDA kernels fix their own tiles
(``kernels/csrc/*.cu``) and mask ragged edges, so nothing is ever padded
and the only decisions left are:

* which fused-linear launcher runs: the GEMV launcher while all M rows
  fit one block (``M <= GEMV_MAX_M``, the dispatch rule the reference
  keeps), the tiled launcher above it; both run either body (f32, int8);
* the GEMV launcher's row bucket: the power of two the kernel is
  instantiated for (each thread holds that many accumulators);
* the ADC kernel's output rows per block, the smallest instantiation
  that covers the rows of one ADC block, so a decode tick does not pay
  for 128-row tiles.

The ADC kernel's 128-row block and 256-row array tile are not choices:
max |x| is taken per (block, tile) and each tile's current is digitized
on its own, so the result depends on both (``ADC_BLOCK_ROWS``,
``ADC_ARRAY_ROWS``).
"""
from __future__ import annotations

# largest M the GEMV launcher takes; above it the tiled launcher runs
GEMV_MAX_M = 64

# the GEMV kernel's row-bucket instantiations (dora_linear.cu)
GEMV_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# the fused linear's accumulation bodies
ACCUMS = ("f32", "int8")

# ADC semantics (crossbar_mvm.cu): rows of x sharing one DAC reference,
# and rows of one crossbar activation
ADC_BLOCK_ROWS = 128
ADC_ARRAY_ROWS = 256

# the ADC kernel's output-row instantiations (crossbar_mvm.cu)
ADC_TILE_ROWS = (16, 32, 64, 128)


def use_gemv(m: int) -> bool:
    return m <= GEMV_MAX_M


def gemv_rows(m: int) -> int:
    """Smallest instantiated row bucket that holds ``m`` rows."""
    for bucket in GEMV_ROW_BUCKETS:
        if m <= bucket:
            return bucket
    raise ValueError(f"GEMV launcher takes at most {GEMV_MAX_M} rows, got {m}")


def adc_tile_rows(m: int) -> int:
    """Output rows per block of the ADC kernel for ``m`` rows of x."""
    return next(t for t in ADC_TILE_ROWS if min(m, ADC_BLOCK_ROWS) <= t)
