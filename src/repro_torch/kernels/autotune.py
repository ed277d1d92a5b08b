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
* the ADC kernel's tensor-core body (bf16 x): the ordered parts of its K
  split (``adc_plan``), so that every unfused leaf at every serving row
  count launches about three blocks an SM, within one wave;
* the tiled launcher's tensor-core bodies (int8; f32 with bf16 x): their
  tile rows and the rows of K per split (``tiled_tiles``, per body), so
  that every full-width leaf at prefill fills one wave of blocks on the
  card's 132 SMs;
* the GEMV launcher's tensor-core bodies (f32 with bf16 x; int8 with any
  x): the parts of their ordered K split (``gemv_plan``, per body), and
  from which row bucket the int8 body takes its row scales in a pass of
  their own (``gemv_int8_prescale``);
* whether a call of the f32 body with f32 x is narrow (``use_narrow``:
  N <= ``NARROW_MAX_N``, every MoE router), which both launchers then send
  to one split-K kernel, and that kernel's parts of K (``narrow_plan``);
* whether an ADC call with f32 x is narrow (``use_adc_narrow``, the same
  rule: the routers under codes_adc), which then runs one split-K kernel,
  and that kernel's parts of K (``adc_narrow_plan``).

The ADC kernel's 128-row block and 256-row array tile are not choices:
max |x| is taken per (block, tile) and each tile's current is digitized
on its own, so the result depends on both (``ADC_BLOCK_ROWS``,
``ADC_ARRAY_ROWS``).
"""
from __future__ import annotations

from typing import NamedTuple

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


# rows of K per pipeline stage, per tensor-core body: f32 (bf16 x; kMmaK)
# and int8 (kMmaKInt8). Measured on the H100 at the qwen3-1.7b leaves at
# 96 and 256 rows (PERF.md): f32, 32-row stages; int8, 64-row stages
# (32-row stages were slower, tools/sweep_tiled_int8.py).
MMA_BODIES = {"f32": 32, "int8": 64}
# tile rows: 64 only where M fits one such tile; otherwise 128, so that
# fewer row tiles read the codes again
MMA_TILE_M = (64, 128)
MMA_TILE_N = 64         # tile columns, both bodies (kMmaN)
SMS = 132               # H100 SXM
WAVE = 2 * SMS          # blocks the card runs at once (two an SM, either body)
MIN_SPLIT_ROWS = 128    # a K split keeps at least this many rows of K


class TilePlan(NamedTuple):
    bm: int       # rows of a tile; its columns are MMA_TILE_N
    k_split: int  # rows of K per split, a multiple of the body's stage

    def splits(self, k: int) -> int:
        return -(-k // self.k_split)

    def blocks(self, m: int, n: int, k: int) -> int:
        return -(-m // self.bm) * -(-n // MMA_TILE_N) * self.splits(k)


def tiled_tiles(m: int, n: int, k: int, accum: str) -> TilePlan:
    """A tensor-core body's tile for an (m, k) x (k, n) product, with K
    split into as many ordered parts (summed by a second pass) as fill one
    wave of blocks, each part at least ``MIN_SPLIT_ROWS`` rows of K.
    Measured on the H100 at the qwen3-1.7b leaves (PERF.md): one full wave
    beats both fewer blocks and a second, partial wave."""
    stage = MMA_BODIES[accum]
    bm = MMA_TILE_M[0] if m <= MMA_TILE_M[0] else MMA_TILE_M[1]
    tiles = -(-m // bm) * -(-n // MMA_TILE_N)
    k_steps = -(-k // stage)
    splits = max(1, WAVE // tiles)
    steps = max(-(-k_steps // splits), -(-MIN_SPLIT_ROWS // stage))
    return TilePlan(bm, min(steps, k_steps) * stage)


def use_gemv(m: int) -> bool:
    return m <= GEMV_MAX_M


def gemv_rows(m: int) -> int:
    """Smallest instantiated row bucket that holds ``m`` rows."""
    for bucket in GEMV_ROW_BUCKETS:
        if m <= bucket:
            return bucket
    raise ValueError(f"GEMV launcher takes at most {GEMV_MAX_M} rows, got {m}")


# the GEMV launcher's tensor-core bodies (dora_linear.cu: f32,
# dora_gemv_mma_kernel; int8, dora_gemv_int8_kernel), both: output columns
# per block (kGemvMmaN), rows of K per pipeline stage (kGemvMmaK), and most
# chunks of K of their X @ A blocks (kGemvXaChunks), each whole slabs of
# XA_SLAB rows (kPrepRows) for XA_ROW_TILE rows of x a block
# (kPrepRowTile); the int8 body keeps its X @ A blocks within
# GEMV_XA_CHUNKS in all (fewer chunks from 32 rows up). Two blocks of the
# f32 body fit an SM (launch bounds, at most 96 KB of shared memory), so
# WAVE is its wave too; the int8 body's is gemv_int8_wave.
GEMV_MMA_COLS = 128
GEMV_MMA_STAGE = 64
GEMV_XA_CHUNKS = 24
XA_SLAB = 256
XA_ROW_TILE = 16


def gemv_blocks(m: int, n: int, k: int, parts: int, accum: str) -> int:
    """Blocks of one launch of a tensor-core GEMV body (the launcher's
    grid): a block per 128-column strip and part of K, and the X @ A
    blocks, a 16-row tile of x times a chunk of K (f32: at most
    GEMV_XA_CHUNKS chunks; int8: at most GEMV_XA_CHUNKS blocks in all)."""
    tiles = -(-m // XA_ROW_TILE)
    slabs = -(-k // XA_SLAB)
    sub = -(-slabs // (GEMV_XA_CHUNKS if accum == "f32" else GEMV_XA_CHUNKS // tiles))
    strips = -(-n // GEMV_MMA_COLS)
    return strips * parts + tiles * -(-slabs // sub)


def gemv_plan(m: int, n: int, k: int, accum: str) -> int:
    """A tensor-core GEMV body's parts of K (whole stages each, at most one
    per stage of K) for an (m, k) x (k, n) product.

    f32: the fewest that give every SM a block of column strip and part,
    fewer where the launch would not fit one wave. Fewer parts mean fewer
    raw sums for the strip's last block to add.

    int8: the most whose whole launch, X @ A blocks included, fits one
    wave (``gemv_int8_wave``; one part where even that exceeds it). More
    blocks keep more code stages in flight, and the int8 body, which
    quantizes each stage behind a barrier, needs them: measured on the H100
    at the qwen3-1.7b leaves (tools/sweep_gemv.py --accum int8), one block
    an SM took 10% longer a layer at M = 4 (13% at M = 1, 8% at M = 32),
    and this plan is within 2% of the best split of each leaf up to 8
    rows, 6% at 16 and 3% at 32."""
    stages = -(-k // GEMV_MMA_STAGE)
    strips = -(-n // GEMV_MMA_COLS)
    if accum == "int8":
        xa_blocks = gemv_blocks(m, n, k, 0, accum)
        return max(1, min(stages, (gemv_int8_wave(m) - xa_blocks) // strips))
    parts = min(stages, -(-SMS // strips))
    while parts > 1 and gemv_blocks(m, n, k, parts, accum) > WAVE:
        parts -= 1
    return parts


def gemv_int8_wave(m: int) -> int:
    """Blocks of the int8 GEMV the card holds at once for ``m`` rows: two
    an SM below 64 rows, one at 64 (dora_gemv_int8_kernel's launch bounds;
    a static_assert in its GemvInt8Smem holds its shared memory, for
    either x type, to two blocks an SM)."""
    return SMS * (2 if gemv_rows(m) < GEMV_MAX_M else 1)


# the int8 GEMV body's row scales: from this row bucket up a pass of their
# own (row_scale_kernel, each row read once) runs before the kernel; below
# it every block of the one launch reads all of x for them, which costs
# more than that pass once x is large. Measured on the H100 at the
# qwen3-1.7b leaves (tools/sweep_gemv.py --accum int8): inside the launch
# 7-8% faster a layer at 1 to 8 rows and 2% at 16; the pass 4% faster at
# 32 and 5% at 64
GEMV_INT8_PRESCALE_ROWS = 32


def gemv_int8_prescale(m: int) -> bool:
    """Whether the int8 GEMV of ``m`` rows takes its row scales in a pass
    before the kernel (two launches) rather than inside it (one)."""
    return gemv_rows(m) >= GEMV_INT8_PRESCALE_ROWS


# The ADC kernel's tensor-core body (crossbar_mvm.cu, adc_mma_kernel): its
# n-tiles of 8 rows of x (kMmaRowTiles; a block holds its 128-row block in
# the fewest that cover min(M, 128)), output columns a warp owns
# (kMmaWarpCols) and a block (kMmaN, the strip), rows of K a stage (kMmaK),
# stages of its copy ring (kMmaStages), and the shared memory an SM offers
# blocks (228 KB, 1 KB of it reserved a block).
ADC_ROW_TILES = (1, 2, 4, 8, 12, 16)
ADC_WARP_COLS = 16
ADC_STRIP = 64
ADC_STAGE_ROWS = 64
ADC_STAGES = 4
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024


def adc_row_tiles(m: int) -> int:
    """The n-tiles of 8 rows a block of the ADC kernel holds for ``m``
    rows of x: the fewest that cover one 128-row block's rows."""
    rows = min(m, ADC_BLOCK_ROWS)
    return next(nt for nt in ADC_ROW_TILES if 8 * nt >= rows)


def adc_min_blocks(nt: int) -> int:
    """Blocks an SM must hold by the kernel's launch bounds
    (AdcMinBlocks): four below 8 tiles of rows, two from there."""
    return (1 if nt >= 8 else 2) * (8 // (ADC_STRIP // ADC_WARP_COLS))


def adc_smem(nt: int) -> int:
    """Dynamic shared memory of one block: the ring of both code slabs and
    the x slab (AdcSmem::RING)."""
    return ADC_STAGES * (2 * ADC_STAGE_ROWS * ADC_STRIP + 16 * nt * ADC_STAGE_ROWS)


def adc_wave(m: int) -> int:
    """Blocks the card holds at once: SMS times the blocks an SM is sure
    to hold (launch bounds and shared memory)."""
    nt = adc_row_tiles(m)
    fit = SMEM_PER_SM // (adc_smem(nt) + SMEM_PER_BLOCK_RESERVED)
    return SMS * min(adc_min_blocks(nt), fit)


def adc_blocks(m: int, n: int, parts: int) -> int:
    """Blocks of one launch: a block per (128-row block, strip, part)."""
    return -(-m // ADC_BLOCK_ROWS) * -(-n // ADC_STRIP) * parts


# blocks the ADC kernel's plan aims at: about three a SM (measured on the
# H100, tools/sweep_adc.py: fewer leave the code stream short of loads in
# flight, more add partials for the strips' last blocks to sum)
ADC_TARGET_BLOCKS = 3 * SMS


def adc_plan(m: int, k: int, n: int) -> int:
    """Ordered parts of K, on 256-row tile boundaries, of the ADC kernel's
    launch for an (m, k) x (k, n) product with bf16 x: the most (at most
    one a tile) that keep the launch within ``ADC_TARGET_BLOCKS`` and one
    wave. Measured on the H100 at the qwen3-1.7b leaves for 4, 32, 96 and
    256 rows (tools/sweep_adc.py)."""
    tiles = -(-k // ADC_ARRAY_ROWS)
    cap = min(ADC_TARGET_BLOCKS, adc_wave(m))
    return max(1, min(tiles, cap // adc_blocks(m, n, 1)))


# The narrow body (dora_linear.cu, dora_narrow_kernel): the f32 body with
# f32 x at N <= NARROW_MAX_N (kNarrowMaxN), which covers every router of
# the zoo (mixtral-8x22b N 8, deepseek-v2-lite N 64), under either
# launcher. A block holds NARROW_ROWS rows of x (kNarrowM) and all N + R
# columns, over a part of K made of whole slabs of MIN_SPLIT_ROWS rows
# (kNarrowSlab), whose sums the row tile's last block adds in slab order.
NARROW_MAX_N = 64
# tile rows, measured on the H100 at the routers' rows (tools/narrow_costs.py,
# tiles of 8, 16 and 32 rows; PERF.md): 16 is the best or within 1% of it
# at mixtral's 1-64 rows and deepseek-v2-lite's 4 and 256; 32 is 1.26x
# faster at mixtral's 96-row prefill and 8 1.4x at deepseek-v2-lite's 32
# rows, each up to 1.4-1.6x slower at the others' rows
NARROW_ROWS = 16


def use_narrow(n: int, accum: str, f32_x: bool) -> bool:
    """Whether a fused-linear call runs the narrow body: the f32 body, f32
    x and at most ``NARROW_MAX_N`` output columns."""
    return accum == "f32" and f32_x and n <= NARROW_MAX_N


def narrow_plan(m: int, n: int, k: int) -> int:
    """The narrow body's parts of K for an (m, k) x (k, n) product: whole
    slabs of ``MIN_SPLIT_ROWS`` rows, as many parts as keep the launch
    (row tiles x parts) within one wave of two blocks an SM (``WAVE``),
    each part at most ``per`` slabs (the kernel deals them out as evenly
    as they go). The result does not depend on the parts: every block
    writes one sum a slab. Measured on the H100 at the routers' rows
    (tools/narrow_costs.py; PERF.md): against one block an SM, 21% faster
    at mixtral's 64 rows, 11% at 96 and 27% at deepseek-v2-lite's 256,
    the same where both give one slab a part; a part of one slab at every
    row was within 4% of it either way."""
    del n  # a block holds every column
    tiles = -(-m // NARROW_ROWS)
    slabs = -(-k // MIN_SPLIT_ROWS)
    per = -(-slabs // max(1, WAVE // tiles))
    return -(-slabs // per)


# The ADC kernel's narrow body (crossbar_mvm.cu, adc_narrow_kernel): f32 x at
# N <= NARROW_MAX_N (the routers under codes_adc). A block holds a 128-row
# block's rows and every column over a part of K made of whole 256-row
# tiles, in a ring of ADC_NARROW_STAGES stages of ADC_NARROW_STAGE_ROWS rows
# (kNarrowK, kNarrowStages): x rows padded to 4 with a row stride of
# ADC_NARROW_STAGE_ROWS + 4 floats, both code slices N (padded to 4) bytes a
# row.
ADC_NARROW_STAGE_ROWS = 64
ADC_NARROW_STAGES = 5


def use_adc_narrow(n: int, f32_x: bool) -> bool:
    """Whether an ADC call runs the narrow body: f32 x and at most
    ``NARROW_MAX_N`` output columns (bf16 x runs the tensor-core body at
    any N, f32 x above it the three-launch SIMT body)."""
    return f32_x and n <= NARROW_MAX_N


def adc_narrow_smem(m: int, n: int) -> int:
    """Dynamic shared memory of one block of the narrow body: the ring
    (kNarrowStages x narrow_stage_bytes) for the rows of one row block."""
    rp = -(-min(m, ADC_BLOCK_ROWS) // 4) * 4
    np_ = -(-n // 4) * 4
    return ADC_NARROW_STAGES * (rp * (ADC_NARROW_STAGE_ROWS + 4) * 4
                                + 2 * ADC_NARROW_STAGE_ROWS * np_)


def adc_narrow_wave(m: int, n: int) -> int:
    """Blocks of the narrow body the card holds at once: two an SM
    (``WAVE``) where their shared memory fits, else as many as fit."""
    fit = SMEM_PER_SM // (adc_narrow_smem(m, n) + SMEM_PER_BLOCK_RESERVED)
    return SMS * max(1, min(2, fit))


def adc_narrow_plan(m: int, k: int, n: int) -> int:
    """The narrow body's parts of K for an (m, k) x (k, n) ADC product with
    f32 x: whole 256-row tiles, a part per tile while the launch (row blocks
    x parts) fits one wave (``adc_narrow_wave``), fewer where it would not
    (the kernel deals the tiles out as evenly as they go). The result does
    not depend on the parts: every tile's digitized partial is written and
    the row block's last block adds them in tile order."""
    tiles = -(-k // ADC_ARRAY_ROWS)
    blocks = -(-m // ADC_BLOCK_ROWS)
    return max(1, min(tiles, adc_narrow_wave(m, n) // blocks))
