// ADC-faithful analog crossbar MVM over resident uint8 conductance codes,
// for Hopper (sm_90a):
//
//     Y = scale * sum over 256-row array tiles t of
//             ADC(X[:, t] @ (G+ - G-)[t, :]),
//     ADC(c) = clip(rint(c / step), +-adc_max) * step,
//     step = (256 * code_max * max|X[block, t]|) / (adc_max * 16)
//
// with one step per (128-row block of X, 256-row array tile): the DAC
// reference of one physical crossbar activation. Replaces the Pallas TPU
// kernel repro/kernels/crossbar_mvm.py::crossbar_mvm (body _kernel). The
// 128-row block and the 256-row tile are semantics, not tile choices:
// the result depends on them, so this kernel fixes both.
//
// Which body runs where:
//
//     x     N      kernels                                         arithmetic
//     bf16  any    adc_mma_kernel (one launch)                     mma.sync bf16, f32 acc
//     f32   <= 64  adc_narrow_kernel (one launch)                  SIMT f32, K split
//     f32   > 64   adc_step_kernel, adc_tile_kernel, adc_sum_kernel  SIMT f32
//
// The serving path (substrate/exec.py::rimc_mvm_adc) passes bf16 x to the
// dense leaves and f32 x to the MoE routers (N <= 64, the narrow body). f32
// x never takes the tensor cores: a bf16 MMA would round it. No serving path
// runs f32 x above 64 columns.
//
// Faithfulness. The reference forms each tile's current in f32, then
// rounds it. Here too: a tile's current is finished in f32 before it is
// rounded, every split of K falls on a 256-row boundary, and the
// digitized partials are summed in ascending tile order with the
// reference's association (acc = cur[0]; acc = acc + cur[t]). The step is
// computed in f32 in the reference's order, (256 * code_max * absmax) /
// (adc_max * 16), with IEEE division and round-half-even, and the adds and
// multiplies after the dot are explicitly rounded (no FMA contraction).
// Only the order of the f32 dot inside a tile differs from the reference,
// which can move a current across a rounding boundary: then one output
// differs by one ADC step times its column scale. When every current is
// an exact integer below 2^24 (integer-valued x), the result is exact in
// any order. bf16 x times G+ - G- (an integer in [-255, 255]) is exact in
// f32, so the tensor-core body differs from the SIMT one only in that
// order, and its result does not depend on its plan (the parts of K, nor
// the tile shape that tools/sweep_adc.py varies): each tile's current is
// summed the same way by whichever block owns it.
//
// What bounds it on an H100. Each weight is two code bytes read once; the
// work is M multiply-adds per weight, bf16 x by an integer in [-255, 255],
// exact in bf16 at the card's dense rate of 989 TFLOP/s. Up to M ~ 295
// rows (the ridge: 989 TFLOP/s over 3.35 TB/s, 2 flops per 2 code bytes a
// row) the code stream bounds it, above that the bf16 operations. Per
// qwen3-1.7b layer (the seven unfused leaves) that is 0.0302 ms at M = 4
// and 0.0392 ms at M = 256 (bytes).
//
// The tensor-core body (bf16 x), adc_mma_kernel. One launch per call:
// * A block of 4 warps owns a strip of kMmaN = 64 output columns and one
//   128-row block of x (M > 128: a block per row block, the row block the
//   grid's fastest index, so the blocks that read the same codes run
//   together), all its rows at once, padded to NT MMA tiles of 8 rows with
//   zeros (NT from min(M, 128): 1, 2, 4, 8, 12 or 16). It walks the
//   256-row array tiles of its part of K in ascending order.
// * A ring of kMmaStages = 4 stages of kMmaK = 64 rows of 16-byte cp.async
//   copies brings in both code slabs (64 x 64 u8) and the x slab (8 NT x
//   64 bf16); tiles are unpadded, their 16-byte chunks XOR-swizzled by row
//   so that the MMAs' shared loads hit distinct banks. tools/sweep_adc.py
//   builds this source with 128-column strips, 32-row stages and rings of
//   3 and 6 stages too: up to 96 rows none was more than 2% faster a
//   layer; at 256 rows 128-column strips of 3 stages were ~5% faster.
// * As each stage lands, max |x| of the (row block, tile) is folded in
//   from the staged x (bf16 bits & 0x7fff compare as unsigned integers:
//   exact in any order). At the tile's end the block's max gives the step,
//   the current is digitized in registers, added to a running f32 sum
//   (starting from -0, so the first add gives cur[0] bit for bit), and the
//   current is reset.
// * The product is the swapped Y^T = W^T X^T on mma.sync m16n8k16 bf16
//   with f32 accumulators: warp w owns 16 output columns, the MMA's rows
//   (column 2g at MMA row g, 2g + 1 at g + 8), and all rows of each
//   stage; x rows are the MMA's columns, 8 a tile. Lane (g, t) reads two
//   bytes (its two columns) of code rows 4t + i (i < 4) of each 16-row
//   step, and G+ - G- becomes bf16 in registers: each byte OR-ed into the
//   mantissa of 2^23, one exact f32 subtract, one cvt.rn.bf16x2. The MMA's
//   k index 2t + (0, 1, 8, 9) is the step's row 4t + (0, 1, 2, 3), so the
//   B fragment is 4 contiguous bf16 of an x row: one 8-byte shared load.
//   No float or s8 copy of the codes reaches device memory, and no
//   partial current does.
// * Filling the card: where the strips and row blocks alone leave SMs
//   idle, K is split into `parts` ordered parts on 256-row tile
//   boundaries. The first part keeps its running sum and writes it in the
//   first slot of a scratch; every other part writes each tile's digitized
//   partial in a slot of its own (rows x 64 f32 a tile). The last block of
//   a strip to arrive (a ticket it resets) adds the slots in ascending
//   tile order, so the result is bitwise independent of the split. No
//   data goes through
//   atomics: two launches are bitwise equal, and the tickets are zero
//   again at the end (one buffer per stream for eager calls, one per CUDA
//   graph capture, as the tensor-core GEMV's). The plan splits K into the
//   most parts that keep the launch within about three blocks an SM and
//   one wave (autotune.adc_plan; tools/sweep_adc.py measures it against
//   every split and tile shape at each qwen3-1.7b leaf for 4, 32, 96 and
//   256 rows).
// * Ragged shapes: the copies need K % 8 == 0, N % 16 == 0 and 16-byte
//   aligned operands; otherwise the same kernel stages with masked,
//   zero-filling scalar loads. Zeros change neither a current
//   nor a max |x|, so nothing is padded in memory.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md;
// tools/adc_breakdown.py, tools/adc_costs.py): per qwen3-1.7b layer 0.087
// ms at M = 4 (35% of its bound; the three-launch SIMT body took 0.32 ms),
// 0.123 at 32, 0.244 at 96, 0.42 at 256 (9%). Registers (-Xptxas -v):
// 96-118 up to 4 tiles of rows (the masked path: 128 and a 24-byte spill
// at 4), 204 at 8, 236 at 12, and at 16 (M > 96) 255 with a 188-byte
// spill. At the decode tick the copies stream the codes at ~72% of the
// HBM rate; the rest is per-leaf latency: the launch, the tile ends and
// the strips' last blocks (ticket, ordered sum of the parts), about half
// of the kernel. From 32 rows up
// the last blocks' ordered sum and the partials written for it grow with
// M, and each warp's single 16-column tile reads one x fragment from
// shared memory per MMA, so shared-memory traffic, not the tensor cores,
// sets the MMA phase.
//
// The SIMT body (f32 x), three launches: a step prologue (one step per
// (row block, K tile)); the tile kernel, grid (N / 128, K tiles, M / TM),
// a block owning TM output rows (16, 32, 64 or 128, the smallest that
// covers min(M, 128)) x 128 columns for ONE 256-row K tile, a shared-
// memory SIMT product (codes become exact f32 weights G+ - G- as the tile
// is loaded) whose finished tile current it digitizes and writes to a
// partial (K tiles x M x N f32 scratch); and an ordered sum of the
// partials times the column scale.
//
// The narrow body (f32 x, N <= 64: the routers), adc_narrow_kernel, one
// launch (details at the kernel): a block holds a 128-row block's rows and
// all N columns over a part of K made of whole 256-row tiles, digitizes each
// tile's current itself and writes it to the (K tiles x M x N) scratch; the
// row block's last block (a ticket) adds them in tile order.
//
// Plain C interface (loaded with ctypes). Each function returns
// cudaGetLastError() after its launches; the Python wrapper raises on
// anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 128;  // rows of X that share one DAC reference
constexpr int kArrayRows = 256;  // rows of one crossbar activation (K tile)

// ---------------------------------------------------------------------------
// the SIMT body (f32 x)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileN = 128;
constexpr int kTileK = 8;

// byte i of w as the float 2^23 + byte (exact)
__device__ __forceinline__ float byte_f32(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | (uint32_t)i));
}

// grid (row blocks, K tiles): step[b * T + t] from max |x| over rows
// [128 b, 128 b + 128) and columns [256 t, 256 t + 256) of X
__global__ void __launch_bounds__(kThreads)
    adc_step_kernel(const float* __restrict__ x, float* __restrict__ step, int M, int K,
                    float full_scale, float denom) {
  __shared__ float wmax[kThreads / 32];
  const int tid = threadIdx.x;
  const int k = blockIdx.y * kArrayRows + tid;
  const int m0 = blockIdx.x * kBlockRows, m1 = min(M, m0 + kBlockRows);
  float amax = 0.f;
  if (k < K)
    for (int m = m0; m < m1; ++m) amax = fmaxf(amax, fabsf(x[(size_t)m * K + k]));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) wmax[tid >> 5] = amax;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, wmax[w]);
    step[blockIdx.x * gridDim.y + blockIdx.y] =
        __fdiv_rn(__fmul_rn(full_scale, fmaxf(amax, 1e-8f)), denom);
  }
}

// RM rows per thread, TM = 16 RM rows per block; VEC: 4-byte code loads
template <int RM, bool VEC>
__global__ void __launch_bounds__(kThreads)
    adc_tile_kernel(const float* __restrict__ x, const uint8_t* __restrict__ gp,
                    const uint8_t* __restrict__ gn, const float* __restrict__ step,
                    float* __restrict__ part, int M, int K, int N, float adc_max) {
  constexpr int TM = 16 * RM;
  __shared__ __align__(16) float as[kTileK][TM];      // x tile, transposed
  __shared__ __align__(16) float bs[kTileK][kTileN];  // G+ - G- tile
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int t = blockIdx.y, T = gridDim.y;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.z * TM;
  const int kb = t * kArrayRows, ke = min(K, kb + kArrayRows);
  const int ck = tid / 32, cn = (tid % 32) * 4;  // code loader: row x 4 columns

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kTileK) {
    __syncthreads();
    for (int e = tid; e < TM * kTileK; e += kThreads) {
      const int r = e / kTileK, kk = e % kTileK;
      const int m = m0 + r, k = k0 + kk;
      as[kk][r] = (m < M && k < ke) ? x[(size_t)m * K + k] : 0.f;
    }
    {
      const int k = k0 + ck, n = n0 + cn;
      uint32_t p = 0u, q = 0u;
      if (k < ke) {
        if (VEC && n + 4 <= N) {
          p = __ldg(reinterpret_cast<const uint32_t*>(gp + (size_t)k * N + n));
          q = __ldg(reinterpret_cast<const uint32_t*>(gn + (size_t)k * N + n));
        } else {
          for (int i = 0; i < 4; ++i)
            if (n + i < N) {
              p |= (uint32_t)__ldg(gp + (size_t)k * N + n + i) << (8 * i);
              q |= (uint32_t)__ldg(gn + (size_t)k * N + n + i) << (8 * i);
            }
        }
      }
      float4 w;
      w.x = byte_f32(p, 0) - byte_f32(q, 0);
      w.y = byte_f32(p, 1) - byte_f32(q, 1);
      w.z = byte_f32(p, 2) - byte_f32(q, 2);
      w.w = byte_f32(p, 3) - byte_f32(q, 3);
      *reinterpret_cast<float4*>(&bs[ck][cn]) = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = as[kk][ty * RM + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
  }

  // digitize this tile's current: one step per (128-row block, K tile)
  const float st = step[(m0 / kBlockRows) * T + t];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n >= N) continue;
      const float code = fminf(fmaxf(rintf(__fdiv_rn(acc[i][j], st)), -adc_max), adc_max);
      part[((size_t)t * M + m) * N + n] = __fmul_rn(code, st);
    }
  }
}

// out[m][n] = scale[n] * (sum over t ascending of part[t][m][n])
__global__ void __launch_bounds__(kThreads)
    adc_sum_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                   float* __restrict__ out, int M, int N, int T) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (e >= MN) return;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) acc = __fadd_rn(acc, part[(size_t)t * MN + e]);
  out[e] = __fmul_rn(acc, scale[e % N]);
}

template <int RM>
cudaError_t launch_tiles(const float* x, const void* gp, const void* gn, const float* step,
                         float* part, int M, int K, int N, int T, float adc_max,
                         cudaStream_t s) {
  constexpr int TM = 16 * RM;
  const dim3 grid((N + kTileN - 1) / kTileN, T, (M + TM - 1) / TM);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(gp) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(gn) % 4 == 0;
  auto kernel = vec ? adc_tile_kernel<RM, true> : adc_tile_kernel<RM, false>;
  kernel<<<grid, kThreads, 0, s>>>(x, (const uint8_t*)gp, (const uint8_t*)gn,
                                   step, part, M, K, N, adc_max);
  return cudaGetLastError();
}

cudaError_t launch(const float* x, const void* gp, const void* gn, const void* scale,
                   void* out, void* step, void* part, int M, int K, int N,
                   int tile_rows, float full_scale, float denom, float adc_max,
                   cudaStream_t s) {
  const int nb = (M + kBlockRows - 1) / kBlockRows, T = (K + kArrayRows - 1) / kArrayRows;
  adc_step_kernel<<<dim3(nb, T), kThreads, 0, s>>>(x, (float*)step, M, K, full_scale, denom);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (tile_rows) {
    case 16: e = launch_tiles<1>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    case 32: e = launch_tiles<2>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    case 64: e = launch_tiles<4>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    case 128: e = launch_tiles<8>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const size_t MN = (size_t)M * N;
  adc_sum_kernel<<<(unsigned)((MN + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const float*)part, (const float*)scale, (float*)out, M, N, T);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core body (bf16 x)
// ---------------------------------------------------------------------------

// The tile shape (autotune.ADC_*), measured on the H100 by
// tools/sweep_adc.py, which also builds this source with other values
constexpr int kMmaWarpCols = 16;  // output columns a warp owns (the MMA's rows)
constexpr int kMmaN = 64;         // output columns a block: a strip
constexpr int kMmaK = 64;         // rows of K a stage (32 or 64)
constexpr int kMmaStages = 4;     // stages of the copy ring
constexpr int kMmaWarps = kMmaN / kMmaWarpCols;
static_assert(kMmaN % (4 * kMmaWarpCols) == 0 && (kMmaK == 32 || kMmaK == 64) &&
                  kArrayRows % kMmaK == 0 && kMmaStages >= 2,
              "tile shape");
// n-tiles of 8 rows of x (autotune.ADC_ROW_TILES): a block holds the rows
// of its 128-row block in the smallest of these that covers min(M, 128)
constexpr int kMmaRowTiles[] = {1, 2, 4, 8, 12, 16};

// blocks an SM must hold (launch bounds, autotune.adc_min_blocks): four of
// 4 warps while the current and the running sum fit 128 registers a
// thread, two from 8 tiles of rows up
template <int NT>
struct AdcMinBlocks {
  static constexpr int value = (NT >= 8 ? 1 : 2) * (8 / kMmaWarps);
};

// Shared memory of one stage: the G+ and G- slabs (kMmaK x kMmaN u8) and
// the x slab (8 NT x kMmaK bf16), all unpadded, their 16-byte chunks
// swizzled; the ring holds kMmaStages of them (autotune.adc_smem)
template <int NT>
struct AdcSmem {
  static constexpr int C = kMmaK * kMmaN;
  static constexpr int X = 8 * NT * kMmaK * 2;
  static constexpr int STAGE = 2 * C + X;
  static constexpr int RING = kMmaStages * STAGE;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16x16 bf16, row) x b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// G+ - G- of byte i of (p0, q0) and of (p1, q1) as two bf16 (exact: |d| <=
// 255), the first in the low half
__device__ __forceinline__ uint32_t code_diff2_bf16x2(uint32_t p0, uint32_t q0, uint32_t p1,
                                                      uint32_t q1, int i) {
  const __nv_bfloat162 d = __floats2bfloat162_rn(byte_f32(p0, i) - byte_f32(q0, i),
                                                 byte_f32(p1, i) - byte_f32(q1, i));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// byte offset of 16-byte chunk c of code row r in a slab kMmaN bytes
// wide: swizzled by bits 2-3 of the row, so the four rows 4t + i (same i)
// that a warp's lanes read at once fall in four different chunks
__device__ __forceinline__ int code_off(int r, int c) {
  return r * kMmaN + ((c ^ ((r >> 2) & 3)) << 4);
}
// byte offset of chunk c (K 8c..8c+7) of x row rho in a slab kMmaK wide:
// swizzled so that the rows g of a half warp (each reading 8 bytes of
// chunk 2h + t / 2) fall in different banks: 64-row stages are 32 words a
// row, on the same banks; 32-row ones 16 words, alternating
__device__ __forceinline__ int x_off(int rho, int c) {
  const int sw = kMmaK == 64 ? (rho & 3) << 1 : ((rho >> 1) & 1) << 1;
  return rho * kMmaK * 2 + ((c ^ sw) << 4);
}

// Grid: one block per (strip, part of K, row block), the row block
// fastest. Block (rb, part, strip) computes rows [128 rb, 128 rb + 128) x
// columns [kMmaN strip, kMmaN strip + kMmaN) over the 256-row tiles
// [t0, t1) of its part (T tiles in K, split as evenly as they go),
// digitizing each tile's current with the step of (rb, tile). parts == 1:
// out = sum * scale. Otherwise, with a1 = T / parts the first tile of part
// 1, ws holds T - a1 + 1 slots of M x N: part 0 writes its running sum in
// slot 0, every other part each tile t's digitized partial in slot
// t - a1 + 1, and the strip's last block to arrive (a ticket in
// sem[rb * strips + strip], which it resets) adds the slots in order,
// times the column scale.
template <int NT, bool VEC>
__global__ void __launch_bounds__(32 * kMmaWarps, (AdcMinBlocks<NT>::value))
    adc_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ gp,
                   const uint8_t* __restrict__ gn, const float* __restrict__ scale,
                   float* __restrict__ out, float* __restrict__ ws, int* __restrict__ sem,
                   int M, int K, int N, int parts, float full_scale, float denom,
                   float adc_max) {
  using L = AdcSmem<NT>;
  constexpr int TN = kMmaN, BK = kMmaK, WARPS = kMmaWarps, THREADS = 32 * WARPS;
  constexpr int CPR = TN / 16;  // 16-byte chunks of a code row
  constexpr int XPR = BK / 8;   // 16-byte chunks of an x row
  constexpr int SPT = kArrayRows / BK;  // stages a tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t wmax[WARPS];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int RB = (M + kBlockRows - 1) / kBlockRows;
  const int rb = blockIdx.x % RB, part = blockIdx.x / RB % parts;
  const int strip = blockIdx.x / (RB * parts), strips = gridDim.x / (RB * parts);
  const int m0 = rb * kBlockRows, n0 = strip * TN;
  const int T = (K + kArrayRows - 1) / kArrayRows;
  const int t0 = part * T / parts, t1 = (part + 1) * T / parts;
  const int kb = t0 * kArrayRows, ke = min(K, t1 * kArrayRows);
  const int nst = (ke - kb + BK - 1) / BK;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);

  // stage j of this part (an empty group past the last one); rows past
  // the part's end, columns past N and rows of x past M are zeros
  auto load_stage = [&](int j) {
    if (j < nst) {
      unsigned char* st = smem + (j % kMmaStages) * L::STAGE;
      const int k0 = kb + j * BK;
#pragma unroll
      for (int it = 0; it < BK * CPR / THREADS; ++it) {
        const int q = tid + it * THREADS;
        const int r = q / CPR, c = q % CPR;
        const int k = k0 + r, n = n0 + 16 * c;
        const size_t off = (size_t)k * N + n;
        unsigned char* dp = st + code_off(r, c);
        if (VEC) {
          const bool in = k < ke && n < N;
          cp_async16(dp, in ? gp + off : gp, in);
          cp_async16(dp + L::C, in ? gn + off : gn, in);
        } else {
          uint32_t pw[4] = {0u, 0u, 0u, 0u}, qw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (k < ke && n + i < N) {
              pw[i / 4] |= (uint32_t)gp[off + i] << (8 * (i % 4));
              qw[i / 4] |= (uint32_t)gn[off + i] << (8 * (i % 4));
            }
          *reinterpret_cast<uint4*>(dp) = make_uint4(pw[0], pw[1], pw[2], pw[3]);
          *reinterpret_cast<uint4*>(dp + L::C) = make_uint4(qw[0], qw[1], qw[2], qw[3]);
        }
      }
      for (int q = tid; q < 8 * NT * XPR; q += THREADS) {
        const int rho = q / XPR, c = q % XPR;
        const int m = m0 + rho, k = k0 + 8 * c;
        unsigned char* dp = st + 2 * L::C + x_off(rho, c);
        const uint16_t* src = xb + (size_t)m * K + k;
        if (VEC) {
          const bool in = m < M && k < ke;
          cp_async16(dp, in ? src : xb, in);
        } else {
          __align__(16) uint16_t v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = (m < M && k + i < ke) ? src[i] : 0;
          *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(v);
        }
      }
    }
    cp_async_commit();
  };

  // max |x| of the current tile so far, as bf16 bits: the high and the
  // low halves of the staged words, each masked to its magnitude
  uint32_t mhi = 0u, mlo = 0u;
  auto fold_absmax = [&](int j) {
    const unsigned char* xs = smem + (j % kMmaStages) * L::STAGE + 2 * L::C;
    for (int q = tid; q < L::X / 16; q += THREADS) {
      const uint4 v = *reinterpret_cast<const uint4*>(xs + 16 * q);
      mhi = max(mhi, max(max(v.x & 0x7fff0000u, v.y & 0x7fff0000u),
                         max(v.z & 0x7fff0000u, v.w & 0x7fff0000u)));
      mlo = max(mlo, max(max(v.x & 0x7fffu, v.y & 0x7fffu), max(v.z & 0x7fffu, v.w & 0x7fffu)));
    }
  };

  float acc[NT][4], sum[NT][4];
#pragma unroll
  for (int jt = 0; jt < NT; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f, sum[jt][e] = -0.f;

  // the MMAs of stage j: this warp's 16 columns, every 16-row step
  auto mma_stage = [&](int j) {
    const unsigned char* st = smem + (j % kMmaStages) * L::STAGE;
    const unsigned char* xs = st + 2 * L::C;
    // this lane's two columns of code rows 4t + i: their swizzle is t
    const int cw = ((warp ^ t) << 4) + 2 * g;
#pragma unroll
    for (int h = 0; h < BK / 16; ++h) {
      const int r0 = 16 * h + 4 * t;
      uint32_t p[4], q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = *reinterpret_cast<const uint16_t*>(st + (r0 + i) * TN + cw);
        q[i] = *reinterpret_cast<const uint16_t*>(st + L::C + (r0 + i) * TN + cw);
      }
      const uint32_t a[4] = {code_diff2_bf16x2(p[0], q[0], p[1], q[1], 0),
                             code_diff2_bf16x2(p[0], q[0], p[1], q[1], 1),
                             code_diff2_bf16x2(p[2], q[2], p[3], q[3], 0),
                             code_diff2_bf16x2(p[2], q[2], p[3], q[3], 1)};
      // x row 8 jt + g, K 4t..4t+3 of this step: chunk 2h + t / 2, half t & 1
      const int xc = 2 * h + (t >> 1);
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const uint2 bv =
            *reinterpret_cast<const uint2*>(xs + x_off(8 * jt + g, xc) + 8 * (t & 1));
        mma_bf16(acc[jt], a, bv.x, bv.y);
      }
    }
  };

  // lane (g, t) holds columns n, n + 1 of rows 8 jt + 2t (e = 0, 2) and
  // 8 jt + 2t + 1 (e = 1, 3)
  const int n = n0 + kMmaWarpCols * warp + 2 * g;
  const bool pair = n + 1 < N && N % 2 == 0;  // both columns, 8-byte aligned
  // v's elements of row 8 jt + 2t + u into y (M x N, slot `slot`)
  auto store = [&](float* y, int slot, int jt, int u, float v0, float v1) {
    const int m = m0 + 8 * jt + 2 * t + u;
    if (m >= M || n >= N) return;
    float* dst = y + ((size_t)slot * M + m) * N + n;
    if (pair) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      dst[0] = v0;
      if (n + 1 < N) dst[1] = v1;
    }
  };

  const int a1 = T / parts;  // the first tile of part 1
  for (int j = 0; j < kMmaStages - 1; ++j) load_stage(j);
  for (int j = 0; j < nst; ++j) {
    cp_async_wait<kMmaStages - 2>();  // stage j landed
    // every warp is done with stage j - 1: its slot is free
    __syncthreads();
    load_stage(j + kMmaStages - 1);
    fold_absmax(j);
    mma_stage(j);
    if ((j + 1) % SPT != 0 && j != nst - 1) continue;
    // the tile ends: its step from the block's max |x|, then its current
    // digitized and added to the running sum (part 0) or written (others)
    const uint32_t mine = __reduce_max_sync(0xffffffffu, max(mhi >> 16, mlo));
    if (lane == 0) wmax[warp] = mine;
    __syncthreads();
    uint32_t bits = wmax[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) bits = max(bits, wmax[w]);
    const float step =
        __fdiv_rn(__fmul_rn(full_scale, fmaxf(__uint_as_float(bits << 16), 1e-8f)), denom);
    const int tile = t0 + j / SPT;
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float code = fminf(fmaxf(rintf(__fdiv_rn(acc[jt][e], step)), -adc_max), adc_max);
        d[e] = __fmul_rn(code, step);
        sum[jt][e] = __fadd_rn(sum[jt][e], d[e]);
        acc[jt][e] = 0.f;
      }
      if (part > 0) {
        store(ws, tile - a1 + 1, jt, 0, d[0], d[2]);
        store(ws, tile - a1 + 1, jt, 1, d[1], d[3]);
      }
    }
    mhi = mlo = 0u;
  }
  cp_async_wait<0>();

  const float sc0 = n < N ? scale[n] : 0.f, sc1 = n + 1 < N ? scale[n + 1] : 0.f;
  if (parts == 1) {
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      store(out, 0, jt, 0, __fmul_rn(sum[jt][0], sc0), __fmul_rn(sum[jt][2], sc1));
      store(out, 0, jt, 1, __fmul_rn(sum[jt][1], sc0), __fmul_rn(sum[jt][3], sc1));
    }
    return;
  }
  if (part == 0) {
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      store(ws, 0, jt, 0, sum[jt][0], sum[jt][2]);
      store(ws, 0, jt, 1, sum[jt][1], sum[jt][3]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = sem + rb * strips + strip;
    last = atomicAdd(ticket, 1) == parts - 1;
    if (last) atomicExch(ticket, 0);  // every part of the strip has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The strip's last block: each thread adds the slots of the elements it
  // holds in tile order, part 0's running sum first, TB slots in flight
  // (a row's two columns as one 8-byte load where both exist)
  constexpr int TB = NT >= 16 ? 1 : 16 / NT;
  const int slots = T - a1 + 1;
  auto load_slot = [&](int slot, int jt, int u) {
    const int m = m0 + 8 * jt + 2 * t + u;
    const float* src = ws + ((size_t)slot * M + m) * N + n;
    if (m >= M || n >= N) return make_float2(0.f, 0.f);
    if (pair) return __ldcg(reinterpret_cast<const float2*>(src));
    return make_float2(__ldcg(src), n + 1 < N ? __ldcg(src + 1) : 0.f);
  };
#pragma unroll
  for (int jt = 0; jt < NT; ++jt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float2 v = load_slot(0, jt, u);
      sum[jt][u] = v.x, sum[jt][u + 2] = v.y;
    }
  for (int s0 = 1; s0 < slots; s0 += TB) {
    float2 v[TB][NT][2];
#pragma unroll
    for (int i = 0; i < TB; ++i)
#pragma unroll
      for (int jt = 0; jt < NT; ++jt)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          v[i][jt][u] = s0 + i < slots ? load_slot(s0 + i, jt, u) : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < TB; ++i)
      if (s0 + i < slots)
#pragma unroll
        for (int jt = 0; jt < NT; ++jt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            sum[jt][u] = __fadd_rn(sum[jt][u], v[i][jt][u].x);
            sum[jt][u + 2] = __fadd_rn(sum[jt][u + 2], v[i][jt][u].y);
          }
  }
#pragma unroll
  for (int jt = 0; jt < NT; ++jt) {
    store(out, 0, jt, 0, __fmul_rn(sum[jt][0], sc0), __fmul_rn(sum[jt][2], sc1));
    store(out, 0, jt, 1, __fmul_rn(sum[jt][1], sc0), __fmul_rn(sum[jt][3], sc1));
  }
}

// ---------------------------------------------------------------------------
// the narrow body (f32 x, N <= 64: the MoE routers under codes_adc)
// ---------------------------------------------------------------------------

// f32 x at N <= kNarrowMaxN (autotune.NARROW_MAX_N): the routers of the zoo
// (mixtral-8x22b K 6144 N 8, deepseek-v2-lite K 2048 N 64), whose input is
// f32, under codes_adc. It computes what repro/kernels/crossbar_mvm.py::
// _kernel computes, in one launch.
//
// What bounds it. Nothing that scales: the work is 0.1-2 MB and at most a
// few MFLOP, a bound below 1 us. The three SIMT launches it replaces here
// ran 24 blocks at N = 8, each a 128-column strip of which 8 columns were
// real, walking its tile's 256 rows in 32 dependent steps, behind a step
// prologue that read x once more and before a third launch that read the
// partials back. What is left is latency: the launch, one memory round
// trip, the ticket and the last block.
//
// Design:
// * The grid is (parts of K) x (128-row blocks of x). A block holds every
//   row of its row block (min(M - 128 rb, 128)) and all N columns, so the
//   step of each (row block, tile) is the block's own: the max |x| is folded
//   from the staged x (fmaxf of fabsf, exact in any order; zero-fill changes
//   nothing), and no prologue reads x. Parts are whole 256-row tiles
//   (autotune.adc_narrow_plan: every tile a part while the launch fits one
//   wave).
// * A ring of kNarrowStages stages of kNarrowK rows (a whole tile in flight
//   and one stage more; each stage costs a wait and a barrier, so 64-row
//   stages, 4 a tile: 2.0-2.2 us faster a call than 8 of 32 rows at every
//   router row, tools/adc_costs.py --narrow) is filled by cp.async: x 16 bytes a copy where K % 4
//   == 0 and x is 16-byte aligned, else 4 bytes (zero-filled past M and the
//   part's end either way); both code slices as one run of kr x N bytes 16 at
//   a time where N % 4 == 0 and the codes are 16-byte aligned (the run's
//   last copy zero-filled by its source size), else masked byte loads.
// * Work units are 4 rows x 4 columns (16 accumulators; the codes become
//   exact f32 weights by code_diff as they are read from shared memory).
//   The units of the row block (row groups x column groups) share the
//   block's threads, two a thread where there are more units than threads;
//   where there are fewer, a power of two of neighbouring lanes (at most 32)
//   split each stage's rows (row k to lane k % lanes), and at the tile's end
//   a butterfly of warp shuffles adds them (the same bits in every lane).
//   The current is then finished in f32; the block's max |x| gives the step
//   (__fdiv_rn(__fmul_rn(256 code_max, fmaxf(max, 1e-8)), adc_max 16)), the
//   current is digitized (rint of an IEEE division, clipped, times the step)
//   and written to the scratch at (tile, row, column).
// * The row block's last block to finish (a ticket in sem[rb], which it
//   resets) copies the partials into the idle ring, as many tiles at a time
//   as it holds (one round trip at the routers' shapes), and adds them in
//   ascending tile order, acc = cur[0]; acc = acc + cur[t], then multiplies
//   by the column scale. Every add and multiply after the dot is explicitly
//   rounded, and no data goes through atomics: the order of every f32
//   operation depends on the shape alone, so the result is bitwise the same
//   across launches, plans of K and graph replays. It differs from the plain
//   version only where the order of the dot inside a tile moves a current
//   across a rounding boundary (ref.adc_disagreement).
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md; tools/router_f32x.py,
// tools/adc_costs.py --narrow): mixtral's router 7.6-8.5 us a call at 1-8
// rows, 10.1-10.3 at 32, 14.8-15.0 at 96 (the three SIMT launches 35-74 us).
// At 1-4 rows a chain of latencies: the launch ~1 us, the copies ~2.5 (one
// round trip, then a wait and a barrier a stage), max |x| and products
// ~0.7, the tile end ~0.8-1.3, fence and ticket ~0.9, the last block ~1.5.
// One part a tile beats two tiles a part by 3-8 us. 128 registers, no spill.
constexpr int kNarrowThreads = 256;
constexpr int kNarrowMaxN = 64;   // autotune.NARROW_MAX_N
constexpr int kNarrowK = 64;      // rows of K a stage (autotune.ADC_NARROW_STAGE_ROWS)
constexpr int kNarrowStages = 5;  // stages of the ring (autotune.ADC_NARROW_STAGES)
constexpr int kNarrowXS = kNarrowK + 4;  // x row stride, floats
constexpr int kNarrowLanes = 32;  // threads over one unit's rows, at most
constexpr int kNarrowUnits = 2;   // units a thread holds at most
static_assert((kBlockRows / 4) * (kNarrowMaxN / 4) <= kNarrowUnits * kNarrowThreads,
              "units of a row block at N = kNarrowMaxN");
static_assert(kArrayRows % kNarrowK == 0 && kNarrowK % kNarrowLanes == 0, "stages of a tile");
// the operands the copies may take 16 bytes at a time (the `vec` mask)
constexpr int kVecCodes = 1, kVecX = 2;

// 16 bytes global -> shared, asynchronously, of which the first `bytes`
// (0..16) are read and the rest zero-filled
__device__ __forceinline__ void cp_async16n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// bytes of one stage of the ring (autotune.adc_narrow_smem): the x tile of
// rp rows and both code slices (rp: rows rounded up to 4, np: N rounded up
// to 4)
__host__ __device__ __forceinline__ int narrow_stage_bytes(int rp, int np) {
  return rp * kNarrowXS * 4 + 2 * kNarrowK * np;
}

__global__ void __launch_bounds__(kNarrowThreads)
    adc_narrow_kernel(const float* __restrict__ x, const uint8_t* __restrict__ gp,
                      const uint8_t* __restrict__ gn, const float* __restrict__ scale,
                      float* __restrict__ out, float* __restrict__ ws, int* __restrict__ sem,
                      int M, int K, int N, int vec, float full_scale, float denom,
                      float adc_max) {
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ uint32_t wmax[kNarrowThreads / 32];
  __shared__ int last;
  constexpr int SPT = kArrayRows / kNarrowK;  // stages a tile
  const int tid = threadIdx.x;
  const int rb = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const int m0 = rb * kBlockRows, rows = min(kBlockRows, M - m0);
  const int NP = (N + 3) & ~3, CG = NP / 4, RG = (rows + 3) / 4, U = RG * CG;
  const int XB = 4 * RG * kNarrowXS * 4, CB = kNarrowK * NP;
  const int SB = XB + 2 * CB;
  const int T = (K + kArrayRows - 1) / kArrayRows;
  const int t0 = part * T / parts, t1 = (part + 1) * T / parts;
  const int kb = t0 * kArrayRows, ke = min(K, t1 * kArrayRows);
  const int nst = (ke - kb + kNarrowK - 1) / kNarrowK;  // stages of this part
  // lanes: a power of two, the most that fit the threads; a unit's lanes are
  // neighbouring threads of one warp. wide: more units than threads, a
  // thread then takes up to kNarrowUnits, one lane
  const bool wide = U > kNarrowThreads;
  int lanes = 1;
  while (!wide && 2 * lanes <= kNarrowLanes && 2 * lanes * U <= kNarrowThreads) lanes *= 2;
  const int lane = tid % lanes, unit0 = wide ? tid : tid / lanes;

  // stage j of the part into slot j % kNarrowStages (an empty group past nst)
  auto load_stage = [&](int j) {
    if (j < nst) {
      unsigned char* st = smem + (j % kNarrowStages) * SB;
      float* xs = reinterpret_cast<float*>(st);
      uint8_t* ps = st + XB;
      uint8_t* ns = ps + CB;
      const int k0 = kb + j * kNarrowK, kr = min(kNarrowK, ke - k0);
      // x: the row block's rows [0, 4 RG), zeros past M and past the part
      if (vec & kVecX) {
        for (int p = tid; p < 4 * RG * (kNarrowK / 4); p += kNarrowThreads) {
          const int i = p / (kNarrowK / 4), c = p % (kNarrowK / 4) * 4;
          const bool in = i < rows && c < kr;
          cp_async16(xs + i * kNarrowXS + c, in ? x + (size_t)(m0 + i) * K + k0 + c : x, in);
        }
      } else {
        for (int p = tid; p < 4 * RG * kNarrowK; p += kNarrowThreads) {
          const int i = p / kNarrowK, c = p % kNarrowK;
          const bool in = i < rows && c < kr;
          cp_async4(xs + i * kNarrowXS + c, in ? x + (size_t)(m0 + i) * K + k0 + c : x, in);
        }
      }
      // both code slices: kr rows of N bytes (NP == N where copied as one run)
      if (vec & kVecCodes) {
        const int bytes = kr * N;
        const size_t off = (size_t)k0 * N;
        for (int o = tid * 16; o < CB; o += kNarrowThreads * 16) {
          const int n = max(0, min(16, bytes - o));
          cp_async16n(ps + o, n ? gp + off + o : gp, n);
          cp_async16n(ns + o, n ? gn + off + o : gn, n);
        }
      } else {
        for (int p = tid; p < kNarrowK * NP; p += kNarrowThreads) {
          const int r = p / NP, c = p % NP;
          const bool in = r < kr && c < N;
          const size_t e = (size_t)(k0 + r) * N + c;
          ps[p] = in ? gp[e] : (uint8_t)0;
          ns[p] = in ? gn[e] : (uint8_t)0;
        }
      }
    }
    cp_async_commit();
  };

  float acc[kNarrowUnits][4][4];
#pragma unroll
  for (int t = 0; t < kNarrowUnits; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][i][c] = 0.f;
  float amax = 0.f;  // max |x| of the tile so far, over this thread's share

  for (int j = 0; j < kNarrowStages - 1; ++j) load_stage(j);
  for (int j = 0; j < nst; ++j) {
    cp_async_wait<kNarrowStages - 2>();  // stage j landed
    __syncthreads();                     // and every thread is done with stage j - 1
    load_stage(j + kNarrowStages - 1);
    const unsigned char* st = smem + (j % kNarrowStages) * SB;
    const float* xs = reinterpret_cast<const float*>(st);
    const uint8_t* ps = st + XB;
    const uint8_t* ns = ps + CB;
    // max |x| of the stage: every staged float of the row block once
    for (int p = tid; p < RG * kNarrowK; p += kNarrowThreads) {
      const int i = p / (kNarrowK / 4), c = p % (kNarrowK / 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(xs + i * kNarrowXS + c);
      amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
    }
    // lane l takes the stage's rows kk = l, l + lanes, ...
#pragma unroll
    for (int t = 0; t < kNarrowUnits; ++t) {
      const int u = unit0 + t * kNarrowThreads;
      if ((t > 0 && !wide) || u >= U) break;
      const int rg = u / CG, cg = u - rg * CG;
      for (int kk = lane; kk < kNarrowK; kk += lanes) {
        const uint32_t p = *reinterpret_cast<const uint32_t*>(ps + kk * NP + 4 * cg);
        const uint32_t q = *reinterpret_cast<const uint32_t*>(ns + kk * NP + 4 * cg);
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = byte_f32(p, c) - byte_f32(q, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[(4 * rg + i) * kNarrowXS + kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t][i][c] = fmaf(xv, w[c], acc[t][i][c]);
        }
      }
    }
    if ((j + 1) % SPT != 0 && j != nst - 1) continue;
    // the tile ends: its step from the row block's max |x| (non-negative
    // floats order as their bits), its lanes' sums by a butterfly
    const uint32_t mine = __reduce_max_sync(0xffffffffu, __float_as_uint(amax));
    if ((tid & 31) == 0) wmax[tid >> 5] = mine;
    if (lanes > 1) {
      for (int off = lanes / 2; off > 0; off /= 2)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[0][i][c] = __fadd_rn(acc[0][i][c], __shfl_xor_sync(0xffffffffu, acc[0][i][c], off));
    }
    __syncthreads();
    uint32_t bits = wmax[0];
#pragma unroll
    for (int w = 1; w < kNarrowThreads / 32; ++w) bits = max(bits, wmax[w]);
    const float step =
        __fdiv_rn(__fmul_rn(full_scale, fmaxf(__uint_as_float(bits), 1e-8f)), denom);
    // the digitized currents of tile t0 + j / SPT: ws[tile][m0 + row][col]
    float* part_ws = ws + ((size_t)(t0 + j / SPT) * M + m0) * N;
#pragma unroll
    for (int t = 0; t < kNarrowUnits; ++t) {
      const int u = unit0 + t * kNarrowThreads;
      if ((t > 0 && !wide) || u >= U || lane != 0) break;
      const int rg = u / CG, n = 4 * (u - rg * CG);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * rg + i;
        if (row >= rows) break;
        float d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float code =
              fminf(fmaxf(rintf(__fdiv_rn(acc[t][i][c], step)), -adc_max), adc_max);
          d[c] = __fmul_rn(code, step);
        }
        float* dst = part_ws + (size_t)row * N + n;
        if (NP == N) {
          *reinterpret_cast<float4*>(dst) = make_float4(d[0], d[1], d[2], d[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < N) dst[c] = d[c];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kNarrowUnits; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[t][i][c] = 0.f;
    amax = 0.f;
  }
  cp_async_wait<0>();  // only empty groups are left

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(sem + rb, 1) == parts - 1;
    if (last) atomicExch(sem + rb, 0);  // every part of the row block has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The row block's last block (the ring is idle: the partials take its
  // place). Each tile's partials of the row block are one run of E floats;
  // `room` tiles at a time are copied in (16 bytes a copy where N % 4 == 0),
  // then each output adds them in tile order onto its running sum (tot)
  const int E = rows * N, EP = (E + 3) & ~3;
  const int ring = kNarrowStages * narrow_stage_bytes((min(M, kBlockRows) + 3) & ~3, NP) / 4;
  const int room = (ring - EP) / EP;  // tiles the ring holds at once, beside tot
  float* tot = smem_f;
  float* buf = smem_f + EP;
  const float* src = ws + (size_t)m0 * N;
  const size_t tstride = (size_t)M * N;  // floats of one tile's partials
  for (int c0 = 0; c0 < T; c0 += room) {
    const int nc = min(room, T - c0);
    if (NP == N) {
      for (int q = tid; q < nc * (E / 4); q += kNarrowThreads) {
        const int t = q / (E / 4), e = (q - t * (E / 4)) * 4;
        cp_async16(buf + t * EP + e, src + (c0 + t) * tstride + e, true);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      for (int q = tid; q < nc * E; q += kNarrowThreads) {
        const int t = q / E, e = q - t * E;
        buf[t * EP + e] = __ldcg(src + (c0 + t) * tstride + e);
      }
    }
    __syncthreads();
    for (int e = tid; e < E; e += kNarrowThreads) {
      float y = c0 == 0 ? buf[e] : tot[e];
      for (int t = c0 == 0 ? 1 : 0; t < nc; ++t) y = __fadd_rn(y, buf[t * EP + e]);
      if (c0 + nc < T)
        tot[e] = y;
      else
        out[(size_t)m0 * N + e] = __fmul_rn(y, scale[e % N]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host-side launch helpers
// ---------------------------------------------------------------------------

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int row_tiles(int M) {  // the n-tiles of 8 rows that hold one row block
  const int rows = M < kBlockRows ? M : kBlockRows;
  for (int nt : kMmaRowTiles)
    if (8 * nt >= rows) return nt;
  return kMmaRowTiles[sizeof(kMmaRowTiles) / sizeof(int) - 1];
}

int strips_of(int N) { return (N + kMmaN - 1) / kMmaN; }

struct MmaArgs {
  const void *x, *gp, *gn, *scale;
  void *out, *ws, *sem;
  int M, K, N, parts;
  float full_scale, denom, adc_max;
};

template <int NT, bool VEC>
cudaError_t launch_mma(const MmaArgs& a, cudaStream_t s) {
  constexpr int smem = AdcSmem<NT>::RING;
  auto kernel = adc_mma_kernel<NT, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int RB = (a.M + kBlockRows - 1) / kBlockRows;
  kernel<<<RB * a.parts * strips_of(a.N), 32 * kMmaWarps, smem, s>>>(
      (const __nv_bfloat16*)a.x, (const uint8_t*)a.gp, (const uint8_t*)a.gn,
      (const float*)a.scale, (float*)a.out, (float*)a.ws, (int*)a.sem, a.M, a.K, a.N, a.parts,
      a.full_scale, a.denom, a.adc_max);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mma_vec(const MmaArgs& a, cudaStream_t s) {
  const bool vec = a.K % 8 == 0 && a.N % 16 == 0 && aligned(a.x, 16) && aligned(a.gp, 16) &&
                   aligned(a.gn, 16);
  return vec ? launch_mma<NT, true>(a, s) : launch_mma<NT, false>(a, s);
}

cudaError_t launch_mma_rows(const MmaArgs& a, cudaStream_t s) {
  switch (row_tiles(a.M)) {
    case 1: return launch_mma_vec<1>(a, s);
    case 2: return launch_mma_vec<2>(a, s);
    case 4: return launch_mma_vec<4>(a, s);
    case 8: return launch_mma_vec<8>(a, s);
    case 12: return launch_mma_vec<12>(a, s);
    default: return launch_mma_vec<16>(a, s);
  }
}

// the narrow body: one launch, a block per (part of K, 128-row block)
cudaError_t launch_narrow(const void* x, const void* gp, const void* gn, const void* scale,
                          void* out, void* ws, void* sem, int M, int K, int N, int parts,
                          float full_scale, float denom, float adc_max, cudaStream_t s) {
  const int rp = ((M < kBlockRows ? M : kBlockRows) + 3) & ~3, np = (N + 3) & ~3;
  const int smem = kNarrowStages * narrow_stage_bytes(rp, np);
  cudaError_t e =
      cudaFuncSetAttribute(adc_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int vec = (N % 4 == 0 && aligned(gp, 16) && aligned(gn, 16) ? kVecCodes : 0) |
                  (K % 4 == 0 && aligned(x, 16) ? kVecX : 0);
  const dim3 grid(parts, (M + kBlockRows - 1) / kBlockRows);
  adc_narrow_kernel<<<grid, kNarrowThreads, smem, s>>>(
      (const float*)x, (const uint8_t*)gp, (const uint8_t*)gn, (const float*)scale, (float*)out,
      (float*)ws, (int*)sem, M, K, N, vec, full_scale, denom, adc_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the SIMT body's scratch sizes in floats: one step per (128-row block,
// 256-row K tile), one digitized partial per (K tile, m, n)
int rimc_adc_step_scratch(int M, int K) {
  return ((M + kBlockRows - 1) / kBlockRows) * ((K + kArrayRows - 1) / kArrayRows);
}
long long rimc_adc_part_scratch(int M, int K, int N) {
  return (long long)((K + kArrayRows - 1) / kArrayRows) * M * N;
}

// The SIMT body, f32 x: x (M, K) f32; gp, gn: (K, N) u8; scale: (N,) f32;
// out: (M, N) f32; step, part: f32 scratch of the sizes above;
// full_scale = 256 * code_max, denom = adc_max * 16. All contiguous, on
// the current device. The tile kernel takes 16, 32, 64 or 128 output rows
// a block, the fewest that cover min(M, 128).
int rimc_crossbar_mvm(const void* x, const void* gp, const void* gn, const void* scale,
                      void* out, void* step, void* part, int M, int K, int N,
                      float full_scale, float denom, float adc_max, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int rows = M < kBlockRows ? M : kBlockRows;
  const int tile_rows = rows <= 16 ? 16 : rows <= 32 ? 32 : rows <= 64 ? 64 : 128;
  return (int)launch((const float*)x, gp, gn, scale, out, step, part, M, K, N, tile_rows, full_scale,
                            denom, adc_max, (cudaStream_t)stream);
}

// tickets of the tensor-core body: one per (128-row block, strip)
int rimc_adc_mma_sems(int M, int N) { return ((M + kBlockRows - 1) / kBlockRows) * strips_of(N); }

// floats of the tensor-core body's scratch for `parts` parts of K: none
// for one part, else part 0's running sum and one digitized partial per
// tile of parts 1.., each M x N
long long rimc_adc_mma_scratch(int M, int K, int N, int parts) {
  const int T = (K + kArrayRows - 1) / kArrayRows;
  return parts > 1 ? (long long)(T - T / parts + 1) * M * N : 0;
}

// *id: the id of the CUDA graph capture running on stream, 0 when none
// is, so that each captured graph can hold tickets of its own
int rimc_adc_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  *id = 0;
  const cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  if (e == cudaSuccess && status != cudaStreamCaptureStatusActive) *id = 0;
  return (int)e;
}

// The tensor-core body, bf16 x, one launch: x (M, K) bf16; gp, gn, scale,
// out as above; parts of K (1..K tiles, autotune.adc_plan). parts > 1: ws
// rimc_adc_mma_scratch(M, K, N, parts) f32 and sem rimc_adc_mma_sems(M, N)
// ints, all zero, which the launch leaves all zero (launches sharing sem
// must not overlap); both may be null when parts == 1.
int rimc_crossbar_mvm_mma(const void* x, const void* gp, const void* gn, const void* scale,
                          void* out, void* ws, void* sem, int M, int K, int N, int parts,
                          float full_scale, float denom, float adc_max, void* stream) {
  const int T = (K + kArrayRows - 1) / kArrayRows;
  if (M < 1 || K < 1 || N < 1 || parts < 1 || parts > T ||
      (parts > 1 && (ws == nullptr || sem == nullptr)))
    return (int)cudaErrorInvalidValue;
  const MmaArgs a{x, gp, gn, scale, out, ws, sem, M, K, N, parts, full_scale, denom, adc_max};
  return (int)launch_mma_rows(a, (cudaStream_t)stream);
}

// tickets of the narrow body: one per 128-row block
int rimc_adc_narrow_sems(int M) { return (M + kBlockRows - 1) / kBlockRows; }

// The narrow body, f32 x at N <= kNarrowMaxN, one launch: x (M, K) f32; gp,
// gn, scale, out as above; ws: rimc_adc_part_scratch(M, K, N) f32 (every
// tile's digitized partials); sem: rimc_adc_narrow_sems(M) ints, all zero,
// which the launch leaves all zero (launches sharing sem must not overlap);
// parts of K, 1 <= parts <= K tiles (autotune.adc_narrow_plan).
int rimc_crossbar_mvm_narrow(const void* x, const void* gp, const void* gn, const void* scale,
                             void* out, void* ws, void* sem, int M, int K, int N, int parts,
                             float full_scale, float denom, float adc_max, void* stream) {
  const int T = (K + kArrayRows - 1) / kArrayRows;
  if (M < 1 || K < 1 || N < 1 || N > kNarrowMaxN || parts < 1 || parts > T || ws == nullptr ||
      sem == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_narrow(x, gp, gn, scale, out, ws, sem, M, K, N, parts, full_scale, denom,
                            adc_max, (cudaStream_t)stream);
}

}  // extern "C"
