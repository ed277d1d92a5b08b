// Fused RIMC-DoRA linear over resident uint8 conductance codes, for
// Hopper (sm_90a). Two bodies, two launchers:
//
//     f32:  Y = gamma * (scale * X @ (G+ - G-) + (X @ A) @ B)
//     int8: Y = gamma * (f32(Xq @ (G+ - G-)) * xs * scale + ((Xq @ A) * xs) @ B)
//
// Replaces the Pallas TPU kernels repro/kernels/dora_linear.py::_kernel
// (accum="f32") and ::_kernel_int8 (accum="int8", with the jnp helpers
// _quantize_rows and recode_s8) behind their two launchers:
// dora_linear_gemv (decode, M <= 64) and dora_linear (prefill, tiled
// over M and N).
//
// Which body runs where:
//
//     launcher  body  x          N     kernel                        arithmetic
//     GEMV      f32   bf16       any   dora_gemv_mma_kernel          mma.sync bf16, f32 acc
//     GEMV      f32   f32        > 64  dora_gemv_kernel<..., false>  SIMT f32
//     GEMV      int8  f32, bf16  any   dora_gemv_int8_kernel         mma.sync u8 x s8, s32 acc
//     tiled     f32   bf16       any   dora_mma_kernel<..., false>   mma.sync bf16, f32 acc
//     tiled     f32   f32        > 64  dora_tiled_kernel             SIMT f32
//     tiled     int8  f32, bf16  any   dora_mma_kernel<..., true>    mma.sync s8 x u8, s32 acc
//     either    f32   f32        <= 64 dora_narrow_kernel            SIMT f32, K split
//
// N <= 64 with f32 x is every MoE router of the zoo (autotune.NARROW_MAX_N);
// wider f32-x calls run on no serving path.
//
// The int8 body. Each row of X is quantized to s8 (xs = max(max|x|,
// 1e-30) / 127, xq = clip(rint(x / xs), +-127), IEEE division and
// round-half-even, so xq and xs match the reference bitwise) and Xq @ A is
// computed in f32. Both launchers accumulate on the tensor cores with
// mma.m16n8k32 on the u8 codes as they are, as xq . G+ plus (-xq) . G-
// into one s32 accumulator (-xq is exact in s8, |xq| <= 127): the tiled
// launcher with x as the s8 A operand, the GEMV with the codes as the u8
// A operand of the swapped product. Either equals the reference's
// (G+ - 128) - (G- - 128) recode without storing any s8 copy of the
// codes. The sum is exact in
// any order: every partial stays below 2 * K * 127 * 255 < 2^31 for every
// K the models have (K <= 19200), so it equals the reference's int32
// accumulator bitwise; the f32 epilogue keeps the reference's order of
// operations: f32(acc) * xs * scale, plus the low-rank term, times gamma.
//
// What bounds it on an H100. Every shape the serving path gives is bound
// by bytes: each weight is two code bytes (G+ and G-) read once per call,
// and the work is M flops per code byte, below the card's ridge point for
// these inputs up to M ~ 295 (bf16 x; G+ - G- in [-255, 255] is exact in
// bf16; 989 TFLOP/s on the tensor cores over 3.35 TB/s) and M ~ 590 (s8
// x and u8 codes; 1979 TOPS). Its floor is about 2*K*N bytes over the HBM
// rate. The SIMT bodies (f32 x with the f32 body) keep the reference's
// exact arithmetic on the SIMT units (67 TFLOP/s f32, a ridge of 20
// flop/byte): the decode GEMV (M <= 4) stays under that ridge, but from 16
// rows up the instruction rate caps a SIMT body above the byte floor (M =
// 32: 3.2 GFLOP a layer, 0.048 ms at 67 TFLOP/s). So every call of the
// serving paths (bf16 x; the int8 body with any x) runs on the tensor
// cores, GEMV and tiled alike, but the routers' f32-x calls: at N <= 64
// they are neither byte- nor operation-bound, and dora_narrow_kernel
// spreads them over the card.
//
// The tiled tensor-core bodies. The f32 body (bf16 x) multiplies a bf16
// x by a bf16 G+ - G-, exact in f32, so mma.sync bf16 with f32 accumulators
// differs from the SIMT body only in the order of the f32 sums and holds
// the same 1e-4 tolerance. The int8 body multiplies the s8 xq by the u8
// codes, exactly. Design, shared by both:
// * A 4-stage ring of cp.async copies (16 bytes a thread) stages the x
//   tile (BM x BK bf16 or s8) and both u8 code tiles (BK x BN) in
//   dynamic shared memory; copies run two stages ahead of the MMAs.
// * A pass over each staged code pair, once per block and shared by its
//   BM rows, puts the weight into the layout the MMA reads; no float or
//   s8 weight reaches device memory. f32 body: a bf16 G+ - G- tile (the
//   2^23 byte trick below, one exact f32 subtract, one cvt.rn.bf16x2).
//   int8 body: a byte transpose (4 x 4 blocks by __byte_perm) of each
//   code tile into words of 4 consecutive K of one column, the B
//   fragment of mma.m16n8k32 (sm_90 has no 8-bit ldmatrix.trans). Tile
//   t + 1 is converted while tile t's MMAs run, into the other of two
//   weight buffers: one barrier a stage.
// * 8 warps (2 x 4) load x fragments with ldmatrix and run mma.sync:
//   m16n8k16 bf16 with B by ldmatrix.trans (f32 body); m16n8k32 s8 x u8
//   with B as one 32-bit shared load per register, twice per step (G+
//   with xq, then G- with xq negated byte by byte in registers) (int8
//   body). Rows of every tile are padded against bank conflicts. No TF32
//   anywhere.
// * Tiles are BM x 64 (BM 128, or 64 where M <= 64); K is split into
//   ordered parts until the blocks fill one wave (autotune.tiled_tiles,
//   per body). With several parts each block writes its raw sums (f32 or
//   int32) and a second pass adds them in part order, then runs the
//   epilogue: no atomics, so two launches are bitwise equal.
// * X @ A: a prologue stages 16 rows of x and a 256-row slab of A in
//   shared memory and writes XA partials, which a small kernel sums in
//   chunk order into XA; the epilogue reads one value per (row, rank).
//   int8 body: a first pass takes each row's scale xs (one block a row,
//   each row read once), then the prologue quantizes x to xq as it stages
//   it, writes xq (M x K s8, the main kernel's x operand) and the
//   partials of Xq @ A.
// * Ragged K, N and M: the copies need K % 8 (bf16) or K % 16 (s8) == 0,
//   N % 16 == 0 and 16-byte aligned operands; otherwise the same kernel
//   stages its tiles with masked scalar loads. Both zero-fill past M, N
//   and K.
// Measured on the H100 (PERF.md), neither is byte-bound: copies, weight
// conversion and MMAs add up rather than overlap (one or two blocks an
// SM, a barrier every stage), and the prologue, the XA sum and the
// split-K pass take a fifth or more of a layer.
//
// What the design does about it:
// * The weight stays in code space into registers: no float weight ever
//   reaches device memory. A code byte becomes a float by OR-ing it into
//   the mantissa of 2^23 (one byte permute); G+ - G- is then one exact
//   f32 subtract, with no int-to-float conversion.
// * X @ A (M x R) is computed once per call, not by every block: the TPU
//   kernel accumulated it inside every grid step's K loop, and on the card
//   every block redoing it cost more than streaming the codes. The SIMT
//   bodies run a prologue kernel first (for the SIMT GEMV also X^T as f32,
//   K x rows, zero rows past M); the tensor-core GEMVs give it to the first
//   blocks of their own grid.
// * GEMV launcher, tensor-core body (bf16 x), dora_gemv_mma_kernel. The
//   code stream bounds it (2 bytes a weight, M <= 64 MMA rows of work), and
//   at the decode tick a leaf streams 8-50 MB in a few microseconds, so its
//   fixed costs weigh as much as its pipeline (PERF.md: the launch, the
//   ramp of the copies and the strips' last blocks after the last code
//   byte set the small leaves' time). So: one launch; a block per 128
//   output columns and part of K (autotune.gemv_plan: at least a block per
//   SM, within one wave), the parts added in part order by each strip's
//   last block (a ticket, no atomics on data), whose loads in flight are
//   capped so that it does not spill (it did, and cost 13% at M = 4); X @ A
//   in the grid's first blocks, one round trip per 256 rows of K; 16-byte
//   cp.async copies of codes and x into a 4-stage ring, no X^T in memory;
//   G+ - G- converted to bf16 in registers and fed to mma.sync m16n8k16 as
//   the A operand of Y^T = W^T X^T, with x padded to 8 rows as B (details
//   at the kernel).
// * GEMV launcher, int8 body, dora_gemv_int8_kernel: the same layout and
//   bound (2 code bytes a weight), one launch (the row scales taken by
//   every block, or, from autotune.GEMV_INT8_PRESCALE_ROWS rows, by a pass
//   before it), x quantized to s8 once per block and stage (details at
//   the kernel).
// * Both launchers, f32 x at N <= 64 (the routers), dora_narrow_kernel:
//   one launch, K split across blocks in slabs of 128 rows, X @ A as R more
//   columns of the same pass, the slabs' sums added in slab order by each
//   row tile's last block (a ticket): no prologue, no X^T (details at the
//   kernel).
// * GEMV launcher, SIMT body (f32 x with the f32 body, N > 64): a block owns a
//   strip of 32 (16 from 8 rows up) output columns and all of K (the TPU
//   grid's sequential K axis becomes a loop: no block waits for another).
//   Each thread loads CPT neighbouring
//   code bytes of a row as one vector (16 bytes at M <= 4), neighbouring
//   threads take the rest of the strip's row segment and then the next
//   rows, and each thread keeps 4 (8) rows of both code arrays in flight.
//   Each thread holds rows x CPT accumulators; the row groups are summed
//   with warp shuffles, then warp by warp in a fixed order
//   (deterministic), and the epilogue applies scale, XA @ B and gamma.
// * Tiled launcher, SIMT body (f32 x, N > 64): a shared-memory product,
//   128x128 output tile, 8-deep K tiles, each thread an 8x8 register
//   tile; codes become f32 weights as the tile is loaded. The low-rank
//   term reuses the same micro-kernel as 8-deep "K tiles" of XA against
//   B after the accumulators are scaled, then gamma is applied.
// * All bodies mask ragged M, K and N themselves (zero-filled loads,
//   guarded stores), so no operand is ever padded.
//
// Plain C interface (loaded with ctypes). Every function returns
// cudaGetLastError() after its launches; the Python wrapper raises on
// anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// byte i of w as the float 2^23 + byte (exact)
__device__ __forceinline__ float byte_f32(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | (uint32_t)i));
}

// the accumulator type of a body
template <bool INT8> struct Num { using T = float; };
template <> struct Num<true> { using T = int; };

// byte i of each code array -> the weight G+ - G- (exact in f32)
__device__ __forceinline__ float code_diff(uint32_t p, uint32_t q, int i) {
  return byte_f32(p, i) - byte_f32(q, i);
}

// the reference's _quantize_rows for one element, given its row's xs
__device__ __forceinline__ int quantize_s8(float v, float xs) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.f), 127.f);
}

// ---------------------------------------------------------------------------
// prologue: XA = X @ A (M x R) and, for the GEMV launcher, XT = X^T (K x rows)
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 256;
constexpr int kPrepRows = 256;  // rows of K per prologue block

// Block (m, g) of a prologue's grid handles row m of X over rows
// [g * kPrepRows, (g + 1) * kPrepRows) of K. This writes its partial
// X @ A to xa[g][m][:] (xval(k): the body's x value at column k); the
// main kernels sum the G partials.
template <typename F>
__device__ __forceinline__ void xa_partial(F xval, const float* __restrict__ a,
                                           float* __restrict__ xa, float* part, int m,
                                           int M, int kb, int ke, int R) {
  const int tid = threadIdx.x;
  // thread (slice s, rank j) sums rows kb + s, kb + s + S, ...; S = 256 / R
  const int S = kPrepThreads / R;
  const int s = tid / R, j = tid - s * R;
  float acc = 0.f;
  if (s < S) {
#pragma unroll 4
    for (int k = kb + s; k < ke; k += S) acc = fmaf(xval(k), a[(size_t)k * R + j], acc);
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < R) {
    float sum = 0.f;
    for (int q = 0; q < S; ++q) sum += part[q * R + tid];
    xa[((size_t)blockIdx.y * M + m) * R + tid] = sum;
  }
}

// f32 body with f32 x, grid (max(M, rows), G = ceil(K / kPrepRows)): XA
// partials and, for the GEMV launcher, XT = X^T (zero rows past M).
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const float* __restrict__ x, const float* __restrict__ a,
                float* __restrict__ xa, float* __restrict__ xt, int M, int K, int R,
                int rows) {
  __shared__ float part[kPrepThreads];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int kb = blockIdx.y * kPrepRows, ke = min(K, kb + kPrepRows);
  if (xt != nullptr && m < rows) {
    for (int k = kb + tid; k < ke; k += kPrepThreads)
      xt[(size_t)k * rows + m] = m < M ? x[(size_t)m * K + k] : 0.f;
  }
  if (m >= M) return;
  const float* xr = x + (size_t)m * K;
  xa_partial([&](int k) { return xr[k]; }, a, xa, part, m, M, kb, ke, R);
}

// the int8 row scale of row xr: max(max|x|, 1e-30) / 127, by the whole
// block (wmax: kPrepThreads / 32 floats of shared memory)
template <typename TX>
__device__ __forceinline__ float row_scale(const TX* __restrict__ xr, int K, float* wmax) {
  const int tid = threadIdx.x;
  float amax = 0.f;
  for (int k = tid; k < K; k += kPrepThreads) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) wmax[tid >> 5] = amax;
  __syncthreads();
  amax = wmax[0];
  for (int w = 1; w < kPrepThreads / 32; ++w) amax = fmaxf(amax, wmax[w]);
  return __fdiv_rn(fmaxf(amax, 1e-30f), 127.f);
}

// int8 body, grid M: the row scales xs, each row read once (the tiled
// launcher; the GEMV's pass before its kernel, from
// autotune.GEMV_INT8_PRESCALE_ROWS rows)
template <typename TX>
__global__ void __launch_bounds__(kPrepThreads)
    row_scale_kernel(const TX* __restrict__ x, float* __restrict__ xs, int K) {
  __shared__ float wmax[kPrepThreads / 32];
  const float s = row_scale(x + (size_t)blockIdx.x * K, K, wmax);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
}

// prologue of the tensor-core bodies, grid (ceil(M / kPrepRowTile), G):
// the XA partials over kPrepRows rows of K for kPrepRowTile rows of X per
// block, from shared-memory tiles of x and A (16 ranks at a time), so that
// each value of A read from memory serves every row of the tile. INT8:
// x is quantized with the row scales xs as it is staged, written to xq
// (M x K s8), and the partials are those of Xq @ A.
constexpr int kPrepRowTile = 16;

template <typename TX, bool INT8>
__global__ void __launch_bounds__(kPrepThreads)
    prep_tile_kernel(const TX* __restrict__ x, const float* __restrict__ xs,
                     const float* __restrict__ a, float* __restrict__ xa,
                     int8_t* __restrict__ xq, int M, int K, int R) {
  // rows padded by 4 floats: 16-byte aligned, 4 banks apart
  __shared__ __align__(16) float xt[kPrepRowTile][kPrepRows + 4];
  __shared__ __align__(16) float at[16][kPrepRows + 4];  // A tile, transposed
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kPrepRowTile;
  const int kb = blockIdx.y * kPrepRows, kn = min(kPrepRows, K - kb);
  // constant trip counts, unrolled: every load of a thread in flight at once
#pragma unroll
  for (int it = 0; it < kPrepRowTile * kPrepRows / kPrepThreads; ++it) {
    const int p = tid + it * kPrepThreads;
    const int i = p / kPrepRows, k = p % kPrepRows;
    const int m = m0 + i;
    float v = 0.f;
    if (m < M && k < kn) {
      const size_t e = (size_t)m * K + kb + k;
      v = to_f32(x[e]);
      if constexpr (INT8) {
        const int q = quantize_s8(v, xs[m]);
        xq[e] = (int8_t)q;
        v = (float)q;
      }
    }
    xt[i][k] = v;
  }
  const int i = tid / 16, j = tid % 16;
  for (int r0 = 0; r0 < R; r0 += 16) {
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kPrepRows * 16 / kPrepThreads; ++it) {
      const int p = tid + it * kPrepThreads;
      const int k = p / 16, r = r0 + p % 16;
      at[p % 16][k] = (k < kn && r < R) ? a[(size_t)(kb + k) * R + r] : 0.f;
    }
    __syncthreads();
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < kPrepRows; k += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(&xt[i][k]);
      const float4 av = *reinterpret_cast<const float4*>(&at[j][k]);
      acc = fmaf(xv.x, av.x, acc);
      acc = fmaf(xv.y, av.y, acc);
      acc = fmaf(xv.z, av.z, acc);
      acc = fmaf(xv.w, av.w, acc);
    }
    if (m0 + i < M && r0 + j < R) xa[((size_t)blockIdx.y * M + m0 + i) * R + r0 + j] = acc;
  }
}

// XA = the G partials summed in chunk order (M x R), one thread per value
__global__ void __launch_bounds__(kPrepThreads)
    xa_finish_kernel(const float* __restrict__ part, float* __restrict__ xa, int MR, int G) {
  const int p = blockIdx.x * kPrepThreads + threadIdx.x;
  if (p >= MR) return;
  float v = 0.f;
#pragma unroll 8
  for (int g = 0; g < G; ++g) v += part[(size_t)g * MR + p];
  xa[p] = v;
}

// sum of the G prologue partials of XA[m][j], in chunk order
__device__ __forceinline__ float xa_sum(const float* __restrict__ xa, int G, int M,
                                        int R, int m, int j) {
  float v = 0.f;
  for (int g = 0; g < G; ++g) v += xa[((size_t)g * M + m) * R + j];
  return v;
}

// ---------------------------------------------------------------------------
// GEMV launcher
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;

template <int CPT> struct CodeVec;
template <> struct CodeVec<16> { using T = uint4; };
template <> struct CodeVec<8> { using T = uint2; };
template <> struct CodeVec<4> { using T = uint32_t; };
template <> struct CodeVec<2> { using T = uint16_t; };
template <> struct CodeVec<1> { using T = uint8_t; };

template <int CPT>
struct Codes {
  uint32_t w[(CPT + 3) / 4];
};

// CPT neighbouring code bytes starting at p; VEC: one aligned vector load
// (all CPT columns valid); else byte loads masked by the columns left.
template <int CPT, bool VEC>
__device__ __forceinline__ Codes<CPT> load_codes(const uint8_t* p, int valid) {
  Codes<CPT> c;
#pragma unroll
  for (int i = 0; i < (CPT + 3) / 4; ++i) c.w[i] = 0u;
  if (VEC) {
    if (valid > 0) {
      typename CodeVec<CPT>::T v = __ldg(reinterpret_cast<const typename CodeVec<CPT>::T*>(p));
      if constexpr (CPT >= 4) {
        const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int i = 0; i < CPT / 4; ++i) c.w[i] = u[i];
      } else {
        c.w[0] = (uint32_t)v;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (i < valid) c.w[i / 4] |= (uint32_t)__ldg(p + i) << (8 * (i % 4));
  }
  return c;
}

template <int MT>
__device__ __forceinline__ void load_x(const float* __restrict__ xt, int k, float (&xv)[MT]) {
  const float* p = xt + (size_t)k * MT;
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MT / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      xv[4 * i] = v.x; xv[4 * i + 1] = v.y; xv[4 * i + 2] = v.z; xv[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i) xv[i] = __ldg(p + i);
  }
}

// The SIMT GEMV, for f32 x with the f32 body (X^T in xt). MT: rows (a
// power of two >= M); CPT: columns per thread, MT * CPT <= 64; COLS: output
// columns per block; U: code rows each thread keeps in flight
template <int MT, int CPT, int COLS, int U, bool VEC>
__global__ void __launch_bounds__(kGemvThreads)
    dora_gemv_kernel(const float* __restrict__ xt, const uint8_t* __restrict__ gp,
                     const uint8_t* __restrict__ gn, const float* __restrict__ scale,
                     const float* __restrict__ b, const float* __restrict__ gamma,
                     const float* __restrict__ xa_g, float* __restrict__ out, int M,
                     int K, int N, int R, int G) {
  static_assert(COLS % CPT == 0 && 32 % (COLS / CPT) == 0, "column split");
  constexpr int TPR = COLS / CPT;             // threads per code row
  constexpr int RPS = kGemvThreads / TPR;     // row groups per block
  extern __shared__ float smem[];
  float* red = smem;              // [MT][COLS]
  float* xa = smem + MT * COLS;   // [M][R]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % TPR, rg = tid / TPR;
  const int col0 = blockIdx.x * COLS + ct * CPT;
  const int valid = min(CPT, N - col0);  // columns of this thread inside N

  for (int p = tid; p < M * R; p += kGemvThreads) xa[p] = xa_sum(xa_g, G, M, R, p / R, p % R);

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0;

  for (int k0 = rg; k0 < K; k0 += RPS * U) {
    Codes<CPT> cp[U], cn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * RPS;
      const int v = k < K ? valid : 0;
      const size_t off = (size_t)min(k, K - 1) * N + col0;
      cp[u] = load_codes<CPT, VEC>(gp + off, v);
      cn[u] = load_codes<CPT, VEC>(gn + off, v);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * RPS;
      if (k >= K) break;
      float xv[MT];
      load_x<MT>(xt, k, xv);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float w = code_diff(cp[u].w[c / 4], cn[u].w[c / 4], c % 4);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], w, acc[m][c]);
      }
    }
  }

  // sum the row groups of a warp (lanes differing above the column bits)
#pragma unroll
  for (int off = TPR; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  // then the warps, in warp order
  for (int w = 0; w < kGemvWarps; ++w) {
    if (warp == w && lane < TPR) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float* r = red + m * COLS + ct * CPT + c;
          *r = (w == 0) ? acc[m][c] : *r + acc[m][c];
        }
    }
    __syncthreads();
  }

  // epilogue: Y = gamma * (acc * scale + XA @ B[:, n])
  for (int p = tid; p < M * COLS; p += kGemvThreads) {
    const int m = p / COLS, c = p - m * COLS;
    const int n = blockIdx.x * COLS + c;
    if (n >= N) continue;
    float low = 0.f;
    for (int j = 0; j < R; ++j) low = fmaf(xa[m * R + j], b[(size_t)j * N + n], low);
    out[(size_t)m * N + n] = (red[m * COLS + c] * scale[n] + low) * gamma[n];
  }
}

// ---------------------------------------------------------------------------
// tiled launcher
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kTileK = 8;
constexpr int kTileThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ int tile_row(int t, int i) {  // i in [0, 8)
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// one 8-deep step of the 8x8 register tile: acc += as^T-tile x bs-tile
__device__ __forceinline__ void micro_tile(const float (*as)[kTileM], const float (*bs)[kTileN],
                                           int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kTileK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The SIMT body, for f32 x with the f32 body (bf16 x and the int8 body run
// dora_mma_kernel)
template <bool VEC>
__global__ void __launch_bounds__(kTileThreads)
    dora_tiled_kernel(const float* __restrict__ x, const uint8_t* __restrict__ gp,
                      const uint8_t* __restrict__ gn, const float* __restrict__ scale,
                      const float* __restrict__ b, const float* __restrict__ gamma,
                      const float* __restrict__ xa, float* __restrict__ out, int M, int K,
                      int N, int R, int G) {
  __shared__ __align__(16) float as[kTileK][kTileM];  // x tile, transposed
  __shared__ __align__(16) float bs[kTileK][kTileN];  // weight tile
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  // loader roles: x rows (tid / 2) x 4 consecutive k; code row (tid / 32) x 4 columns
  const int lm = tid / 2, lk = (tid % 2) * 4;
  const int ck = tid / 32, cn = (tid % 32) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + lm, k = k0 + lk + i;
      as[lk + i][lm] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    {
      const int k = k0 + ck;
      const int valid = k < K ? min(4, N - (n0 + cn)) : 0;
      const size_t off = (size_t)min(k, K - 1) * N + n0 + cn;
      const uint32_t p = load_codes<4, VEC>(gp + off, valid).w[0];
      const uint32_t q = load_codes<4, VEC>(gn + off, valid).w[0];
      *reinterpret_cast<float4*>(&bs[ck][cn]) =
          make_float4(code_diff(p, q, 0), code_diff(p, q, 1), code_diff(p, q, 2),
                      code_diff(p, q, 3));
    }
    __syncthreads();
    micro_tile(as, bs, ty, tx, acc);
  }

  // y = acc * scale + XA @ B: scale first, then the low-rank term through
  // the same micro-kernel, 8 ranks at a time
  float y[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tile_row(tx, j);
    const float s = n < N ? scale[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i][j] = acc[i][j] * s;
  }
  for (int r0 = 0; r0 < R; r0 += kTileK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + lm, r = r0 + lk + i;
      as[lk + i][lm] = (m < M && r < R) ? xa_sum(xa, G, M, R, m, r) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ck, n = n0 + cn + i;
      bs[ck][cn + i] = (r < R && n < N) ? b[(size_t)r * N + n] : 0.f;
    }
    __syncthreads();
    micro_tile(as, bs, ty, tx, y);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_row(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_row(tx, j);
      if (n < N) out[(size_t)m * N + n] = y[i][j] * gamma[n];
    }
  }
}

// ---------------------------------------------------------------------------
// tiled launcher, tensor-core bodies: f32 (bf16 x, f32 accumulators) and
// int8 (s8 xq x u8 codes, s32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;  // 8 warps, 2 (rows) x 4 (columns)
constexpr int kMmaStages = 4;    // stages of the copy ring
constexpr int kMmaRanks = 32;     // ranks of XA @ B per epilogue pass
// rows of K per stage, per body (autotune.MMA_BODIES), and output
// columns per block, both bodies (autotune.MMA_TILE_N)
constexpr int kMmaK = 32;
constexpr int kMmaKInt8 = 64;
constexpr int kMmaN = 64;

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// c += a (16x32 s8, row) x b (32x8 u8, col), s32 accumulators
__device__ __forceinline__ void mma_s8u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -v of each of the four s8 of v, all in [-127, 127]: a subtraction from
// 0x80 per byte, which never borrows across bytes, then the sign bit
__device__ __forceinline__ uint32_t neg_s8x4(uint32_t v) {
  return (0x80808080u - (v & 0x7f7f7f7fu)) ^ (~v & 0x80808080u);
}

// 4 x 4 byte transpose: byte j of r[i] becomes byte i of word j
__device__ __forceinline__ uint4 transpose_4x4(const uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  return make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                    __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
}

// G+ - G- of bytes i and i + 1 of (p, q) as two bf16 (exact: |d| <= 255)
__device__ __forceinline__ uint32_t code_diff_bf16x2(uint32_t p, uint32_t q, int i) {
  const __nv_bfloat162 d = __floats2bfloat162_rn(byte_f32(p, i) - byte_f32(q, i),
                                                 byte_f32(p, i + 1) - byte_f32(q, i + 1));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// a warp's accumulators (f32 or s32) into y (M x N), row m + 16 i (+8),
// columns n + 8 j (+1): each column pair as one 8-byte store where N is
// even, so a quad of lanes writes a whole 32-byte sector
template <int MT, int NT, typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y, const T (&acc)[MT][NT][4], int M,
                                           int N, int m, int n) {
  using T2 = typename std::conditional<std::is_same<T, float>::value, float2, int2>::type;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m + i * 16 + h * 8;
      if (row >= M) continue;
      T* yr = y + (size_t)row * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n + j * 8;
        const T v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (N % 2 == 0 && col + 1 < N) {
          T2 v;
          v.x = v0;
          v.y = v1;
          *reinterpret_cast<T2*>(yr + col) = v;
        } else {
          if (col < N) yr[col] = v0;
          if (col + 1 < N) yr[col + 1] = v1;
        }
      }
    }
}

// Shared memory of a tensor-core body, in bytes: kMmaStages stages of
// (x tile BM x BK, bf16 or s8, rows padded by 16 bytes; G+ and G- tiles
// BK x BN u8, int8 body: rows padded by 16 bytes), then two weight
// buffers. f32 body: a BK x BN bf16 G+ - G- tile, rows padded to BN + 8
// elements. int8 body: the G+ then the G- tile as BK / 4 rows of BN
// words (4 consecutive K of one column each), rows padded to BN + 8
// words. The pads put the 8 rows an ldmatrix reads in 8 different 16-byte
// bank groups, the 32 words of an int8 B fragment load in 32 banks, and
// the two row groups of a warp's transpose reads in different banks.
template <int BM, int BN, int BK, bool INT8>
struct MmaSmem {
  static constexpr int XS = BK * (INT8 ? 1 : 2) + 16;  // x row stride, bytes
  static constexpr int CS = INT8 ? BN + 16 : BN;        // code row stride, bytes
  static constexpr int WS = BN + 8;  // weight row stride: bf16 elements or words
  static constexpr int X = BM * XS;
  static constexpr int C = BK * CS;
  static constexpr int STAGE = X + 2 * C;
  static constexpr int W = INT8 ? 2 * (BK / 4) * WS * 4 : BK * WS * 2;
  static constexpr int BYTES = kMmaStages * STAGE + 2 * W;
  // the epilogue reuses the stages: XA (BM x kMmaRanks, rows padded by
  // one float) and B (kMmaRanks x BN) in f32
  static_assert(4 * (BM * (kMmaRanks + 1) + kMmaRanks * BN) <= kMmaStages * STAGE,
                "epilogue tiles fit the stages");
};

// Block (i, j, s) computes the BM x BN output tile (i, j) over the rows
// [s * k_split, (s + 1) * k_split) of K. x: bf16 x (f32 body) or the
// prologue's s8 xq (int8 body, with its row scales xs). One split (ws ==
// null): the epilogue y = gamma * (acc * scale + XA @ B) (int8: f32(acc)
// * xs * scale, and XA * xs) follows in the block. Several splits: the
// block writes its raw sums to ws[s] and splitk_epilogue_kernel finishes
// the tile. VEC: 16-byte asynchronous copies (K a multiple of the x
// elements in 16 bytes, N % 16 == 0, 16-byte aligned x and codes), else
// masked scalar loads; both zero-fill past M, N and K.
template <int BM, int BN, int BK, bool VEC, bool INT8>
__global__ void __launch_bounds__(kMmaThreads)
    dora_mma_kernel(const void* __restrict__ xv, const float* __restrict__ xs,
                    const uint8_t* __restrict__ gp, const uint8_t* __restrict__ gn,
                    const float* __restrict__ scale, const float* __restrict__ b,
                    const float* __restrict__ gamma, const float* __restrict__ xa,
                    float* __restrict__ out, typename Num<INT8>::T* __restrict__ ws, int M,
                    int K, int N, int R, int k_split) {
  using L = MmaSmem<BM, BN, BK, INT8>;
  using T = typename Num<INT8>::T;                                   // accumulator
  using XBits = typename std::conditional<INT8, uint8_t, uint16_t>::type;  // one x element
  constexpr int EPC = 16 / (int)sizeof(XBits);  // x elements per 16 bytes
  constexpr int WTM = BM / 2, WTN = BN / 4;      // warp tile
  constexpr int MT = WTM / 16, NT = WTN / 8;     // mma tiles per warp
  constexpr int QK = BK / 4, QN = BN / 4;        // int8 weight words per tile
  static_assert(NT % 2 == 0, "bf16 B fragments load two n8 tiles at a time");
  static_assert(BK % (INT8 ? 32 : 16) == 0, "whole mma steps per stage");
  const XBits* x = reinterpret_cast<const XBits*>(xv);
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * k_split;
  const int tiles = (min(K, kb + k_split) - kb + BK - 1) / BK;

  auto x_of = [&](int st) { return smem + st * L::STAGE; };
  auto gp_of = [&](int st) { return smem + st * L::STAGE + L::X; };
  auto gn_of = [&](int st) { return smem + st * L::STAGE + L::X + L::C; };
  auto w_of = [&](int i) { return smem + kMmaStages * L::STAGE + i * L::W; };

  // stage tile t of this split (an empty group past the last tile)
  auto load_tile = [&](int t) {
    if (t < tiles) {
      const int st = t % kMmaStages, k0 = kb + t * BK;
      unsigned char* xst = x_of(st);
      for (int c = tid; c < BM * (BK / EPC); c += kMmaThreads) {
        const int r = c / (BK / EPC), kc = (c % (BK / EPC)) * EPC;
        const int m = m0 + r, k = k0 + kc;
        unsigned char* dst = xst + r * L::XS + kc * (int)sizeof(XBits);
        if (VEC) {
          const bool in = m < M && k < K;
          cp_async16(dst, in ? x + (size_t)m * K + k : x, in);
        } else {
          __align__(16) XBits v[EPC];
          const XBits* src = x + (size_t)m * K + k;
#pragma unroll
          for (int i = 0; i < EPC; ++i) v[i] = (m < M && k + i < K) ? src[i] : 0;
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
      }
      uint8_t* cps = gp_of(st);
      uint8_t* cns = gn_of(st);
      for (int c = tid; c < BK * (BN / 16); c += kMmaThreads) {
        const int r = c / (BN / 16), nc = (c % (BN / 16)) * 16;
        const int k = k0 + r, n = n0 + nc;
        const size_t off = (size_t)k * N + n;
        if (VEC) {
          const bool in = k < K && n < N;
          cp_async16(cps + r * L::CS + nc, in ? gp + off : gp, in);
          cp_async16(cns + r * L::CS + nc, in ? gn + off : gn, in);
        } else {
          uint32_t p[4] = {0u, 0u, 0u, 0u}, q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (k < K && n + i < N) {
              p[i / 4] |= (uint32_t)gp[off + i] << (8 * (i % 4));
              q[i / 4] |= (uint32_t)gn[off + i] << (8 * (i % 4));
            }
          *reinterpret_cast<uint4*>(cps + r * L::CS + nc) = make_uint4(p[0], p[1], p[2], p[3]);
          *reinterpret_cast<uint4*>(cns + r * L::CS + nc) = make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    }
    cp_async_commit();
  };

  T acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the codes of tile t -> the weight buffer t & 1; each code byte is
  // converted once per block
  auto convert = [&](int t) {
    const int st = t % kMmaStages;
    const uint8_t* cps = gp_of(st);
    const uint8_t* cns = gn_of(st);
    if constexpr (INT8) {
      // a 4 x 4 block of codes per thread and step: word row q < QK of
      // the buffer is G+ rows [4q, 4q + 4), row QK + q the same of G-
      uint32_t* w = reinterpret_cast<uint32_t*>(w_of(t & 1));
      for (int c = tid; c < 2 * QK * QN; c += kMmaThreads) {
        const int q = c / QN, nq = c % QN;
        const uint8_t* src = (q < QK ? cps : cns) + (q % QK) * 4 * L::CS + nq * 4;
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = *reinterpret_cast<const uint32_t*>(src + i * L::CS);
        *reinterpret_cast<uint4*>(w + q * L::WS + nq * 4) = transpose_4x4(r);
      }
    } else {
      // bf16 G+ - G-, 8 columns per thread and step
      __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(w_of(t & 1));
      for (int c = tid; c < BK * (BN / 8); c += kMmaThreads) {
        const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const uint2 p = *reinterpret_cast<const uint2*>(cps + r * L::CS + nc);
        const uint2 q = *reinterpret_cast<const uint2*>(cns + r * L::CS + nc);
        *reinterpret_cast<uint4*>(w + r * L::WS + nc) =
            make_uint4(code_diff_bf16x2(p.x, q.x, 0), code_diff_bf16x2(p.x, q.x, 2),
                       code_diff_bf16x2(p.y, q.y, 0), code_diff_bf16x2(p.y, q.y, 2));
      }
    }
  };

  // the MMAs of one staged tile (x tile xt, weight buffer w)
  auto mma_tile = [&](const unsigned char* xt, const unsigned char* w) {
    if constexpr (INT8) {
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(w);
      const uint32_t* wq = wp + QK * L::WS;  // G-
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t af[MT][4], bp[NT][2], bq[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(af[i], xt + (wm * WTM + i * 16 + (lane & 15)) * L::XS + kk + (lane >> 4) * 16);
        // B fragment of column g: words K/4 = kk/4 + (lane & 3) and 4 more
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = (kk / 4 + (lane & 3)) * L::WS + wn * WTN + j * 8 + (lane >> 2);
          bp[j][0] = wp[o], bp[j][1] = wp[o + 4 * L::WS];
          bq[j][0] = wq[o], bq[j][1] = wq[o + 4 * L::WS];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8u8(acc[i][j], af[i], bp[j][0], bp[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) af[i][e] = neg_s8x4(af[i][e]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8u8(acc[i][j], af[i], bq[j][0], bq[j][1]);
      }
    } else {
      const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(w);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(af[i], xt + (wm * WTM + i * 16 + (lane & 15)) * L::XS + (kk + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, wb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * L::WS + wn * WTN +
                                j * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
            mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) load_tile(t);
  cp_async_wait<kMmaStages - 2>();
  __syncthreads();
  convert(0);

  // One barrier per tile: tile t's MMAs and tile t + 1's conversion use
  // different weight buffers, so the warps interleave them.
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kMmaStages - 3>();  // tile t + 1 landed
    // W[t & 1] is complete, and every warp is done with tile t - 1: its
    // stage slot and W[(t + 1) & 1] are free
    __syncthreads();
    load_tile(t + kMmaStages - 1);
    if (t + 1 < tiles) convert(t + 1);
    mma_tile(x_of(t % kMmaStages), w_of(t & 1));
  }
  cp_async_wait<0>();

  // accumulator (i, j, e) is row g (+8 for e >= 2), column q2 (+1 for odd
  // e) of mma tile (i, j)
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int wr = wm * WTM + g, wc = wn * WTN + q2;  // tile-local origin
  if (ws != nullptr) {
    store_tile<MT, NT, T>(ws + (size_t)blockIdx.z * M * N, acc, M, N, m0 + wr, n0 + wc);
    return;
  }

  // y = acc * scale (int8: f32(acc) * xs * scale), then + XA @ B a rank at
  // a time (kMmaRanks ranks per pass through shared memory; int8: XA * xs),
  // then times gamma
  float xsr[MT][2];  // int8: the row scale of each accumulator row
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wr + i * 16 + h * 8;
      xsr[i][h] = (INT8 && m < M) ? xs[m] : 0.f;
    }
  float y[MT][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + wc + j * 8 + (e & 1);
      const float s = n < N ? scale[n] : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        y[i][j][e] = INT8 ? __fmul_rn(__fmul_rn((float)acc[i][j][e], xsr[i][e >> 1]), s)
                          : acc[i][j][e] * s;
    }
  float* xa_s = reinterpret_cast<float*>(smem);  // [BM][kMmaRanks + 1]
  float* b_s = xa_s + BM * (kMmaRanks + 1);      // [kMmaRanks][BN]
  for (int r0 = 0; r0 < R; r0 += kMmaRanks) {
    __syncthreads();
    // constant trip counts, unrolled: every load of a thread in flight at once
#pragma unroll
    for (int it = 0; it < BM * kMmaRanks / kMmaThreads; ++it) {
      const int p = tid + it * kMmaThreads;
      const int m = m0 + p / kMmaRanks, r = r0 + p % kMmaRanks;
      float v = 0.f;
      if (m < M && r < R) {
        v = xa[(size_t)m * R + r];
        if (INT8) v = __fmul_rn(v, xs[m]);
      }
      xa_s[(p / kMmaRanks) * (kMmaRanks + 1) + p % kMmaRanks] = v;
    }
#pragma unroll
    for (int it = 0; it < kMmaRanks * BN / kMmaThreads; ++it) {
      const int p = tid + it * kMmaThreads;
      const int r = r0 + p / BN, n = n0 + p % BN;
      b_s[p] = (r < R && n < N) ? b[(size_t)r * N + n] : 0.f;
    }
    __syncthreads();
    const int rs = min(kMmaRanks, R - r0);
    for (int r = 0; r < rs; ++r) {
      float xv[MT][2], bv[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) xv[i][h] = xa_s[(wr + i * 16 + h * 8) * (kMmaRanks + 1) + r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) bv[j][h] = b_s[r * BN + wc + j * 8 + h];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[i][j][e] = fmaf(xv[i][e >> 1], bv[j][e & 1], y[i][j][e]);
    }
  }
  float gm[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wc + j * 8 + h;
      gm[j][h] = n < N ? gamma[n] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        y[i][j][2 * h] *= gm[j][0], y[i][j][2 * h + 1] *= gm[j][1];
  store_tile<MT, NT, float>(out, y, M, N, m0 + wr, n0 + wc);
}

// the second pass of a split K, grid (M, ceil(N / kPrepThreads)): the S
// partial sums of ws (f32, or int32 for the int8 body) in split order,
// then the one-split epilogue in the same order of operations
template <bool INT8>
__global__ void __launch_bounds__(kPrepThreads)
    splitk_epilogue_kernel(const typename Num<INT8>::T* __restrict__ ws,
                           const float* __restrict__ xs, const float* __restrict__ scale,
                           const float* __restrict__ b, const float* __restrict__ gamma,
                           const float* __restrict__ xa, float* __restrict__ out, int M,
                           int N, int R, int S) {
  __shared__ float xr[kPrepThreads];
  const int m = blockIdx.x, tid = threadIdx.x;
  for (int r = tid; r < R; r += kPrepThreads)
    xr[r] = INT8 ? __fmul_rn(xa[(size_t)m * R + r], xs[m]) : xa[(size_t)m * R + r];
  __syncthreads();
  const int n = blockIdx.y * kPrepThreads + tid;
  if (n >= N) return;
  typename Num<INT8>::T acc = 0;
  for (int s = 0; s < S; ++s) acc += ws[((size_t)s * M + m) * N + n];
  float y = INT8 ? __fmul_rn(__fmul_rn((float)acc, xs[m]), scale[n]) : acc * scale[n];
  for (int r = 0; r < R; ++r) y = fmaf(xr[r], b[(size_t)r * N + n], y);
  out[(size_t)m * N + n] = y * gamma[n];
}

// ---------------------------------------------------------------------------
// GEMV launcher, f32 body with bf16 x: tensor cores
// ---------------------------------------------------------------------------

// output columns per block (autotune.GEMV_MMA_COLS), rows of K per stage
// (autotune.GEMV_MMA_STAGE), stages of the copy ring, most chunks of K
// of the X @ A blocks, whose partials the epilogue adds (autotune.
// GEMV_XA_CHUNKS)
constexpr int kGemvMmaN = 128;
constexpr int kGemvMmaK = 64;
constexpr int kGemvMmaStages = 4;
constexpr int kGemvXaChunks = 24;
constexpr int kGemvXaRanks = 32;   // ranks of X @ A per pass of its blocks
constexpr int kGemvMmaRanks = 32;  // ranks of XA @ B per epilogue pass
// loads a thread of a strip's last block keeps in flight: float4 groups of
// the parts' raw sums, and X @ A partials. More would not fit the 128
// registers of two blocks an SM beside the rest: at 16 and 24 the kernel
// spilled, and took 13% longer at M = 4 (PERF.md)
constexpr int kGemvSumsInFlight = 4;
constexpr int kGemvXaInFlight = 8;

// Shared memory of the tensor-core GEMV for NT tiles of 8 rows: per stage
// the G+ and G- tiles (kGemvMmaK x kGemvMmaN u8) and the x tile (8 NT x
// kGemvMmaK bf16), all unpadded, their 16-byte chunks XOR-swizzled (below).
// The X @ A blocks and the epilogue reuse the ring.
template <int NT>
struct GemvMmaSmem {
  static constexpr int C = kGemvMmaK * kGemvMmaN;
  static constexpr int X = 8 * NT * kGemvMmaK * 2;
  static constexpr int STAGE = 2 * C + X;
  static constexpr int BYTES = kGemvMmaStages * STAGE;
  static_assert(kPrepRowTile * (kPrepRows + 8) * 2 + kPrepRows * kGemvXaRanks * 4 <= BYTES,
                "the X @ A tiles fit the ring");
  static_assert(4 * ((kGemvMmaRanks + 2) * kGemvMmaN + 8 * NT * kGemvMmaRanks) <= BYTES,
                "the epilogue's B, scale, gamma and XA fit the ring");
  static_assert(4 * 1024 * NT <= BYTES, "the K halves' sums fit the ring");
};

// byte offset of 16-byte chunk c (columns 16c..16c+15) of code row r: the
// chunks are swizzled by bits 2-3 of the row, so the four rows a lane
// group reads (4t + i, same i) fall in four different bank groups
__device__ __forceinline__ int code_chunk(int r, int c) {
  return r * kGemvMmaN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}
// byte offset of chunk c (K 8c..8c+7) of x row rho: swizzled by its low
// two bits, so the rows 8j + g of one half warp fall in different banks
__device__ __forceinline__ int x_chunk(int rho, int c) {
  return rho * kGemvMmaK * 2 + ((c ^ ((rho & 3) << 1)) << 4);
}

// G+ - G- of byte i of (p0, q0) and of (p1, q1) as two bf16 (exact), the
// first in the low half
__device__ __forceinline__ uint32_t code_diff2_bf16x2(uint32_t p0, uint32_t q0, uint32_t p1,
                                                      uint32_t q1, int i) {
  const __nv_bfloat162 d = __floats2bfloat162_rn(byte_f32(p0, i) - byte_f32(q0, i),
                                                 byte_f32(p1, i) - byte_f32(q1, i));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// 4 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// X @ A partials of the tensor-core GEMV: rows [m0, m0 + 16) of X over
// chunk g of K (`sub` slabs of kPrepRows rows, in order), ranks in passes
// of kGemvXaRanks, written to xa[g][m][:]. Each slab is copied to shared
// memory in one go (cp.async: x as bf16 rows, 16 bytes a copy where K % 8
// == 0 and x is aligned, and A's rows for the pass), so a block waits
// about one memory round trip per slab while the code stream loads the
// card.
__device__ __forceinline__ void gemv_xa_tile(const __nv_bfloat16* __restrict__ x,
                                             const float* __restrict__ a,
                                             float* __restrict__ xa, int M, int K, int R,
                                             int m0, int g, int sub, bool vec,
                                             __nv_bfloat16 (*xt)[kPrepRows + 8],
                                             float (*at)[kGemvXaRanks]) {
  const int tid = threadIdx.x;
  const int i = tid / 16, j = tid % 16;  // row m0 + i, ranks r0 + j and r0 + j + 16
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  for (int r0 = 0; r0 < R; r0 += kGemvXaRanks) {
    float acc0 = 0.f, acc1 = 0.f;
    for (int s = 0; s < sub; ++s) {
      const int kb = (g * sub + s) * kPrepRows, kn = min(kPrepRows, K - kb);
      if (kn <= 0) break;
      __syncthreads();  // the previous slab is done with xt and at
      if (vec) {
#pragma unroll
        for (int it = 0; it < kPrepRowTile * kPrepRows / 8 / kPrepThreads; ++it) {
          const int p = tid + it * kPrepThreads, r = p / (kPrepRows / 8), k = p % (kPrepRows / 8) * 8;
          const bool in = m0 + r < M && k < kn;
          cp_async16(&xt[r][k], in ? xb + (size_t)(m0 + r) * K + kb + k : xb, in);
        }
      } else {
        for (int p = tid; p < kPrepRowTile * kPrepRows; p += kPrepThreads) {
          const int r = p / kPrepRows, k = p % kPrepRows;
          xt[r][k] = m0 + r < M && k < kn ? x[(size_t)(m0 + r) * K + kb + k]
                                          : __float2bfloat16(0.f);
        }
      }
#pragma unroll 8
      for (int it = 0; it < kGemvXaRanks * kPrepRows / kPrepThreads; ++it) {
        const int p = tid + it * kPrepThreads, k = p / kGemvXaRanks, r = r0 + p % kGemvXaRanks;
        const bool in = k < kn && r < R;
        cp_async4(&at[k][p % kGemvXaRanks], in ? a + (size_t)(kb + k) * R + r : a, in);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kPrepRows; k += 2) {
        const uint32_t xw = *reinterpret_cast<const uint32_t*>(&xt[i][k]);
        const float x0 = __uint_as_float(xw << 16), x1 = __uint_as_float(xw & 0xffff0000u);
        acc0 = fmaf(x0, at[k][j], acc0), acc1 = fmaf(x0, at[k][j + 16], acc1);
        acc0 = fmaf(x1, at[k + 1][j], acc0), acc1 = fmaf(x1, at[k + 1][j + 16], acc1);
      }
    }
    const int m = m0 + i;
    float* dst = xa + ((size_t)g * M + m) * R + r0;
    if (m < M && r0 + j < R) dst[j] = acc0;
    if (m < M && r0 + j + 16 < R) dst[j + 16] = acc1;
  }
}

// 4 floats at p, of which the first `valid` exist (zeros for the rest),
// bypassing L1: one 16-byte load where all 4 do and v4 (p 16-byte aligned)
__device__ __forceinline__ float4 ldcg4(const float* p, int valid, bool v4) {
  if (v4 && valid >= 4) return __ldcg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = __ldcg(p);
  if (valid > 1) v.y = __ldcg(p + 1);
  if (valid > 2) v.z = __ldcg(p + 2);
  if (valid > 3) v.w = __ldcg(p + 3);
  return v;
}

// One launch. Its first XT G blocks (XT = ceil(M / 16) tiles of 16 rows of
// x, G chunks of K) compute the X @ A partials (gemv_xa_tile) and count
// themselves in sem[0]. Every other block (strip c, part p) computes the
// raw sums of columns [128 c, 128 c + 128) over part p of K (whole stages
// of kGemvMmaK rows, split as evenly as they go) and writes them to
// ws[p]; the last of a strip's parts to arrive (a ticket in sem[1 + c],
// which it resets) adds ws[0..parts) in part order and applies the
// epilogue y = gamma * (acc * scale + XA @ B), XA being the G partials
// added in chunk order once sem[0] says they are all written; the last
// strip to finish resets sem[0]. No data goes through atomics, so two
// launches are bitwise equal, and sem is all zero again at the end.
//
// Waiting: only a strip's last block waits, for the X @ A blocks, and
// those wait for nothing and have the lowest block indices: blocks start
// in index order, and every plan fits one wave (autotune.gemv_plan), so
// they are running or done.
//
// Main loop: a kGemvMmaStages ring of 16-byte cp.async copies (codes and x;
// one barrier a stage). Warp (wc, wk) takes columns 32 wc..+32 and the K
// half 32 wk..+32 of each stage; the two K halves are added in warp order
// at the end. The MMA is the swapped product Y^T = W^T X^T, m16n8k16 bf16:
// 16 output columns are the MMA's rows, 8 rows of x its columns. Lane
// (g, t) reads one word (4 columns) of 4 code rows 4t + i and converts in
// registers: MMA row g takes column 4g + 2c and row g + 8 column 4g + 2c +
// 1 of column tile c, and the MMA's k index 2t + (0, 1, 8, 9) is the
// stage's row 4t + (0, 1, 2, 3), so the B fragment is 4 contiguous bf16 of
// x: one 8-byte shared load. No float weight reaches memory.
//
// The strip's last block reads the parts' raw sums with B, scale and gamma,
// then XA's partials, a few loads in flight a thread (kGemvSumsInFlight,
// kGemvXaInFlight), so that it needs no more registers than the main loop.
template <int NT, bool VEC>
__global__ void __launch_bounds__(kGemvThreads, 2)
    dora_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                         const uint8_t* __restrict__ gp, const uint8_t* __restrict__ gn,
                         const float* __restrict__ scale, const float* __restrict__ b,
                         const float* __restrict__ gamma, float* __restrict__ out,
                         float* __restrict__ ws, float* __restrict__ xa, int* __restrict__ sem,
                         int M, int K, int N, int R, int parts, int G, int sub) {
  using L = GemvMmaSmem<NT>;
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int XT = (M + kPrepRowTile - 1) / kPrepRowTile, xa_blocks = XT * G;

  if ((int)blockIdx.x < xa_blocks) {
    gemv_xa_tile(x, a, xa, M, K, R, (blockIdx.x % XT) * kPrepRowTile, blockIdx.x / XT, sub,
                 VEC, reinterpret_cast<__nv_bfloat16(*)[kPrepRows + 8]>(smem),
                 reinterpret_cast<float(*)[kGemvXaRanks]>(
                     smem + kPrepRowTile * (kPrepRows + 8) * 2));
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(sem, 1);
    return;
  }

  const int blk = blockIdx.x - xa_blocks;
  const int part = blk % parts, strip = blk / parts;
  const int strips = (gridDim.x - xa_blocks) / parts;
  const int n0 = strip * kGemvMmaN;
  const int stages = (K + kGemvMmaK - 1) / kGemvMmaK;
  const int kb = part * stages / parts * kGemvMmaK;
  const int ke = min(K, (part + 1) * stages / parts * kGemvMmaK);
  const int tiles = (ke - kb + kGemvMmaK - 1) / kGemvMmaK;
  const int wc = warp & 3, wk = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);

  // stage tile j of this part (an empty group past the last tile); rows
  // past the part's end, columns past N and rows of x past M are zeros
  auto load_tile = [&](int j) {
    if (j < tiles) {
      unsigned char* st = smem + (j % kGemvMmaStages) * L::STAGE;
      const int k0 = kb + j * kGemvMmaK;
#pragma unroll
      for (int it = 0; it < kGemvMmaK * (kGemvMmaN / 16) / kGemvThreads; ++it) {
        const int q = tid + it * kGemvThreads;
        const int r = q / (kGemvMmaN / 16), c = q % (kGemvMmaN / 16);
        const int k = k0 + r, n = n0 + c * 16;
        const size_t off = (size_t)k * N + n;
        unsigned char* dp = st + code_chunk(r, c);
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
      for (int q = tid; q < 8 * NT * (kGemvMmaK / 8); q += kGemvThreads) {
        const int rho = q / (kGemvMmaK / 8), c = q % (kGemvMmaK / 8);
        const int k = k0 + c * 8;
        unsigned char* dp = st + 2 * L::C + x_chunk(rho, c);
        const uint16_t* src = xb + (size_t)rho * K + k;
        if (VEC) {
          const bool in = rho < M && k < ke;
          cp_async16(dp, in ? src : xb, in);
        } else {
          __align__(16) uint16_t v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = (rho < M && k + i < ke) ? src[i] : 0;
          *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(v);
        }
      }
    }
    cp_async_commit();
  };

  float acc[2][NT][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;

  // the MMAs of this warp's K half of tile j
  auto mma_tile = [&](int j) {
    const unsigned char* st = smem + (j % kGemvMmaStages) * L::STAGE;
    const unsigned char* xs = st + 2 * L::C;
    // this lane's word of a code row: (r >> 2) & 3 == t for its rows
    const int cw = (((2 * wc + (g >> 2)) ^ (t << 1)) << 4) + (g & 3) * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = 32 * wk + 16 * h + 4 * t;
      uint32_t p[4], q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = *reinterpret_cast<const uint32_t*>(st + (r0 + i) * kGemvMmaN + cw);
        q[i] = *reinterpret_cast<const uint32_t*>(st + L::C + (r0 + i) * kGemvMmaN + cw);
      }
      uint32_t af[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        af[c][0] = code_diff2_bf16x2(p[0], q[0], p[1], q[1], 2 * c);
        af[c][1] = code_diff2_bf16x2(p[0], q[0], p[1], q[1], 2 * c + 1);
        af[c][2] = code_diff2_bf16x2(p[2], q[2], p[3], q[3], 2 * c);
        af[c][3] = code_diff2_bf16x2(p[2], q[2], p[3], q[3], 2 * c + 1);
      }
      // x row 8 j + g, K 4t..4t+3 of this half: chunk xc, half t & 1
      const int xc = 4 * wk + 2 * h + (t >> 1);
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const uint2 bv =
            *reinterpret_cast<const uint2*>(xs + x_chunk(8 * jt + g, xc) + 8 * (t & 1));
        mma_bf16(acc[0][jt], af[0], bv.x, bv.y);
        mma_bf16(acc[1][jt], af[1], bv.x, bv.y);
      }
    }
  };

#pragma unroll
  for (int j = 0; j < kGemvMmaStages - 1; ++j) load_tile(j);
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kGemvMmaStages - 2>();  // tile j landed
    // every warp is done with tile j - 1: its stage slot is free
    __syncthreads();
    load_tile(j + kGemvMmaStages - 1);
    mma_tile(j);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the second K half's sums onto the first, then this part's raw sums to
  // ws[part]: lane (g, t) holds columns 4g..4g+3 of its warp's 32 for rows
  // 8 jt + 2t (+1)
  float* red = smem_f;  // [warp wc][c][jt][e][lane]
  if (wk == 1) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(((wc * 2 + c) * NT + j) * 4 + e) * 32 + lane] = acc[c][j][e];
  }
  __syncthreads();
  if (wk == 0) {
    const int nc = n0 + 32 * wc + 4 * g;
    float* wp = ws + (size_t)part * M * N;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = 8 * j + 2 * t + u;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e >> 1, i = ((e & 1) << 1) + u;  // column 4g + e
          v[e] = acc[c][j][i] + red[(((wc * 2 + c) * NT + j) * 4 + i) * 32 + lane];
        }
        if (m >= M) continue;
        float* row = wp + (size_t)m * N;
        if (N % 4 == 0 && nc < N) {
          *reinterpret_cast<float4*>(row + nc) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (nc + e < N) row[nc + e] = v[e];
        }
      }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(sem + 1 + strip, 1) == parts - 1;
    if (last) atomicExch(sem + 1 + strip, 0);  // every part of the strip has counted
  }
  __syncthreads();
  if (!last) return;

  // The strip's last block. Thread i takes the groups of 4 columns i,
  // i + 256, ... (row m, columns 4 (i % 32)..+3). First: B for ranks
  // [0, kGemvMmaRanks), scale and gamma of the strip, a look at sem[0],
  // and the groups' raw sums of every part, added in part order
  // (kGemvSumsInFlight / NT parts of every group in flight at a time, at
  // least one). Then, once every X @ A block has written (usually long
  // since), XA for those ranks: its G partials added in chunk order,
  // kGemvXaInFlight at a time.
  float* b_s = smem_f;                             // [kGemvMmaRanks][kGemvMmaN]
  float* sg_s = b_s + kGemvMmaRanks * kGemvMmaN;   // scale[128], gamma[128]
  float* xa_s = sg_s + 2 * kGemvMmaN;              // [M][kGemvMmaRanks]
  constexpr int PB = NT < kGemvSumsInFlight ? kGemvSumsInFlight / NT : 1;
  const bool v4 = N % 4 == 0;  // ws and out rows: 16-byte aligned groups
  int seen = 0;
  if (tid == 0) seen = *reinterpret_cast<volatile int*>(sem);
  auto stage_b = [&](int r0) {
#pragma unroll
    for (int it = 0; it < kGemvMmaRanks * kGemvMmaN / kGemvThreads; ++it) {
      const int p = tid + it * kGemvThreads;
      const int r = r0 + p / kGemvMmaN, n = n0 + p % kGemvMmaN;
      b_s[p] = r < R && n < N ? b[(size_t)r * N + n] : 0.f;
    }
  };
  stage_b(0);
  {
    const int n = n0 + tid % kGemvMmaN;
    sg_s[tid] = n < N ? (tid < kGemvMmaN ? scale[n] : gamma[n]) : 0.f;
  }
  float4 y[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < parts; q0 += PB) {
    float4 v[NT][PB];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int it = tid + i * kGemvThreads, m = it / 32, n = n0 + it % 32 * 4;
#pragma unroll
      for (int u = 0; u < PB; ++u)
        v[i][u] = ldcg4(ws + ((size_t)(q0 + u) * M + m) * N + n,
                        m < M && q0 + u < parts ? N - n : 0, v4);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int u = 0; u < PB; ++u)
        if (q0 + u < parts)
          y[i].x += v[i][u].x, y[i].y += v[i][u].y, y[i].z += v[i][u].z, y[i].w += v[i][u].w;
  }
  if (tid == 0 && seen < xa_blocks) {
    const volatile int* count = sem;
    while (*count < xa_blocks) __nanosleep(128);
  }
  __syncthreads();
  __threadfence();
  auto stage_xa = [&](int r0) {
    for (int i = 0; i < NT; ++i) {  // M * kGemvMmaRanks <= NT * kGemvThreads
      const int p = tid + i * kGemvThreads;
      const int m = p / kGemvMmaRanks, r = r0 + p % kGemvMmaRanks;
      float sum = 0.f;
      for (int q0 = 0; q0 < G; q0 += kGemvXaInFlight) {
        float v[kGemvXaInFlight];
#pragma unroll
        for (int q = 0; q < kGemvXaInFlight; ++q)
          v[q] = m < M && r < R && q0 + q < G
                     ? __ldcg(xa + ((size_t)(q0 + q) * M + m) * R + r) : 0.f;
#pragma unroll
        for (int q = 0; q < kGemvXaInFlight; ++q)
          if (q0 + q < G) sum += v[q];
      }
      if (m < M) xa_s[p] = sum;
    }
  };
  stage_xa(0);
  float4 low[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) low[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < R; r0 += kGemvMmaRanks) {
    if (r0 > 0) {
      stage_b(r0);
      stage_xa(r0);
    }
    __syncthreads();
    const int rs = min(kGemvMmaRanks, R - r0);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int it = tid + i * kGemvThreads, m = it / 32, c = it % 32 * 4;
      if (m >= M) continue;
      for (int r = 0; r < rs; ++r) {
        const float xv = xa_s[m * kGemvMmaRanks + r];
        const float4 bv = *reinterpret_cast<const float4*>(b_s + r * kGemvMmaN + c);
        low[i].x = fmaf(xv, bv.x, low[i].x), low[i].y = fmaf(xv, bv.y, low[i].y);
        low[i].z = fmaf(xv, bv.z, low[i].z), low[i].w = fmaf(xv, bv.w, low[i].w);
      }
    }
    __syncthreads();  // b_s and xa_s are free for the next ranks
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int it = tid + i * kGemvThreads, m = it / 32, c = it % 32 * 4, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float o[4] = {(y[i].x * sg_s[c] + low[i].x) * sg_s[kGemvMmaN + c],
                        (y[i].y * sg_s[c + 1] + low[i].y) * sg_s[kGemvMmaN + c + 1],
                        (y[i].z * sg_s[c + 2] + low[i].z) * sg_s[kGemvMmaN + c + 2],
                        (y[i].w * sg_s[c + 3] + low[i].w) * sg_s[kGemvMmaN + c + 3]};
    float* dst = out + (size_t)m * N + n;
    if (v4 && n + 3 < N) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) dst[e] = o[e];
    }
  }
  // every XA read of this block is done: the last strip resets sem[0]
  if (tid == 0 && atomicAdd(sem, 1) == xa_blocks + strips - 1) atomicExch(sem, 0);
}

// ---------------------------------------------------------------------------
// GEMV launcher, int8 body (any x): tensor cores
// ---------------------------------------------------------------------------

// The int8 tensor-core GEMV keeps the f32 one's strip (kGemvMmaN columns),
// stage (kGemvMmaK rows of K), ring (kGemvMmaStages) and X @ A chunks. Its
// s8 x slab of a stage: rows of kGemvMmaK / 4 words, padded by 4 words so
// that the 8 rows of a B fragment load fall in 8 different bank groups.
constexpr int kXqStride = kGemvMmaK / 4 + 4;

// Shared memory of the int8 tensor-core GEMV for NT tiles of 8 rows of x
// of type TX: per stage the G+ and G- tiles (kGemvMmaK x kGemvMmaN u8,
// chunks swizzled as code_chunk says) and the raw x tile (8 NT x kGemvMmaK
// TX, unpadded), then two buffers of the quantized x tile, each its xq
// words then its -xq words (8 NT rows of kXqStride words). The X @ A
// blocks and the epilogue reuse the ring.
template <int NT, typename TX>
struct GemvInt8Smem {
  static constexpr int C = kGemvMmaK * kGemvMmaN;
  static constexpr int X = 8 * NT * kGemvMmaK * (int)sizeof(TX);
  static constexpr int STAGE = 2 * C + X;
  static constexpr int RING = kGemvMmaStages * STAGE;
  static constexpr int XQ = 8 * NT * kXqStride;  // words of xq (and of -xq) a buffer
  static constexpr int BYTES = RING + 2 * 2 * XQ * 4;
  static_assert(4 * kPrepRowTile * (kPrepRows + 4) + kPrepRows * kGemvXaRanks * 4 <= RING,
                "the X @ A tiles fit the ring");
  static_assert(4 * ((kGemvMmaRanks + 2) * kGemvMmaN + 8 * NT * kGemvMmaRanks) <= RING,
                "the epilogue's B, scale, gamma and XA fit the ring");
  static_assert(4 * 1024 * NT <= RING, "the K halves' sums fit the ring");
  // autotune.gemv_int8_wave counts on the launch bounds' two blocks an SM
  // below 8 tiles of rows: their shared memory (1 KB a block reserved, and
  // the kernel's static row scales) must fit the SM's 228 KB
  static_assert(NT == 8 || 2 * (BYTES + 1024 + 512) <= 233472, "two blocks fit an SM");
};

// 4 consecutive values of x at p as f32
__device__ __forceinline__ void x4_f32(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void x4_f32(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// max |v| over the 16 bytes u of x values of type TX
template <typename TX>
__device__ __forceinline__ float absmax16(uint4 u);
template <>
__device__ __forceinline__ float absmax16<float>(uint4 u) {
  return fmaxf(fmaxf(fabsf(__uint_as_float(u.x)), fabsf(__uint_as_float(u.y))),
               fmaxf(fabsf(__uint_as_float(u.z)), fabsf(__uint_as_float(u.w))));
}
template <>
__device__ __forceinline__ float absmax16<__nv_bfloat16>(uint4 u) {
  // bf16 magnitudes compare as unsigned halfwords
  const uint32_t h = __vmaxu2(__vmaxu2(u.x & 0x7fff7fffu, u.y & 0x7fff7fffu),
                              __vmaxu2(u.z & 0x7fff7fffu, u.w & 0x7fff7fffu));
  return __uint_as_float(max(h << 16, h & 0xffff0000u));
}

// The row scales of rows [m0, m0 + rows) of x (M x K) into xs_s[0, rows),
// one warp a row: max(max |x|, 1e-30) / 127, as the reference's
// _quantize_rows; rows past M get 1 (their zeros quantize to 0). VEC: the
// rows as 16-byte loads (K a multiple of the values in 16 bytes, x aligned)
template <bool VEC, typename TX>
__device__ __forceinline__ void gemv_row_scales(const TX* __restrict__ x, int M, int K, int m0,
                                                int rows, float* xs_s) {
  constexpr int EPV = 16 / (int)sizeof(TX);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < rows; i += kGemvWarps) {
    const int m = m0 + i;
    float amax = 0.f;
    if (m < M) {
      const TX* xr = x + (size_t)m * K;
      if (VEC) {
        const uint4* v = reinterpret_cast<const uint4*>(xr);
#pragma unroll 8
        for (int c = lane; c < K / EPV; c += 32) amax = fmaxf(amax, absmax16<TX>(__ldg(v + c)));
      } else {
        for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) xs_s[i] = m < M ? __fdiv_rn(fmaxf(amax, 1e-30f), 127.f) : 1.f;
  }
}

// X @ A partials of the int8 tensor-core GEMV: gemv_xa_tile on xq, the
// rows [m0, m0 + 16) of x quantized with their scales xs_s as each slab is
// staged in shared memory (as f32, exact), A's rows copied meanwhile
template <typename TX>
__device__ __forceinline__ void gemv_xa_tile_int8(const TX* __restrict__ x,
                                                  const float* xs_s,
                                                  const float* __restrict__ a,
                                                  float* __restrict__ xa, int M, int K, int R,
                                                  int m0, int g, int sub,
                                                  float (*xt)[kPrepRows + 4],
                                                  float (*at)[kGemvXaRanks]) {
  const int tid = threadIdx.x;
  const int i = tid / 16, j = tid % 16;  // row m0 + i, ranks r0 + j and r0 + j + 16
  for (int r0 = 0; r0 < R; r0 += kGemvXaRanks) {
    float acc0 = 0.f, acc1 = 0.f;
    for (int s = 0; s < sub; ++s) {
      const int kb = (g * sub + s) * kPrepRows, kn = min(kPrepRows, K - kb);
      if (kn <= 0) break;
      __syncthreads();  // the previous slab is done with xt and at
#pragma unroll 8
      for (int it = 0; it < kGemvXaRanks * kPrepRows / kPrepThreads; ++it) {
        const int p = tid + it * kPrepThreads, k = p / kGemvXaRanks, r = r0 + p % kGemvXaRanks;
        const bool in = k < kn && r < R;
        cp_async4(&at[k][p % kGemvXaRanks], in ? a + (size_t)(kb + k) * R + r : a, in);
      }
      cp_async_commit();
#pragma unroll 4
      for (int it = 0; it < kPrepRowTile * kPrepRows / kPrepThreads; ++it) {
        const int p = tid + it * kPrepThreads, r = p / kPrepRows, k = p % kPrepRows;
        const int m = m0 + r;
        xt[r][k] = m < M && k < kn
                       ? (float)quantize_s8(to_f32(x[(size_t)m * K + kb + k]), xs_s[r])
                       : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kPrepRows; k += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(&xt[i][k]);
        acc0 = fmaf(xv.x, at[k][j], acc0), acc1 = fmaf(xv.x, at[k][j + 16], acc1);
        acc0 = fmaf(xv.y, at[k + 1][j], acc0), acc1 = fmaf(xv.y, at[k + 1][j + 16], acc1);
        acc0 = fmaf(xv.z, at[k + 2][j], acc0), acc1 = fmaf(xv.z, at[k + 2][j + 16], acc1);
        acc0 = fmaf(xv.w, at[k + 3][j], acc0), acc1 = fmaf(xv.w, at[k + 3][j + 16], acc1);
      }
    }
    const int m = m0 + i;
    float* dst = xa + ((size_t)g * M + m) * R + r0;
    if (m < M && r0 + j < R) dst[j] = acc0;
    if (m < M && r0 + j + 16 < R) dst[j + 16] = acc1;
  }
}

// c += a (16x32 u8, row) x b (32x8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_u8s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 ints at p, of which the first `valid` exist (zeros for the rest),
// bypassing L1: one 16-byte load where all 4 do and v4 (p 16-byte aligned)
__device__ __forceinline__ int4 ldcg4i(const int* p, int valid, bool v4) {
  if (v4 && valid >= 4) return __ldcg(reinterpret_cast<const int4*>(p));
  int4 v = make_int4(0, 0, 0, 0);
  if (valid > 0) v.x = __ldcg(p);
  if (valid > 1) v.y = __ldcg(p + 1);
  if (valid > 2) v.z = __ldcg(p + 2);
  if (valid > 3) v.w = __ldcg(p + 3);
  return v;
}

// The int8 body of the GEMV launcher in one launch, for x of type TX (f32
// or bf16). It replaces the TPU kernel repro/kernels/dora_linear.py::
// _kernel_int8 as dora_linear_gemv runs it, with the jnp helpers
// _quantize_rows and recode_s8:
//
//     xs = max(max|x_row|, 1e-30) / 127,  xq = clip(rint(x / xs), +-127)
//     Y  = gamma * (f32(xq @ (G+ - G-)) * xs * scale + ((xq @ A) * xs) @ B)
//
// What bounds it: the code stream, 2 bytes a weight (0.0308 ms a
// qwen3-1.7b layer at M = 4 on an H100); the s8 x u8 MMAs are M operations
// a code byte, far under the int8 tensor-core ridge. The design streams
// the codes as the f32 tensor-core GEMV does and keeps every other cost
// off that stream:
// * Grid and order as dora_gemv_mma_kernel: the first XT G blocks (at
//   most kGemvXaChunks) compute the X @ A partials on xq
//   (gemv_xa_tile_int8) and count themselves in
//   sem[0]; every other block (strip c, part p) writes its parts' raw
//   int32 sums to ws[p], and the strip's last block (a ticket in
//   sem[1 + c]) adds ws[0..parts) in part order (exact integers: the
//   result does not depend on the split), and applies the epilogue in the
//   reference's
//   order: XA = the chunk partials summed in chunk order, times xs; then
//   f32(acc) * xs * scale + XA @ B, times gamma, each product and sum
//   rounded alone. The last strip resets sem[0].
// * Row scales inside the launch: every block takes max |x| of the rows
//   it needs, a warp a row, after it has issued its first stages of codes
//   (xs_in null); max is order-free and the division IEEE, so every block
//   gets the same bits. From autotune.GEMV_INT8_PRESCALE_ROWS rows, where
//   every block reading all of x costs more than a pass of its own, the
//   launcher runs row_scale_kernel first and the blocks read xs_in.
// * Main loop: a kGemvMmaStages ring of 16-byte cp.async copies of both
//   code slabs and the raw x slab. Each staged x slab is quantized once per
//   block, into shared s8 words of xq and -xq (double-buffered: stage j + 1
//   is quantized while stage j's MMAs run, one barrier a stage). Warp (wc,
//   wk) takes columns 32 wc..+32 and the K half 32 wk..+32 of each stage;
//   the K halves are added at the end. The MMA is mma.m16n8k32 u8 x s8 on
//   the swapped product Y^T = W^T X^T: 16 output columns are its rows, 8
//   rows of x its columns. Lane (g, t) reads one word (4 columns) of the
//   code rows 4t + i and 16 + 4t + i (i < 4) of its K half and turns each
//   group of 4 with transpose_4x4 into words of 4 consecutive K of one
//   column: MMA row g takes column 4g + 2c and row g + 8 column 4g + 2c + 1
//   of column tile c, the A fragment as it is. The B fragment is one
//   32-bit shared load of 4 consecutive K of one xq row. G+ is multiplied
//   by xq and G- by -xq into one s32 accumulator: no s8 copy of the codes
//   and no float weight reaches memory.
// * Rows of x past M are zeros, with scale 1; ragged K and N (VEC false:
//   K not a multiple of the values in 16 bytes, N % 16, unaligned
//   operands) are staged by masked, zero-filling scalar loads.
template <int NT, bool VEC, typename TX>
__global__ void __launch_bounds__(kGemvThreads, NT < 8 ? 2 : 1)
    dora_gemv_int8_kernel(const TX* __restrict__ x, const float* __restrict__ xs_in,
                          const float* __restrict__ a, const uint8_t* __restrict__ gp,
                          const uint8_t* __restrict__ gn, const float* __restrict__ scale,
                          const float* __restrict__ b, const float* __restrict__ gamma,
                          float* __restrict__ out, int* __restrict__ ws, float* __restrict__ xa,
                          int* __restrict__ sem, int M, int K, int N, int R, int parts, int G,
                          int sub) {
  using L = GemvInt8Smem<NT, TX>;
  constexpr int EPC = 16 / (int)sizeof(TX);  // x values a 16-byte copy
  constexpr int XW = kGemvMmaK * (int)sizeof(TX);  // bytes of a raw x row of a stage
  using XBits = typename std::conditional<sizeof(TX) == 2, uint16_t, uint32_t>::type;
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ float xs_s[8 * NT > kPrepRowTile ? 8 * NT : kPrepRowTile];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int XT = (M + kPrepRowTile - 1) / kPrepRowTile, xa_blocks = XT * G;

  if ((int)blockIdx.x < xa_blocks) {
    const int m0 = (blockIdx.x % XT) * kPrepRowTile;
    if (xs_in != nullptr) {
      if (tid < kPrepRowTile) xs_s[tid] = m0 + tid < M ? xs_in[m0 + tid] : 1.f;
    } else {
      gemv_row_scales<VEC>(x, M, K, m0, kPrepRowTile, xs_s);
    }
    __syncthreads();
    gemv_xa_tile_int8(x, xs_s, a, xa, M, K, R, m0, blockIdx.x / XT, sub,
                      reinterpret_cast<float(*)[kPrepRows + 4]>(smem),
                      reinterpret_cast<float(*)[kGemvXaRanks]>(
                          smem + 4 * kPrepRowTile * (kPrepRows + 4)));
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(sem, 1);
    return;
  }

  const int blk = blockIdx.x - xa_blocks;
  const int part = blk % parts, strip = blk / parts;
  const int strips = (gridDim.x - xa_blocks) / parts;
  const int n0 = strip * kGemvMmaN;
  const int stages = (K + kGemvMmaK - 1) / kGemvMmaK;
  const int kb = part * stages / parts * kGemvMmaK;
  const int ke = min(K, (part + 1) * stages / parts * kGemvMmaK);
  const int tiles = (ke - kb + kGemvMmaK - 1) / kGemvMmaK;
  const int wc = warp & 3, wk = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  auto xq_of = [&](int i) {
    return reinterpret_cast<uint32_t*>(smem + L::RING) + i * 2 * L::XQ;
  };

  // stage tile j of this part (an empty group past the last tile); rows
  // past the part's end, columns past N and rows of x past M are zeros
  auto load_tile = [&](int j) {
    if (j < tiles) {
      unsigned char* st = smem + (j % kGemvMmaStages) * L::STAGE;
      const int k0 = kb + j * kGemvMmaK;
#pragma unroll
      for (int it = 0; it < kGemvMmaK * (kGemvMmaN / 16) / kGemvThreads; ++it) {
        const int q = tid + it * kGemvThreads;
        const int r = q / (kGemvMmaN / 16), c = q % (kGemvMmaN / 16);
        const int k = k0 + r, n = n0 + c * 16;
        const size_t off = (size_t)k * N + n;
        unsigned char* dp = st + code_chunk(r, c);
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
      for (int q = tid; q < 8 * NT * (kGemvMmaK / EPC); q += kGemvThreads) {
        const int rho = q / (kGemvMmaK / EPC), c = q % (kGemvMmaK / EPC);
        const int k = k0 + c * EPC;
        unsigned char* dp = st + 2 * L::C + rho * XW + c * 16;
        const XBits* src = reinterpret_cast<const XBits*>(x) + (size_t)rho * K + k;
        if (VEC) {
          const bool in = rho < M && k < ke;
          cp_async16(dp, in ? src : reinterpret_cast<const XBits*>(x), in);
        } else {
          __align__(16) XBits v[EPC];
#pragma unroll
          for (int i = 0; i < EPC; ++i) v[i] = (rho < M && k + i < ke) ? src[i] : 0;
          *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(v);
        }
      }
    }
    cp_async_commit();
  };

  // tile j's x slab -> xq and -xq words in buffer j & 1, once per block;
  // rows past M are zero words without a division (an IEEE division of 0
  // takes the slow path, which cost up to a third of the kernel at M = 1)
  auto quantize = [&](int j) {
    const unsigned char* xr = smem + (j % kGemvMmaStages) * L::STAGE + 2 * L::C;
    uint32_t* qb = xq_of(j & 1);
    for (int q = tid; q < 8 * NT * (kGemvMmaK / 4); q += kGemvThreads) {
      const int rho = q / (kGemvMmaK / 4), w = q % (kGemvMmaK / 4);
      uint32_t word = 0u;
      if (rho < M) {
        float v[4];
        x4_f32(reinterpret_cast<const TX*>(xr + rho * XW) + 4 * w, v);
        const float s = xs_s[rho];
#pragma unroll
        for (int e = 0; e < 4; ++e) word |= ((uint32_t)quantize_s8(v[e], s) & 0xffu) << (8 * e);
      }
      qb[rho * kXqStride + w] = word;
      qb[L::XQ + rho * kXqStride + w] = neg_s8x4(word);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0;

  // the MMAs of this warp's K half of tile j
  auto mma_tile = [&](int j) {
    const unsigned char* st = smem + (j % kGemvMmaStages) * L::STAGE;
    // this lane's word of a code row: (r >> 2) & 3 == t for its rows
    const int cw = (((2 * wc + (g >> 2)) ^ (t << 1)) << 4) + (g & 3) * 4;
    uint4 pa[2], na[2];  // [K 4t.. or 16 + 4t..] words of 4 K of columns 4g..4g+3
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = 32 * wk + 16 * h + 4 * t;
      uint32_t p[4], q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = *reinterpret_cast<const uint32_t*>(st + (r0 + i) * kGemvMmaN + cw);
        q[i] = *reinterpret_cast<const uint32_t*>(st + L::C + (r0 + i) * kGemvMmaN + cw);
      }
      pa[h] = transpose_4x4(p);
      na[h] = transpose_4x4(q);
    }
    const uint32_t* qb = xq_of(j & 1) + g * kXqStride + 8 * wk + t;
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      const uint32_t* xr = qb + 8 * jt * kXqStride;
      const uint32_t b0 = xr[0], b1 = xr[4], nb0 = xr[L::XQ], nb1 = xr[L::XQ + 4];
      mma_u8s8(acc[0][jt], pa[0].x, pa[0].y, pa[1].x, pa[1].y, b0, b1);
      mma_u8s8(acc[1][jt], pa[0].z, pa[0].w, pa[1].z, pa[1].w, b0, b1);
      mma_u8s8(acc[0][jt], na[0].x, na[0].y, na[1].x, na[1].y, nb0, nb1);
      mma_u8s8(acc[1][jt], na[0].z, na[0].w, na[1].z, na[1].w, nb0, nb1);
    }
  };

#pragma unroll
  for (int j = 0; j < kGemvMmaStages - 1; ++j) load_tile(j);
  // the row scales while the first stages land
  if (xs_in != nullptr) {
    if (tid < 8 * NT) xs_s[tid] = tid < M ? xs_in[tid] : 1.f;
  } else {
    gemv_row_scales<VEC>(x, M, K, 0, 8 * NT, xs_s);
  }
  cp_async_wait<kGemvMmaStages - 2>();  // tile 0 landed
  __syncthreads();
  quantize(0);

  // One barrier per tile: tile j's MMAs and tile j + 1's quantization use
  // different xq buffers, so the warps interleave them.
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kGemvMmaStages - 3>();  // tile j + 1 landed
    // xq[j & 1] is complete, and every warp is done with tile j - 1: its
    // stage slot and xq[(j + 1) & 1] are free
    __syncthreads();
    load_tile(j + kGemvMmaStages - 1);
    if (j + 1 < tiles) quantize(j + 1);
    mma_tile(j);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the second K half's sums onto the first, then this part's raw sums to
  // ws[part]: lane (g, t) holds columns 4g..4g+3 of its warp's 32 for rows
  // 8 jt + 2t (+1)
  int* red = reinterpret_cast<int*>(smem_f);  // [warp wc][c][jt][e][lane]
  if (wk == 1) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(((wc * 2 + c) * NT + j) * 4 + e) * 32 + lane] = acc[c][j][e];
  }
  __syncthreads();
  if (wk == 0) {
    const int nc = n0 + 32 * wc + 4 * g;
    int* wp = ws + (size_t)part * M * N;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = 8 * j + 2 * t + u;
        int v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e >> 1, i = ((e & 1) << 1) + u;  // column 4g + e
          v[e] = acc[c][j][i] + red[(((wc * 2 + c) * NT + j) * 4 + i) * 32 + lane];
        }
        if (m >= M) continue;
        int* row = wp + (size_t)m * N;
        if (N % 4 == 0 && nc < N) {
          *reinterpret_cast<int4*>(row + nc) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (nc + e < N) row[nc + e] = v[e];
        }
      }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(sem + 1 + strip, 1) == parts - 1;
    if (last) atomicExch(sem + 1 + strip, 0);  // every part of the strip has counted
  }
  __syncthreads();
  if (!last) return;

  // The strip's last block. Thread i takes the groups of 4 columns i,
  // i + 256, ... (row m, columns 4 (i % 32)..+3). B for a pass of
  // kGemvMmaRanks ranks, scale and gamma of the strip are copied
  // asynchronously while the parts' raw sums are added, exact integers
  // (as many loads a thread in flight as dora_gemv_mma_kernel: more, up to
  // 16 sums and 24 partials, were no faster at any M, and spilled from
  // NT = 2 up; tools/gemv_costs.py); then, once every X @ A block has
  // written, XA for those ranks: its chunk partials added in chunk order,
  // times xs.
  float* b_s = smem_f;                             // [kGemvMmaRanks][kGemvMmaN]
  float* sg_s = b_s + kGemvMmaRanks * kGemvMmaN;   // scale[128], gamma[128]
  float* xa_s = sg_s + 2 * kGemvMmaN;              // [M][kGemvMmaRanks]
  constexpr int PB = NT < kGemvSumsInFlight ? kGemvSumsInFlight / NT : 1;
  const bool v4 = N % 4 == 0;  // ws and out rows: 16-byte aligned groups
  int seen = 0;
  if (tid == 0) seen = *reinterpret_cast<volatile int*>(sem);
  auto stage_b = [&](int r0) {
#pragma unroll
    for (int it = 0; it < kGemvMmaRanks * kGemvMmaN / kGemvThreads; ++it) {
      const int p = tid + it * kGemvThreads;
      const int r = r0 + p / kGemvMmaN, n = n0 + p % kGemvMmaN;
      const bool in = r < R && n < N;
      cp_async4(b_s + p, in ? b + (size_t)r * N + n : b, in);
    }
    cp_async_commit();
  };
  stage_b(0);
  {
    const int n = n0 + tid % kGemvMmaN;
    const bool in = n < N;
    cp_async4(sg_s + tid, in ? (tid < kGemvMmaN ? scale : gamma) + n : scale, in);
    cp_async_commit();
  }
  int4 y[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) y[i] = make_int4(0, 0, 0, 0);
  for (int q0 = 0; q0 < parts; q0 += PB) {
    int4 v[NT][PB];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int it = tid + i * kGemvThreads, m = it / 32, n = n0 + it % 32 * 4;
#pragma unroll
      for (int u = 0; u < PB; ++u)
        v[i][u] = ldcg4i(ws + ((size_t)(q0 + u) * M + m) * N + n,
                         m < M && q0 + u < parts ? N - n : 0, v4);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int u = 0; u < PB; ++u)
        if (q0 + u < parts)
          y[i].x += v[i][u].x, y[i].y += v[i][u].y, y[i].z += v[i][u].z, y[i].w += v[i][u].w;
  }
  if (tid == 0 && seen < xa_blocks) {
    const volatile int* count = sem;
    while (*count < xa_blocks) __nanosleep(128);
  }
  __syncthreads();
  __threadfence();
  auto stage_xa = [&](int r0) {
    for (int i = 0; i < NT; ++i) {  // M * kGemvMmaRanks <= NT * kGemvThreads
      const int p = tid + i * kGemvThreads;
      const int m = p / kGemvMmaRanks, r = r0 + p % kGemvMmaRanks;
      float sum = 0.f;
      for (int q0 = 0; q0 < G; q0 += kGemvXaInFlight) {
        float v[kGemvXaInFlight];
#pragma unroll
        for (int q = 0; q < kGemvXaInFlight; ++q)
          v[q] = m < M && r < R && q0 + q < G
                     ? __ldcg(xa + ((size_t)(q0 + q) * M + m) * R + r) : 0.f;
#pragma unroll
        for (int q = 0; q < kGemvXaInFlight; ++q)
          if (q0 + q < G) sum += v[q];
      }
      if (m < M) xa_s[p] = __fmul_rn(sum, xs_s[m]);
    }
  };
  stage_xa(0);
  float4 low[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) low[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < R; r0 += kGemvMmaRanks) {
    if (r0 > 0) {
      stage_b(r0);
      stage_xa(r0);
    }
    cp_async_wait<0>();
    __syncthreads();
    const int rs = min(kGemvMmaRanks, R - r0);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int it = tid + i * kGemvThreads, m = it / 32, c = it % 32 * 4;
      if (m >= M) continue;
      for (int r = 0; r < rs; ++r) {
        const float xv = xa_s[m * kGemvMmaRanks + r];
        const float4 bv = *reinterpret_cast<const float4*>(b_s + r * kGemvMmaN + c);
        low[i].x = fmaf(xv, bv.x, low[i].x), low[i].y = fmaf(xv, bv.y, low[i].y);
        low[i].z = fmaf(xv, bv.z, low[i].z), low[i].w = fmaf(xv, bv.w, low[i].w);
      }
    }
    __syncthreads();  // b_s and xa_s are free for the next ranks
  }
  // gamma * (f32(acc) * xs * scale + low), each operation rounded alone
  auto epilogue = [&](int sum, float s, int c, float lo) {
    const float v = __fmul_rn(__fmul_rn((float)sum, s), sg_s[c]);
    return __fmul_rn(__fadd_rn(v, lo), sg_s[kGemvMmaN + c]);
  };
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int it = tid + i * kGemvThreads, m = it / 32, c = it % 32 * 4, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float s = xs_s[m];
    const float o[4] = {epilogue(y[i].x, s, c, low[i].x), epilogue(y[i].y, s, c + 1, low[i].y),
                        epilogue(y[i].z, s, c + 2, low[i].z),
                        epilogue(y[i].w, s, c + 3, low[i].w)};
    float* dst = out + (size_t)m * N + n;
    if (v4 && n + 3 < N) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) dst[e] = o[e];
    }
  }
  // every XA read of this block is done: the last strip resets sem[0]
  if (tid == 0 && atomicAdd(sem, 1) == xa_blocks + strips - 1) atomicExch(sem, 0);
}

// ---------------------------------------------------------------------------
// f32 x at narrow N (the MoE routers): one split-K launch, both launchers
// ---------------------------------------------------------------------------

// The f32 body with f32 x at N <= kNarrowMaxN (autotune.NARROW_MAX_N): every
// router of the zoo (mixtral-8x22b K 6144 N 8, deepseek-v2-lite K 2048 N
// 64). It computes what repro/kernels/dora_linear.py::_kernel computes,
// y = gamma * (scale * X @ (G+ - G-) + (X @ A) @ B), for either launcher.
//
// What bounds it. Nothing that scales: the work is 0.3-2.6 MB and at most a
// few MFLOP, a bound of 0.1-0.8 us. The SIMT bodies it replaces here held all
// of K in one block (the GEMV's 16- or 32-column strips, the tiled body's
// 128 x 128 tile, each one block at N = 8) behind a prologue launch: one SM
// walked K in hundreds of dependent steps. What is left is latency: the
// launch, a memory round trip, and the reduction across blocks.
//
// Design:
// * The grid is (parts of K) x (tiles of kNarrowM rows of x). A block owns
//   all N columns and all R ranks of its tile, so its slice of the codes
//   (rows x N bytes) and of A (rows x R floats) is one contiguous run of
//   memory, and it computes X @ [G+ - G- | A], N + R columns, in one pass:
//   no prologue, x read from memory once. Parts are whole slabs of
//   kNarrowSlab rows (autotune.narrow_plan: a wave of two blocks an SM).
// * A ring of kNarrowStages stages of kNarrowK rows (a whole slab and one
//   stage ahead) is filled by 16-byte cp.async copies where the operands
//   allow (N % 4, R % 4, K % 4 == 0 and 16-byte aligned; the codes' last
//   run zero-filled by the copy's source size), else by masked scalar loads;
//   both zero-fill past M, N, R and K. Nothing is padded in memory.
// * Work units are 4 rows x 4 columns (16 accumulators; codes turned into
//   f32 weights exactly by code_diff as they are read from shared memory).
//   Units over the live rows of the tile and the column groups (N, then R,
//   each rounded up to 4) share the block's threads; when they are fewer
//   than the threads, a power of two of lanes (at most 32, neighbouring
//   threads) split each stage's rows, row k to lane k % lanes, and at the
//   end of each slab a butterfly of warp shuffles adds the lanes (lane 0's
//   order), whose sum goes to ws[slab].
// * The last block of a row tile to finish (a ticket in sem[tile], which it
//   resets) adds the slabs' sums: one thread a chunk of kNarrowChunk slabs
//   (16-byte loads, all of the chunk in flight), then the chunks in order,
//   while B, scale and gamma are copied in; then the epilogue in the
//   reference's order, (acc * scale + XA @ B) * gamma. The order of every
//   f32 sum depends on the shape alone, not on the parts, and no data goes
//   through atomics: the result is bitwise the same across launches, plans
//   and graph replays.
// Measured on the H100 (tools/narrow_costs.py, PERF.md), a call at 1-4 rows
// takes 8.1-8.4 us, a chain: ~1 us each for the launch and the ticket,
// ~1.5 for the last block, ~2 for the products with the lanes' sums and
// ~2.7 for the copies, whose one memory round trip a block cannot overlap.
constexpr int kNarrowThreads = 256;
constexpr int kNarrowMaxN = 64;    // autotune.NARROW_MAX_N
constexpr int kNarrowM = 16;       // rows of x a block (autotune.NARROW_ROWS)
constexpr int kNarrowK = 32;       // rows of K a stage
constexpr int kNarrowSlab = 128;   // rows of K a sum in ws (autotune.MIN_SPLIT_ROWS)
constexpr int kNarrowStages = 5;   // stages of the ring
constexpr int kNarrowXS = kNarrowK + 4;  // x tile row stride, floats
constexpr int kNarrowLanes = kNarrowK;  // threads over one unit's rows, at most
constexpr int kNarrowUnits = 3;    // units a thread holds at most
constexpr int kNarrowChunk = 8;    // slabs of K a thread of the last block adds
static_assert((kNarrowM / 4) * (kNarrowMaxN + 256) / 4 <= kNarrowUnits * kNarrowThreads,
              "units of a tile at N = kNarrowMaxN and R = 256");
static_assert(kNarrowSlab % kNarrowK == 0 && kNarrowStages > kNarrowSlab / kNarrowK, "ring");
// the operands the copies may take 16 bytes at a time (the `vec` mask)
constexpr int kVecCodes = 1, kVecA = 2, kVecX = 4;

// 16 bytes global -> shared, asynchronously, of which the first `bytes`
// (0..16) are read and the rest zero-filled
__device__ __forceinline__ void cp_async16n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// bytes of one stage of the ring: the x tile, the A slice and both code
// slices (np, rp: N and R rounded up to 4)
__host__ __device__ __forceinline__ int narrow_stage_bytes(int np, int rp) {
  return kNarrowM * kNarrowXS * 4 + kNarrowK * rp * 4 + 2 * kNarrowK * np;
}

__global__ void __launch_bounds__(kNarrowThreads)
    dora_narrow_kernel(const float* __restrict__ x, const uint8_t* __restrict__ gp,
                       const uint8_t* __restrict__ gn, const float* __restrict__ scale,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ gamma, float* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ sem, int M, int K, int N,
                       int R, int vec) {
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int last;
  const int tid = threadIdx.x;
  const int NP = (N + 3) & ~3, RP = (R + 3) & ~3, CP = NP + RP, CG = CP / 4;
  const int XB = kNarrowM * kNarrowXS * 4, AB = kNarrowK * RP * 4, CB = kNarrowK * NP;
  const int SB = narrow_stage_bytes(NP, RP);

  const int tile = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const int m0 = tile * kNarrowM, rows = min(kNarrowM, M - m0);
  const int RG = (rows + 3) / 4, U = RG * CG;  // units: (row group, column group)
  const int slabs = (K + kNarrowSlab - 1) / kNarrowSlab;
  const int sb = part * slabs / parts, se = (part + 1) * slabs / parts;
  const int kb = sb * kNarrowSlab, ke = min(K, se * kNarrowSlab);
  const int T = (ke - kb + kNarrowK - 1) / kNarrowK;  // stages of this part
  // lanes: a power of two, the most that fit the threads (at most one row of
  // a stage each); a unit's lanes are neighbouring threads of one warp
  // wide: more units than threads; a thread then takes up to kNarrowUnits, one lane
  const bool wide = U > kNarrowThreads;
  int lanes = 1;
  while (!wide && 2 * lanes <= kNarrowLanes && 2 * lanes * U <= kNarrowThreads) lanes *= 2;
  const int lane = tid % lanes, unit0 = wide ? tid : tid / lanes;
  const size_t wstride = (size_t)M * CP;  // floats of one slab's sums

  // stage j of the part into slot j % kNarrowStages (an empty group past T)
  auto load_stage = [&](int j) {
    if (j < T) {
      unsigned char* st = smem + (j % kNarrowStages) * SB;
      float* xs = reinterpret_cast<float*>(st);
      float* as = reinterpret_cast<float*>(st + XB);
      uint8_t* ps = st + XB + AB;
      uint8_t* ns = ps + CB;
      const int k0 = kb + j * kNarrowK, kr = min(kNarrowK, ke - k0);
      // x: the tile's rows [0, 4 RG), zeros past M and past K
      if (vec & kVecX) {
        for (int p = tid; p < 4 * RG * (kNarrowK / 4); p += kNarrowThreads) {
          const int i = p / (kNarrowK / 4), c = p % (kNarrowK / 4) * 4;
          const bool in = i < rows && c < kr;
          cp_async16(xs + i * kNarrowXS + c, in ? x + (size_t)(m0 + i) * K + k0 + c : x, in);
        }
      } else {
        for (int p = tid; p < 4 * RG * kNarrowK; p += kNarrowThreads) {
          const int i = p / kNarrowK, c = p % kNarrowK;
          xs[i * kNarrowXS + c] = i < rows && c < kr ? x[(size_t)(m0 + i) * K + k0 + c] : 0.f;
        }
      }
      // A: kr rows of R ranks (RP == R where copied as one run)
      if (vec & kVecA) {
        const int bytes = kr * R * 4;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(a + (size_t)k0 * R);
        for (int o = tid * 16; o < AB; o += kNarrowThreads * 16)
          cp_async16(st + XB + o, o < bytes ? src + o : src, o < bytes);
      } else {
        for (int p = tid; p < kNarrowK * RP; p += kNarrowThreads) {
          const int r = p / RP, c = p % RP;
          as[p] = r < kr && c < R ? a[(size_t)(k0 + r) * R + c] : 0.f;
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

  for (int j = 0; j < kNarrowStages - 1; ++j) load_stage(j);
  for (int j = 0; j < T; ++j) {
    cp_async_wait<kNarrowStages - 2>();  // stage j landed
    __syncthreads();                     // and every thread is done with stage j - 1
    load_stage(j + kNarrowStages - 1);
    const unsigned char* st = smem + (j % kNarrowStages) * SB;
    const float* xs = reinterpret_cast<const float*>(st);
    const float* as = reinterpret_cast<const float*>(st + XB);
    const uint8_t* ps = st + XB + AB;
    const uint8_t* ns = ps + CB;
    // lane l takes the slab's rows l, l + lanes, ...: here the stage's rows
    // kk = l, l + lanes, ... (a stage starts a multiple of 32 rows in)
#pragma unroll
    for (int t = 0; t < kNarrowUnits; ++t) {
      const int u = unit0 + t * kNarrowThreads;
      if ((t > 0 && !wide) || u >= U) break;
      const int rg = u / CG, cg = u - rg * CG;
      const bool codes = 4 * cg < NP;
      for (int kk = lane; kk < kNarrowK; kk += lanes) {
        float w[4];
        if (codes) {
          const uint32_t p = *reinterpret_cast<const uint32_t*>(ps + kk * NP + 4 * cg);
          const uint32_t n = *reinterpret_cast<const uint32_t*>(ns + kk * NP + 4 * cg);
#pragma unroll
          for (int c = 0; c < 4; ++c) w[c] = code_diff(p, n, c);
        } else {
          const float4 v = *reinterpret_cast<const float4*>(as + kk * RP + 4 * cg - NP);
          w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[(4 * rg + i) * kNarrowXS + kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t][i][c] = fmaf(xv, w[c], acc[t][i][c]);
        }
      }
    }
    if ((j + 1) % (kNarrowSlab / kNarrowK) != 0 && j != T - 1) continue;
    // slab s ends here: its sums, the lanes added by a butterfly over each
    // unit's neighbouring threads (lane 0's order), to ws[s]
    float* wsl = ws + (size_t)(sb + j / (kNarrowSlab / kNarrowK)) * wstride + (size_t)m0 * CP;
    if (lanes > 1) {
      for (int off = lanes / 2; off > 0; off /= 2)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[0][i][c] += __shfl_xor_sync(0xffffffffu, acc[0][i][c], off);
    }
#pragma unroll
    for (int t = 0; t < kNarrowUnits; ++t) {
      const int u = unit0 + t * kNarrowThreads;
      if ((t > 0 && !wide) || u >= U || lane != 0) break;
      const int rg = u / CG, cg = u - rg * CG;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * rg + i < rows)
          *reinterpret_cast<float4*>(wsl + (4 * rg + i) * CP + 4 * cg) =
              make_float4(acc[t][i][0], acc[t][i][1], acc[t][i][2], acc[t][i][3]);
    }
#pragma unroll
    for (int t = 0; t < kNarrowUnits; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[t][i][c] = 0.f;
  }
  cp_async_wait<0>();  // only empty groups are left

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(sem + tile, 1) == parts - 1;
    if (last) atomicExch(sem + tile, 0);  // every part of the tile has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The tile's last block (the ring is idle: its operands take its place).
  // B, scale and gamma are copied in while the slabs' sums are read, four
  // columns a load: each chunk of kNarrowChunk slabs is added in slab order
  // by one thread, then the chunks in chunk order (an order fixed by K
  // alone), as many chunks at a time as the space holds; then the epilogue
  const int G = rows * CP / 4;              // groups of 4 sums of the tile
  float4* tot = reinterpret_cast<float4*>(smem_f);   // [G]
  float* bs = smem_f + kNarrowM * CP;                // B, [R][N]
  float* sg = bs + R * N;                            // scale [N], gamma [N]
  float4* chunk = reinterpret_cast<float4*>(smem_f + ((kNarrowM * CP + R * N + 2 * N + 3) & ~3));
  const int room = (kNarrowStages * SB / 4 - (int)(reinterpret_cast<float*>(chunk) - smem_f)) /
                   (4 * G);                // chunks the space holds at once
  for (int p = tid; p < R * N; p += kNarrowThreads) cp_async4(bs + p, b + p, true);
  for (int p = tid; p < 2 * N; p += kNarrowThreads)
    cp_async4(sg + p, p < N ? scale + p : gamma + p - N, true);
  cp_async_commit();
  const int chunks = (slabs + kNarrowChunk - 1) / kNarrowChunk;
  const float4* src = reinterpret_cast<const float4*>(ws + (size_t)m0 * CP);
  const size_t step = wstride / 4;
  for (int c0 = 0; c0 < chunks; c0 += room) {
    const int nc = min(room, chunks - c0);
    for (int w = tid; w < nc * G; w += kNarrowThreads) {
      const int c = c0 + w / G, g = w - (w / G) * G;
      const int s0 = c * kNarrowChunk, sn = min(kNarrowChunk, slabs - s0);
      float4 v[kNarrowChunk];
#pragma unroll
      for (int q = 0; q < kNarrowChunk; ++q)
        v[q] = q < sn ? __ldcg(src + (size_t)(s0 + q) * step + g) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y = v[0];
#pragma unroll
      for (int q = 1; q < kNarrowChunk; ++q)
        if (q < sn) y.x += v[q].x, y.y += v[q].y, y.z += v[q].z, y.w += v[q].w;
      chunk[w] = y;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kNarrowThreads) {
      float4 y = c0 == 0 ? chunk[g] : tot[g];
      for (int c = c0 == 0 ? 1 : 0; c < nc; ++c) {
        const float4 v = chunk[c * G + g];
        y.x += v.x, y.y += v.y, y.z += v.z, y.w += v.w;
      }
      tot[g] = y;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  const float* t = smem_f;  // tot as [rows][CP]
  for (int p = tid; p < rows * N; p += kNarrowThreads) {
    const int m = p / N, n = p - m * N;
    float low = 0.f;
    for (int r = 0; r < R; ++r) low = fmaf(t[m * CP + NP + r], bs[r * N + n], low);
    out[(size_t)(m0 + m) * N + n] = (t[m * CP + n] * sg[n] + low) * sg[N + n];
  }
}

// ---------------------------------------------------------------------------
// host-side launch helpers
// ---------------------------------------------------------------------------

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int prep_chunks(int K) { return (K + kPrepRows - 1) / kPrepRows; }

// the operands of one call, as the main kernels take them: x the
// activations, xt the SIMT GEMV's X^T, xq/xs the int8 body's s8 x (tiled
// launcher) and row scales
struct Ops {
  const void *x, *xt, *xq, *xs, *gp, *gn, *scale, *b, *gamma, *xa;
  void* out;
  int M, K, N, R;
};

// the prologue of the SIMT bodies (f32 x, f32 body): the XA partials and,
// for the GEMV (xt not null), X^T
cudaError_t launch_prep(const void* x, const void* a, void* xa, void* xt, int M, int K, int R,
                        int rows, cudaStream_t s) {
  const dim3 grid(xt != nullptr ? (M > rows ? M : rows) : M, prep_chunks(K));
  prep_kernel<<<grid, kPrepThreads, 0, s>>>((const float*)x, (const float*)a, (float*)xa,
                                             (float*)xt, M, K, R, rows);
  return cudaGetLastError();
}

template <int MT, int CPT, int COLS, int U, bool VEC>
cudaError_t launch_gemv_main(const Ops& o, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)MT * COLS + (size_t)o.M * o.R);
  auto kernel = dora_gemv_kernel<MT, CPT, COLS, U, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((o.N + COLS - 1) / COLS);
  kernel<<<grid, kGemvThreads, smem, s>>>(
      (const float*)o.xt, (const uint8_t*)o.gp, (const uint8_t*)o.gn, (const float*)o.scale,
      (const float*)o.b, (const float*)o.gamma, (const float*)o.xa, (float*)o.out, o.M, o.K,
      o.N, o.R, prep_chunks(o.K));
  return cudaGetLastError();
}

// Up to 4 rows (decode ticks) the kernel is bound by the code stream:
// 32-column strips (full 32-byte sectors), 4 rows in flight. From 8 rows
// (admission chunks) the work per code byte grows, so the strips narrow
// to 16 columns (twice the blocks, more SMs busy) with 8 rows in flight
// to keep the loads ahead of the arithmetic.
template <int MT, int CPT>
cudaError_t gemv_vec(const Ops& o, cudaStream_t s) {
  constexpr int COLS = MT <= 4 ? 32 : 16;
  constexpr int U = MT <= 4 ? 4 : 8;
  const bool vec = o.N % CPT == 0 && aligned(o.gp, CPT) && aligned(o.gn, CPT);
  return vec ? launch_gemv_main<MT, CPT, COLS, U, true>(o, s)
             : launch_gemv_main<MT, CPT, COLS, U, false>(o, s);
}

cudaError_t gemv_rows(int rows, const Ops& o, cudaStream_t s) {
  switch (rows) {
    case 1: return gemv_vec<1, 16>(o, s);
    case 2: return gemv_vec<2, 16>(o, s);
    case 4: return gemv_vec<4, 16>(o, s);
    case 8: return gemv_vec<8, 8>(o, s);
    case 16: return gemv_vec<16, 4>(o, s);
    case 32: return gemv_vec<32, 2>(o, s);
    case 64: return gemv_vec<64, 1>(o, s);
    default: return cudaErrorInvalidValue;
  }
}

// the tensor-core GEMV (bf16 x, f32 body), NT tiles of 8 rows: one launch,
// the X @ A blocks first (at most kGemvXaChunks chunks of K per 16 rows of x)
template <int NT>
cudaError_t launch_gemv_mma(const void* x, const void* a, const Ops& o, void* ws, void* sem,
                            int parts, cudaStream_t s) {
  constexpr int smem = GemvMmaSmem<NT>::BYTES;
  const bool vec = o.N % 16 == 0 && aligned(o.gp, 16) && aligned(o.gn, 16) && o.K % 8 == 0 &&
                   aligned(x, 16);
  auto kernel = vec ? dora_gemv_mma_kernel<NT, true> : dora_gemv_mma_kernel<NT, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int slabs = prep_chunks(o.K);
  const int sub = (slabs + kGemvXaChunks - 1) / kGemvXaChunks;  // slabs per chunk
  const int G = (slabs + sub - 1) / sub;
  const int xa_blocks = (o.M + kPrepRowTile - 1) / kPrepRowTile * G;
  const int strips = (o.N + kGemvMmaN - 1) / kGemvMmaN;
  kernel<<<xa_blocks + strips * parts, kGemvThreads, smem, s>>>(
      (const __nv_bfloat16*)x, (const float*)a, (const uint8_t*)o.gp, (const uint8_t*)o.gn,
      (const float*)o.scale, (const float*)o.b, (const float*)o.gamma, (float*)o.out,
      (float*)ws, (float*)o.xa, (int*)sem, o.M, o.K, o.N, o.R, parts, G, sub);
  return cudaGetLastError();
}

// the int8 tensor-core GEMV for x of type TX, NT tiles of 8 rows: one
// launch (the X @ A blocks first, as launch_gemv_mma's), after the row
// scales' own pass where `prescale`
template <int NT, typename TX>
cudaError_t launch_gemv_int8(const void* a, const Ops& o, void* ws, void* sem, int parts,
                             bool prescale, cudaStream_t s) {
  constexpr int smem = GemvInt8Smem<NT, TX>::BYTES;
  const bool vec = o.N % 16 == 0 && aligned(o.gp, 16) && aligned(o.gn, 16) &&
                   o.K % (16 / (int)sizeof(TX)) == 0 && aligned(o.x, 16);
  auto kernel = vec ? dora_gemv_int8_kernel<NT, true, TX> : dora_gemv_int8_kernel<NT, false, TX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (prescale) {
    row_scale_kernel<TX><<<o.M, kPrepThreads, 0, s>>>((const TX*)o.x, (float*)o.xs, o.K);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // at most kGemvXaChunks X @ A blocks in all (chunks of K times tiles of
  // 16 rows of x), so that from 32 rows up they leave the wave to the codes
  const int XT = (o.M + kPrepRowTile - 1) / kPrepRowTile;
  const int slabs = prep_chunks(o.K), chunks = kGemvXaChunks / XT;
  const int sub = (slabs + chunks - 1) / chunks;  // slabs per chunk
  const int G = (slabs + sub - 1) / sub;
  const int strips = (o.N + kGemvMmaN - 1) / kGemvMmaN;
  kernel<<<XT * G + strips * parts, kGemvThreads, smem, s>>>(
      (const TX*)o.x, prescale ? (const float*)o.xs : nullptr, (const float*)a,
      (const uint8_t*)o.gp, (const uint8_t*)o.gn, (const float*)o.scale, (const float*)o.b,
      (const float*)o.gamma, (float*)o.out, (int*)ws, (float*)o.xa, (int*)sem, o.M, o.K, o.N,
      o.R, parts, G, sub);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t gemv_int8_rows(int rows, const void* a, const Ops& o, void* ws, void* sem,
                           int parts, bool prescale, cudaStream_t s) {
  switch (rows) {
    case 1: case 2: case 4: case 8:
      return launch_gemv_int8<1, TX>(a, o, ws, sem, parts, prescale, s);
    case 16: return launch_gemv_int8<2, TX>(a, o, ws, sem, parts, prescale, s);
    case 32: return launch_gemv_int8<4, TX>(a, o, ws, sem, parts, prescale, s);
    case 64: return launch_gemv_int8<8, TX>(a, o, ws, sem, parts, prescale, s);
    default: return cudaErrorInvalidValue;
  }
}

// the SIMT tiled body (f32 x, f32 body), after its prologue
cudaError_t launch_tiled(const Ops& o, cudaStream_t s) {
  const dim3 grid((o.N + kTileN - 1) / kTileN, (o.M + kTileM - 1) / kTileM);
  const bool vec = o.N % 4 == 0 && aligned(o.gp, 4) && aligned(o.gn, 4);
  auto kernel = vec ? dora_tiled_kernel<true> : dora_tiled_kernel<false>;
  kernel<<<grid, kTileThreads, 0, s>>>(
      (const float*)o.x, (const uint8_t*)o.gp, (const uint8_t*)o.gn, (const float*)o.scale,
      (const float*)o.b, (const float*)o.gamma, (const float*)o.xa, (float*)o.out, o.M, o.K,
      o.N, o.R, prep_chunks(o.K));
  return cudaGetLastError();
}

// the narrow body (f32 x, f32 body, N <= kNarrowMaxN): one launch, a block
// per (part of K, tile of kNarrowM rows); the ring, then the lanes' sums
cudaError_t launch_narrow(const void* x, const void* a, const Ops& o, void* ws, void* sem,
                          int parts, cudaStream_t s) {
  const int np = (o.N + 3) & ~3, rp = (o.R + 3) & ~3;
  const int smem = kNarrowStages * narrow_stage_bytes(np, rp);
  cudaError_t e =
      cudaFuncSetAttribute(dora_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int vec = (o.N % 4 == 0 && aligned(o.gp, 16) && aligned(o.gn, 16) ? kVecCodes : 0) |
                  (o.R % 4 == 0 && aligned(a, 16) ? kVecA : 0) |
                  (o.K % 4 == 0 && aligned(x, 16) ? kVecX : 0);
  const dim3 grid(parts, (o.M + kNarrowM - 1) / kNarrowM);
  dora_narrow_kernel<<<grid, kNarrowThreads, smem, s>>>(
      (const float*)x, (const uint8_t*)o.gp, (const uint8_t*)o.gn, (const float*)o.scale,
      (const float*)a, (const float*)o.b, (const float*)o.gamma, (float*)o.out, (float*)ws,
      (int*)sem, o.M, o.K, o.N, o.R, vec);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, bool VEC, bool INT8>
cudaError_t launch_mma_tile(const Ops& o, int k_split, void* ws, cudaStream_t s) {
  using T = typename Num<INT8>::T;
  constexpr int smem = MmaSmem<BM, BN, BK, INT8>::BYTES;
  auto kernel = dora_mma_kernel<BM, BN, BK, VEC, INT8>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int splits = (o.K + k_split - 1) / k_split;
  const dim3 grid((o.M + BM - 1) / BM, (o.N + BN - 1) / BN, splits);
  kernel<<<grid, kMmaThreads, smem, s>>>(
      INT8 ? o.xq : o.x, (const float*)o.xs, (const uint8_t*)o.gp, (const uint8_t*)o.gn,
      (const float*)o.scale, (const float*)o.b, (const float*)o.gamma, (const float*)o.xa,
      (float*)o.out, (T*)ws, o.M, o.K, o.N, o.R, k_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  splitk_epilogue_kernel<INT8>
      <<<dim3(o.M, (o.N + kPrepThreads - 1) / kPrepThreads), kPrepThreads, 0, s>>>(
          (const T*)ws, (const float*)o.xs, (const float*)o.scale, (const float*)o.b,
          (const float*)o.gamma, (const float*)o.xa, (float*)o.out, o.M, o.N, o.R, splits);
  return cudaGetLastError();
}

template <int BK, bool INT8>
cudaError_t launch_mma_tiles(const Ops& o, int bm, bool vec, int k_split, void* ws,
                             cudaStream_t s) {
  if (bm == 64)
    return vec ? launch_mma_tile<64, kMmaN, BK, true, INT8>(o, k_split, ws, s)
               : launch_mma_tile<64, kMmaN, BK, false, INT8>(o, k_split, ws, s);
  return vec ? launch_mma_tile<128, kMmaN, BK, true, INT8>(o, k_split, ws, s)
             : launch_mma_tile<128, kMmaN, BK, false, INT8>(o, k_split, ws, s);
}

// the int8 tensor-core body's prologue: the row scales xs, then xq and the
// XA partials over the grid of prep_tile_kernel
template <typename TX>
void int8_prologue(const Ops& o, const void* a, dim3 grid, cudaStream_t s) {
  row_scale_kernel<TX><<<o.M, kPrepThreads, 0, s>>>((const TX*)o.x, (float*)o.xs, o.K);
  prep_tile_kernel<TX, true><<<grid, kPrepThreads, 0, s>>>(
      (const TX*)o.x, (const float*)o.xs, (const float*)a, (float*)o.xa, (int8_t*)o.xq, o.M,
      o.K, o.R);
}

// a tensor-core body: its prologue, then BM x BN x BK tiles
// (autotune.tiled_tiles) with K split into parts of k_split rows; ws:
// (splits, M, N) f32 (int8: int32) scratch, null for one split
cudaError_t launch_mma(const Ops& o, const void* a, bool x_bf16, bool int8, int bm,
                       int k_split, void* ws, cudaStream_t s) {
  const int bk = int8 ? kMmaKInt8 : kMmaK;
  if ((bm != 64 && bm != 128) || k_split < bk || k_split % bk != 0)
    return cudaErrorInvalidValue;
  if ((o.K > k_split) != (ws != nullptr)) return cudaErrorInvalidValue;
  // int8: the row scales; then the XA partials (int8: with xq), then XA
  // itself (after the partials in the scratch)
  const int G = prep_chunks(o.K), MR = o.M * o.R;
  float* xa = (float*)o.xa + (size_t)G * MR;
  const dim3 grid((o.M + kPrepRowTile - 1) / kPrepRowTile, G);
  if (int8 && x_bf16)
    int8_prologue<__nv_bfloat16>(o, a, grid, s);
  else if (int8)
    int8_prologue<float>(o, a, grid, s);
  else
    prep_tile_kernel<__nv_bfloat16, false><<<grid, kPrepThreads, 0, s>>>(
        (const __nv_bfloat16*)o.x, nullptr, (const float*)a, (float*)o.xa, nullptr, o.M, o.K,
        o.R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  xa_finish_kernel<<<(MR + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0, s>>>(
      (const float*)o.xa, xa, MR, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  Ops m = o;
  m.xa = xa;
  const bool codes16 = o.N % 16 == 0 && aligned(o.gp, 16) && aligned(o.gn, 16);
  if (int8)
    return launch_mma_tiles<kMmaKInt8, true>(
        m, bm, codes16 && o.K % 16 == 0 && aligned(o.xq, 16), k_split, ws, s);
  return launch_mma_tiles<kMmaK, false>(
      m, bm, codes16 && o.K % 8 == 0 && aligned(o.x, 16), k_split, ws, s);
}

}  // namespace

extern "C" {

// x: (M, K) f32 (x_bf16 == 0) or bf16; gp, gn: (K, N) u8; scale, gamma:
// (N,) f32; a: (K, R) f32; b: (R, N) f32; out: (M, N) f32; xa: f32
// scratch of rimc_xa_scratch(M, K, R) floats; the int8 body also takes xs,
// an (M,) f32 scratch for the row scales. All contiguous, on the current
// device, 1 <= R <= 256.

// (the tensor-core body keeps XA itself after the partials)
int rimc_xa_scratch(int M, int K, int R) { return (prep_chunks(K) + 1) * M * R; }

// The SIMT GEMV, f32 x with the f32 body: x (M, K) f32; xt: (K, rows) f32
// scratch for X^T; rows: the row bucket, a power of two in [M, 64]
int rimc_dora_linear_gemv(const void* x, const void* gp, const void* gn, const void* scale,
                          const void* a, const void* b, const void* gamma, void* out,
                          void* xa, void* xt, int M, int K, int N, int R, int rows,
                          void* stream) {
  if (M < 1 || M > rows || K < 1 || N < 1 || R < 1 || R > kPrepThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch_prep(x, a, xa, xt, M, K, R, rows, s);
  if (e != cudaSuccess) return (int)e;
  const Ops o{x, xt, nullptr, nullptr, gp, gn, scale, b, gamma, xa, out, M, K, N, R};
  return (int)gemv_rows(rows, o, s);
}

// The f32 body with bf16 x: x (M, K) bf16; xa: rimc_xa_scratch(M, K, R)
// floats (the X @ A partials); ws: a (parts, M, N) f32 scratch; sem:
// rimc_gemv_mma_sems(N) ints, all zero, which the launch leaves all zero
// (launches sharing sem must not overlap); rows: the row bucket, a power
// of two in [M, 64]; parts: the parts of K, 1 <= parts <= the stages of
// kGemvMmaK rows in K (autotune.gemv_plan).
int rimc_gemv_mma_sems(int N) { return 1 + (N + kGemvMmaN - 1) / kGemvMmaN; }

// *id: the id of the CUDA graph capture running on stream, 0 when none
// is, so that each captured graph can hold tickets of its own
int rimc_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  *id = 0;
  const cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  if (e == cudaSuccess && status != cudaStreamCaptureStatusActive) *id = 0;
  return (int)e;
}

int rimc_dora_linear_gemv_mma(const void* x, const void* gp, const void* gn,
                              const void* scale, const void* a, const void* b,
                              const void* gamma, void* out, void* xa, void* ws, void* sem,
                              int M, int K, int N, int R, int rows, int parts, void* stream) {
  if (M < 1 || M > rows || K < 1 || N < 1 || R < 1 || R > kPrepThreads || parts < 1 ||
      parts > (K + kGemvMmaK - 1) / kGemvMmaK)
    return (int)cudaErrorInvalidValue;
  const Ops o{x, nullptr, nullptr, nullptr, gp, gn, scale, b, gamma, xa, out, M, K, N, R};
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1: case 2: case 4: case 8: return (int)launch_gemv_mma<1>(x, a, o, ws, sem, parts, s);
    case 16: return (int)launch_gemv_mma<2>(x, a, o, ws, sem, parts, s);
    case 32: return (int)launch_gemv_mma<4>(x, a, o, ws, sem, parts, s);
    case 64: return (int)launch_gemv_mma<8>(x, a, o, ws, sem, parts, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The int8 body: x (M, K) f32 (x_bf16 == 0) or bf16; xa: rimc_xa_scratch(M,
// K, R) floats (the Xq @ A partials); xs: (M,) f32 scratch for the row
// scales, written only where prescale (a pass before the kernel, which
// then reads them; else every block takes them itself); ws: a (parts, M, N)
// int32 scratch; sem: rimc_gemv_mma_sems(N) ints, all zero, which the
// launch leaves all zero (launches sharing sem must not overlap); rows and
// parts as for rimc_dora_linear_gemv_mma (autotune.gemv_plan(m, n, k,
// "int8")).
int rimc_dora_linear_gemv_int8(const void* x, int x_bf16, const void* gp, const void* gn,
                               const void* scale, const void* a, const void* b,
                               const void* gamma, void* out, void* xa, void* xs, void* ws,
                               void* sem, int M, int K, int N, int R, int rows, int parts,
                               int prescale, void* stream) {
  if (M < 1 || M > rows || K < 1 || N < 1 || R < 1 || R > kPrepThreads || parts < 1 ||
      parts > (K + kGemvMmaK - 1) / kGemvMmaK || (prescale && xs == nullptr))
    return (int)cudaErrorInvalidValue;
  const Ops o{x, nullptr, nullptr, xs, gp, gn, scale, b, gamma, xa, out, M, K, N, R};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(x_bf16 ? gemv_int8_rows<__nv_bfloat16>(rows, a, o, ws, sem, parts, prescale, s)
                      : gemv_int8_rows<float>(rows, a, o, ws, sem, parts, prescale, s));
}

// The f32 body with f32 x at narrow N, either launcher: x (M, K) f32,
// N <= kNarrowMaxN; ws: a (ceil(K / kNarrowSlab), M, NP + RP) f32 scratch
// (NP, RP: N and R rounded up to a multiple of 4); sem: ceil(M / kNarrowM)
// ints, all zero, which the launch leaves all zero (launches sharing sem
// must not overlap); parts: the parts of K, 1 <= parts <= ceil(K /
// kNarrowSlab) (autotune.narrow_plan).
int rimc_dora_linear_narrow(const void* x, const void* gp, const void* gn, const void* scale,
                            const void* a, const void* b, const void* gamma, void* out,
                            void* ws, void* sem, int M, int K, int N, int R, int parts,
                            void* stream) {
  if (M < 1 || K < 1 || N < 1 || N > kNarrowMaxN || R < 1 || R > kPrepThreads || parts < 1 ||
      parts > (K + kNarrowSlab - 1) / kNarrowSlab)
    return (int)cudaErrorInvalidValue;
  const Ops o{x, nullptr, nullptr, nullptr, gp, gn, scale, b, gamma, nullptr, out, M, K, N, R};
  return (int)launch_narrow(x, a, o, ws, sem, parts, (cudaStream_t)stream);
}

// xq: (M, K) s8 scratch for the int8 body (null for f32). The int8 body,
// and the f32 body with bf16 x, run a tensor-core body with bm x kMmaN
// tiles (bm 64 or 128) and K split into parts of k_split
// rows (a multiple of the body's kMmaK or kMmaKInt8); ws: a
// (ceil(K / k_split), M, N) scratch (f32; int32 for the int8 body) when
// there is more than one part, else null. f32 x with the f32 body runs
// the SIMT body and ignores bm, k_split and ws.
int rimc_dora_linear_tiled(const void* x, int x_bf16, const void* gp,
                           const void* gn, const void* scale, const void* a,
                           const void* b, const void* gamma, void* out, void* xa,
                           void* xq, void* xs, void* ws, int M, int K, int N, int R,
                           int int8, int bm, int k_split, void* stream) {
  if (M < 1 || K < 1 || N < 1 || R < 1 || R > kPrepThreads ||
      (int8 && (xq == nullptr || xs == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Ops o{x, nullptr, xq, xs, gp, gn, scale, b, gamma, xa, out, M, K, N, R};
  if (int8 || x_bf16) return (int)launch_mma(o, a, x_bf16, int8, bm, k_split, ws, s);
  cudaError_t e = launch_prep(x, a, xa, nullptr, M, K, R, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tiled(o, s);
}

}  // extern "C"
