// Fused RIMC-DoRA linear over resident uint8 conductance codes, for
// Hopper (sm_90a). One f32 computation, two launchers:
//
//     Y = gamma * (scale * X @ (G+ - G-) + (X @ A) @ B)
//
// Replaces the Pallas TPU kernel repro/kernels/dora_linear.py::_kernel
// (accum="f32") behind its two launchers: dora_linear_gemv (decode,
// M <= 64) and dora_linear (prefill, tiled over M).
//
// What bounds it on an H100. Every shape the serving path gives is bound
// by bytes: each weight is two code bytes (G+ and G-) read once per call,
// and the work is M flops per code byte, below the card's ridge point for
// these inputs up to M ~ 295 (bf16 x; G+ - G- in [-255, 255] is exact in
// bf16; 989 TFLOP/s on the tensor cores over 3.35 TB/s). Its floor is
// about 2*K*N bytes over the HBM rate. This port keeps the reference's
// exact f32 arithmetic on the SIMT units instead (67 TFLOP/s, a ridge of
// 20 flop/byte), so it holds the reference's 1e-4 tolerance: the decode
// GEMV (M <= 4) stays under that ridge, but from a few dozen rows up,
// and for the tiled launcher at prefill, f32 issue caps the kernel far
// above the byte floor. A bf16 tensor-core body is what would close it.
//
// What the design does about it:
// * The weight stays in code space into registers: no float weight ever
//   reaches device memory. A code byte becomes a float by OR-ing it into
//   the mantissa of 2^23 (one byte permute); G+ - G- is then one exact
//   f32 subtract, with no int-to-float conversion.
// * A prologue kernel computes X @ A (M x R) once per call, and for the
//   GEMV launcher also X^T as f32 (K x rows, zero rows past M). The TPU
//   kernel accumulated X @ A inside every grid step's K loop; on the
//   card every block would redo it, which cost more than streaming the
//   codes, so it runs once and the main kernels read the small result.
// * GEMV launcher: a block owns a strip of 32 (16 from 8 rows up) output
//   columns and all of K (the TPU grid's sequential K axis becomes a
//   loop: no block waits for another). Each thread loads CPT neighbouring
//   code bytes of a row as one vector (16 bytes at M <= 4), neighbouring
//   threads take the rest of the strip's row segment and then the next
//   rows, and each thread keeps 4 (8) rows of both code arrays in flight. Each thread holds rows x CPT accumulators; the row
//   groups are summed with warp shuffles, then warp by warp in a fixed
//   order (deterministic), and the epilogue applies scale, XA @ B and
//   gamma.
// * Tiled launcher: a shared-memory SIMT product, 128x128 output tile,
//   8-deep K tiles, each thread an 8x8 register tile; codes become f32
//   weights as the tile is loaded. The low-rank term reuses the same
//   micro-kernel as 8-deep "K tiles" of XA against B after the
//   accumulators are scaled, then gamma is applied.
// * Both mask ragged M, K and N themselves (zero-filled loads, guarded
//   stores), so no operand is ever padded.
//
// Plain C interface (loaded with ctypes). Every function returns
// cudaGetLastError() after its launches; the Python wrapper raises on
// anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// prologue: XA = X @ A (M x R) and, for the GEMV launcher, XT = X^T (K x rows)
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 256;
constexpr int kPrepRows = 256;  // rows of K per prologue block

// grid (max(M, rows), G = ceil(K / kPrepRows)): block (m, g) handles row m
// of X over rows [g * kPrepRows, (g + 1) * kPrepRows) of K and writes its
// partial X @ A to xa[g][m][:]; the main kernels sum the G partials.
template <typename TX>
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const TX* __restrict__ x, const float* __restrict__ a,
                float* __restrict__ xa, float* __restrict__ xt, int M, int K,
                int R, int rows) {
  __shared__ float part[kPrepThreads];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int kb = blockIdx.y * kPrepRows, ke = min(K, kb + kPrepRows);
  if (xt != nullptr && m < rows) {
    for (int k = kb + tid; k < ke; k += kPrepThreads)
      xt[(size_t)k * rows + m] = m < M ? to_f32(x[(size_t)m * K + k]) : 0.f;
  }
  if (m >= M) return;
  // thread (slice s, rank j) sums rows kb + s, kb + s + S, ...; S = 256 / R
  const int S = kPrepThreads / R;
  const int s = tid / R, j = tid - s * R;
  float acc = 0.f;
  if (s < S) {
    const TX* xr = x + (size_t)m * K;
#pragma unroll 4
    for (int k = kb + s; k < ke; k += S) acc = fmaf(to_f32(xr[k]), a[(size_t)k * R + j], acc);
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < R) {
    float sum = 0.f;
    for (int q = 0; q < S; ++q) sum += part[q * R + tid];
    xa[((size_t)blockIdx.y * M + m) * R + tid] = sum;
  }
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
__device__ __forceinline__ void load_x(const float* __restrict__ xt, int k,
                                       float (&xv)[MT]) {
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

// MT: rows (a power of two >= M); CPT: columns per thread, MT * CPT <= 64;
// COLS: output columns per block; U: code rows each thread keeps in flight
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
  float* red = smem;            // [MT][COLS]
  float* xa = red + MT * COLS;  // [M][R]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % TPR, rg = tid / TPR;
  const int col0 = blockIdx.x * COLS + ct * CPT;
  const int valid = min(CPT, N - col0);  // columns of this thread inside N

  for (int p = tid; p < M * R; p += kGemvThreads) xa[p] = xa_sum(xa_g, G, M, R, p / R, p % R);

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

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
        const float w = byte_f32(cp[u].w[c / 4], c % 4) - byte_f32(cn[u].w[c / 4], c % 4);
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
__device__ __forceinline__ void micro_tile(const float (*as)[kTileM],
                                           const float (*bs)[kTileN], int ty,
                                           int tx, float (&acc)[8][8]) {
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

template <typename TX, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
    dora_tiled_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ gp,
                      const uint8_t* __restrict__ gn, const float* __restrict__ scale,
                      const float* __restrict__ b, const float* __restrict__ gamma,
                      const float* __restrict__ xa, float* __restrict__ out, int M,
                      int K, int N, int R, int G) {
  __shared__ __align__(16) float as[kTileK][kTileM];  // x tile, transposed
  __shared__ __align__(16) float bs[kTileK][kTileN];  // dequantized code tile
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
      as[lk + i][lm] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    {
      const int k = k0 + ck;
      const int valid = k < K ? min(4, N - (n0 + cn)) : 0;
      const size_t off = (size_t)min(k, K - 1) * N + n0 + cn;
      const uint32_t p = load_codes<4, VEC>(gp + off, valid).w[0];
      const uint32_t q = load_codes<4, VEC>(gn + off, valid).w[0];
      float4 w;
      w.x = byte_f32(p, 0) - byte_f32(q, 0);
      w.y = byte_f32(p, 1) - byte_f32(q, 1);
      w.z = byte_f32(p, 2) - byte_f32(q, 2);
      w.w = byte_f32(p, 3) - byte_f32(q, 3);
      *reinterpret_cast<float4*>(&bs[ck][cn]) = w;
    }
    __syncthreads();
    micro_tile(as, bs, ty, tx, acc);
  }

  // y = acc * scale + XA @ B: scale first, then the low-rank term through
  // the same micro-kernel, 8 ranks at a time
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tile_row(tx, j);
    const float s = n < N ? scale[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] *= s;
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
    micro_tile(as, bs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_row(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_row(tx, j);
      if (n < N) out[(size_t)m * N + n] = acc[i][j] * gamma[n];
    }
  }
}

// ---------------------------------------------------------------------------
// host-side launch helpers
// ---------------------------------------------------------------------------

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int prep_chunks(int K) { return (K + kPrepRows - 1) / kPrepRows; }

template <typename TX>
cudaError_t launch_prep(const void* x, const void* a, void* xa, void* xt, int M,
                        int K, int R, int rows, cudaStream_t s) {
  const dim3 grid(xt != nullptr ? (M > rows ? M : rows) : M, prep_chunks(K));
  prep_kernel<TX><<<grid, kPrepThreads, 0, s>>>(
      (const TX*)x, (const float*)a, (float*)xa, (float*)xt, M, K, R, rows);
  return cudaGetLastError();
}

template <int MT, int CPT, int COLS, int U, bool VEC>
cudaError_t launch_gemv_main(const void* xt, const void* gp, const void* gn,
                             const void* scale, const void* b, const void* gamma,
                             const void* xa, void* out, int M, int K, int N, int R,
                             cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)MT * COLS + (size_t)M * R);
  auto kernel = dora_gemv_kernel<MT, CPT, COLS, U, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + COLS - 1) / COLS);
  kernel<<<grid, kGemvThreads, smem, s>>>(
      (const float*)xt, (const uint8_t*)gp, (const uint8_t*)gn, (const float*)scale,
      (const float*)b, (const float*)gamma, (const float*)xa, (float*)out, M, K, N, R,
      prep_chunks(K));
  return cudaGetLastError();
}

// Up to 4 rows (decode ticks) the kernel is bound by the code stream:
// 32-column strips (full 32-byte sectors), 4 rows in flight. From 8 rows
// (admission chunks) the f32 work per code byte grows, so the strips
// narrow to 16 columns (twice the blocks, more SMs busy) with 8 rows in
// flight to keep the loads ahead of the arithmetic.
template <int MT, int CPT>
cudaError_t gemv_vec(const void* xt, const void* gp, const void* gn,
                     const void* scale, const void* b, const void* gamma,
                     const void* xa, void* out, int M, int K, int N, int R,
                     cudaStream_t s) {
  constexpr int COLS = MT <= 4 ? 32 : 16;
  constexpr int U = MT <= 4 ? 4 : 8;
  const bool vec = N % CPT == 0 && aligned(gp, CPT) && aligned(gn, CPT);
  return vec ? launch_gemv_main<MT, CPT, COLS, U, true>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s)
             : launch_gemv_main<MT, CPT, COLS, U, false>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
}

cudaError_t gemv_rows(int rows, const void* xt, const void* gp, const void* gn,
                      const void* scale, const void* b, const void* gamma,
                      const void* xa, void* out, int M, int K, int N, int R,
                      cudaStream_t s) {
  switch (rows) {
    case 1: return gemv_vec<1, 16>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
    case 2: return gemv_vec<2, 16>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
    case 4: return gemv_vec<4, 16>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
    case 8: return gemv_vec<8, 8>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
    case 16: return gemv_vec<16, 4>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
    case 32: return gemv_vec<32, 2>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
    case 64: return gemv_vec<64, 1>(xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t launch_tiled(const void* x, const void* gp, const void* gn,
                         const void* scale, const void* b, const void* gamma,
                         const void* xa, void* out, int M, int K, int N, int R,
                         cudaStream_t s) {
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  const bool vec = N % 4 == 0 && aligned(gp, 4) && aligned(gn, 4);
  if (vec)
    dora_tiled_kernel<TX, true><<<grid, kTileThreads, 0, s>>>(
        (const TX*)x, (const uint8_t*)gp, (const uint8_t*)gn, (const float*)scale,
        (const float*)b, (const float*)gamma, (const float*)xa, (float*)out, M, K, N, R,
        prep_chunks(K));
  else
    dora_tiled_kernel<TX, false><<<grid, kTileThreads, 0, s>>>(
        (const TX*)x, (const uint8_t*)gp, (const uint8_t*)gn, (const float*)scale,
        (const float*)b, (const float*)gamma, (const float*)xa, (float*)out, M, K, N, R,
        prep_chunks(K));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (M, K) f32 (x_bf16 == 0) or bf16; gp, gn: (K, N) u8; scale, gamma:
// (N,) f32; a: (K, R) f32; b: (R, N) f32; out: (M, N) f32; xa: f32
// scratch of rimc_xa_scratch(M, K, R) floats. All contiguous, on the
// current device, 1 <= R <= 256.

int rimc_xa_scratch(int M, int K, int R) { return prep_chunks(K) * M * R; }

// xt: (K, rows) f32 scratch; rows: the row bucket, a power of two in [M, 64]
int rimc_dora_linear_gemv(const void* x, int x_bf16, const void* gp,
                          const void* gn, const void* scale, const void* a,
                          const void* b, const void* gamma, void* out, void* xa,
                          void* xt, int M, int K, int N, int R, int rows,
                          void* stream) {
  if (M < 1 || M > rows || K < 1 || N < 1 || R < 1 || R > kPrepThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = x_bf16 ? launch_prep<__nv_bfloat16>(x, a, xa, xt, M, K, R, rows, s)
                         : launch_prep<float>(x, a, xa, xt, M, K, R, rows, s);
  if (e != cudaSuccess) return (int)e;
  return (int)gemv_rows(rows, xt, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
}

int rimc_dora_linear_tiled(const void* x, int x_bf16, const void* gp,
                           const void* gn, const void* scale, const void* a,
                           const void* b, const void* gamma, void* out, void* xa,
                           int M, int K, int N, int R, void* stream) {
  if (M < 1 || K < 1 || N < 1 || R < 1 || R > kPrepThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = x_bf16 ? launch_prep<__nv_bfloat16>(x, a, xa, nullptr, M, K, R, 0, s)
                         : launch_prep<float>(x, a, xa, nullptr, M, K, R, 0, s);
  if (e != cudaSuccess) return (int)e;
  e = x_bf16 ? launch_tiled<__nv_bfloat16>(x, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s)
             : launch_tiled<float>(x, gp, gn, scale, b, gamma, xa, out, M, K, N, R, s);
  return (int)e;
}

}  // extern "C"
