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
// Faithfulness. The reference forms each tile's current in f32, then
// rounds it. Here too: a tile's current is finished in f32 (exact FMAs in
// the kernel's own order) before it is rounded, every split of K falls on
// a 256-row boundary, and the digitized partials are summed in ascending
// tile order. The step is computed in f32 in the reference's order,
// (256 * code_max * absmax) / (adc_max * 16), with IEEE division and
// round-half-even, and the adds and multiplies after the dot are
// explicitly rounded (no FMA contraction). Only the order of the f32 dot
// inside a tile differs from the reference, which can move a current
// across a rounding boundary: then one output differs by one ADC step
// times its column scale. When every current is an exact integer below
// 2^24 (integer-valued x), the result is exact in any order.
//
// What bounds it on an H100. Bytes: each weight is two code bytes read
// once, and the work is M flops per code byte; bf16 x times integer codes
// is exact in bf16, so the card's rate for it is 989 TFLOP/s on the
// tensor cores, whose ridge (~295 flop/byte) is above every serving shape.
// This first version does exact-f32 SIMT arithmetic (67 TFLOP/s), so at
// prefill f32 issue, not bytes, is what limits it.
//
// What the design does about it:
// * Three launches: a step prologue (one step per (row block, K tile)),
//   the main kernel, and an ordered sum of the digitized partials times
//   the column scale.
// * Main kernel, grid (N / 128, K tiles, M / TM): a block owns TM output
//   rows (TM in {16, 32, 64, 128} from the row count: decode ticks do not
//   pay for 128-row tiles) x 128 columns for ONE 256-row K tile, so there
//   are K / 256 times more blocks than output tiles to fill the 132 SMs.
//   Shared-memory SIMT product, 8-deep K steps, each thread TM/16 rows x 8
//   columns; codes become exact f32 weights G+ - G- (byte OR-ed into the
//   mantissa of 2^23) as the tile is loaded. It digitizes its finished
//   tile current and writes it to a partial (K tiles x M x N f32 scratch).
// * Ragged M, K and N are masked in the kernels (zero-filled loads,
//   guarded stores): nothing is padded, and zeros change neither a
//   current nor a max |x|, so this equals the reference's zero padding.
//
// Plain C interface (loaded with ctypes). The function returns
// cudaGetLastError() after its launches; the Python wrapper raises on
// anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 128;  // rows of X that share one DAC reference
constexpr int kArrayRows = 256;  // rows of one crossbar activation (K tile)
constexpr int kThreads = 256;
constexpr int kTileN = 128;
constexpr int kTileK = 8;

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

// grid (row blocks, K tiles): step[b * T + t] from max |x| over rows
// [128 b, 128 b + 128) and columns [256 t, 256 t + 256) of X
template <typename TX>
__global__ void __launch_bounds__(kThreads)
    adc_step_kernel(const TX* __restrict__ x, float* __restrict__ step, int M, int K,
                    float full_scale, float denom) {
  __shared__ float wmax[kThreads / 32];
  const int tid = threadIdx.x;
  const int k = blockIdx.y * kArrayRows + tid;
  const int m0 = blockIdx.x * kBlockRows, m1 = min(M, m0 + kBlockRows);
  float amax = 0.f;
  if (k < K)
    for (int m = m0; m < m1; ++m) amax = fmaxf(amax, fabsf(to_f32(x[(size_t)m * K + k])));
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
template <typename TX, int RM, bool VEC>
__global__ void __launch_bounds__(kThreads)
    adc_tile_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ gp,
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
      as[kk][r] = (m < M && k < ke) ? to_f32(x[(size_t)m * K + k]) : 0.f;
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

template <typename TX, int RM>
cudaError_t launch_tiles(const void* x, const void* gp, const void* gn, const float* step,
                         float* part, int M, int K, int N, int T, float adc_max,
                         cudaStream_t s) {
  constexpr int TM = 16 * RM;
  const dim3 grid((N + kTileN - 1) / kTileN, T, (M + TM - 1) / TM);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(gp) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(gn) % 4 == 0;
  auto kernel = vec ? adc_tile_kernel<TX, RM, true> : adc_tile_kernel<TX, RM, false>;
  kernel<<<grid, kThreads, 0, s>>>((const TX*)x, (const uint8_t*)gp, (const uint8_t*)gn,
                                   step, part, M, K, N, adc_max);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const void* x, const void* gp, const void* gn, const void* scale,
                   void* out, void* step, void* part, int M, int K, int N,
                   int tile_rows, float full_scale, float denom, float adc_max,
                   cudaStream_t s) {
  const int nb = (M + kBlockRows - 1) / kBlockRows, T = (K + kArrayRows - 1) / kArrayRows;
  adc_step_kernel<TX><<<dim3(nb, T), kThreads, 0, s>>>((const TX*)x, (float*)step, M, K,
                                                       full_scale, denom);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (tile_rows) {
    case 16: e = launch_tiles<TX, 1>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    case 32: e = launch_tiles<TX, 2>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    case 64: e = launch_tiles<TX, 4>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    case 128: e = launch_tiles<TX, 8>(x, gp, gn, (const float*)step, (float*)part, M, K, N, T, adc_max, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const size_t MN = (size_t)M * N;
  adc_sum_kernel<<<(unsigned)((MN + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const float*)part, (const float*)scale, (float*)out, M, N, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch sizes in floats: one step per (128-row block, 256-row K tile),
// one digitized partial per (K tile, m, n)
int rimc_adc_step_scratch(int M, int K) {
  return ((M + kBlockRows - 1) / kBlockRows) * ((K + kArrayRows - 1) / kArrayRows);
}
long long rimc_adc_part_scratch(int M, int K, int N) {
  return (long long)((K + kArrayRows - 1) / kArrayRows) * M * N;
}

// x: (M, K) f32 (x_bf16 == 0) or bf16; gp, gn: (K, N) u8; scale: (N,) f32;
// out: (M, N) f32; step, part: f32 scratch of the sizes above; tile_rows:
// 16, 32, 64 or 128 output rows per block; full_scale = 256 * code_max,
// denom = adc_max * 16. All contiguous, on the current device.
int rimc_crossbar_mvm(const void* x, int x_bf16, const void* gp, const void* gn,
                      const void* scale, void* out, void* step, void* part, int M,
                      int K, int N, int tile_rows, float full_scale, float denom,
                      float adc_max, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(x_bf16 ? launch<__nv_bfloat16>(x, gp, gn, scale, out, step, part, M, K, N,
                                              tile_rows, full_scale, denom, adc_max, s)
                      : launch<float>(x, gp, gn, scale, out, step, part, M, K, N,
                                      tile_rows, full_scale, denom, adc_max, s));
}

}  // extern "C"
