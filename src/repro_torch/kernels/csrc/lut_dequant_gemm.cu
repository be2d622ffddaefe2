// W4A16 GEMM with in-kernel LUT dequantization for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   K3  src/repro/kernels/lut_dequant_gemm.py  lut_dequant_gemm
// y = x @ W with W given as packed 4-bit codes (two per byte, low nibble =
// even column), a 16-entry codebook and f16 group scales in the paper's
// tile layout ((K/2, N/16): 2 K-rows x 16 N-columns per scale) or the
// common layout ((K/g, N)).  The dequantized weight is rounded to x's type
// before the product; the product accumulates in f32 and the output is
// written in x's type.
//
// What bounds it on the H100: at decode (M <= 8 rows) the product is bound
// by the bytes of the packed weight (~0.56 byte per weight with scales); at
// prefill (M in the tens to hundreds) a tensor-core kernel would be bound
// by operations, but this one computes with f32 FMA, well below that.  The
// small-N projections (N = 256) also give few blocks for 132 SMs.  Making
// it fast (tensor cores, TMA pipelining, split-K) is left to later changes.
//
// Design: each 256-thread block computes a BM x BN output tile and steps
// through K in BK slices.  Per slice it stages x in shared memory as f32
// and dequantizes the packed codes and their scales straight into a
// shared-memory f32 weight tile (codebook lookup from a 16-entry table in
// shared memory, times the broadcast scale, rounded to x's type), so the
// dequantized weight never touches device memory.  Each thread keeps a
// TM x TN register tile of f32 accumulators.  Ragged M, N and K are masked
// (prefill M = batch x padded prompt length).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// one tile shape for every M: 16 rows (decode M = 8 and the prefill M of
// one prompt fit one row of blocks; larger M takes more rows of blocks) by
// 32 columns, so N spreads over many blocks, with 128-deep K slices
constexpr int kBM = 16, kBN = 32, kBK = 128, kTM = 1, kTN = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to T and widen it back (the weight's rounding point)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, bool TILE, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    lut_dequant_gemm_kernel(const T* __restrict__ x,
                            const uint8_t* __restrict__ codes,
                            const __half* __restrict__ scales,
                            const float* __restrict__ codebook,
                            T* __restrict__ out, int M, int K, int N,
                            int group) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "thread tile mismatch");
  constexpr int XE = 16 / (int)sizeof(T);  // x values per 16-byte chunk
  static_assert(BK % XE == 0 && BN % 32 == 0, "chunk tiling");
  __shared__ float As[BK][BM + 1];  // x tile, transposed; +1 avoids conflicts
  __shared__ float Bs[BK][BN];      // dequantized weight tile
  __shared__ float cb[16];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half_n = N / 2;
  const int gc = group / 2;  // tile scheme: 2 x gc per scale
  const bool xvec = K % XE == 0 && ((uintptr_t)x & 15) == 0;
  const bool cvec = half_n % 16 == 0 && ((uintptr_t)codes & 15) == 0;
  if (tid < 16) cb[tid] = codebook[tid];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // previous slice consumed (and cb visible)
    // x tile: 16-byte chunks of XE values along K (scalar at ragged edges)
    for (int i = tid; i < BM * (BK / XE); i += kThreads) {
      const int r = i / (BK / XE), cc = i - r * (BK / XE);
      const int gm = m0 + r, gk = k0 + cc * XE;
      float v[XE];
      if (gm < M && xvec && gk + XE <= K) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < XE; ++j) v[j] = to_f(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < XE; ++j)
          v[j] = (gm < M && gk + j < K) ? to_f(x[(size_t)gm * K + gk + j])
                                        : 0.f;
      }
#pragma unroll
      for (int j = 0; j < XE; ++j) As[cc * XE + j][r] = v[j];
    }
    // weight tile: 16 packed bytes = 32 columns per chunk, dequantized
    // through the codebook and the broadcast scale, rounded to T
    for (int i = tid; i < BK * (BN / 32); i += kThreads) {
      const int r = i / (BN / 32), cc = i - r * (BN / 32);
      const int gk = k0 + r, gn = n0 + cc * 32;
      uint8_t bytes[16];
      if (gk < K && cvec && gn + 32 <= N) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            codes + (size_t)gk * half_n + gn / 2));
        const uint8_t* rb = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
        for (int b = 0; b < 16; ++b) bytes[b] = rb[b];
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          bytes[b] = (gk < K && gn + 2 * b < N)
                         ? codes[(size_t)gk * half_n + gn / 2 + b]
                         : 0;
      }
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int n = gn + 2 * b;  // even; N is even
        float w0 = 0.f, w1 = 0.f;
        if (gk < K && n < N) {
          float s0, s1;
          if (TILE) {
            // n and n + 1 share one gc-wide column group (gc is even)
            s0 = s1 = __half2float(scales[(size_t)(gk / 2) * (N / gc) + n / gc]);
          } else {
            const size_t row = (size_t)(gk / group) * N;
            s0 = __half2float(scales[row + n]);
            s1 = __half2float(scales[row + n + 1]);
          }
          w0 = round_to<T>(cb[bytes[b] & 0xF] * s0);
          w1 = round_to<T>(cb[bytes[b] >> 4] * s1);
        }
        Bs[r][cc * 32 + 2 * b] = w0;
        Bs[r][cc * 32 + 2 * b + 1] = w1;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, bool TILE>
cudaError_t launch(const void* x, const void* codes, const void* scales,
                   const void* codebook, void* out, int M, int K, int N,
                   int group, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  lut_dequant_gemm_kernel<T, TILE, kBM, kBN, kBK, kTM, kTN>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const uint8_t*>(codes),
          static_cast<const __half*>(scales),
          static_cast<const float*>(codebook), static_cast<T*>(out), M, K, N,
          group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_scheme(int tile, const void* x, const void* codes,
                      const void* scales, const void* codebook, void* out,
                      int M, int K, int N, int group, cudaStream_t s) {
  if (tile)
    return launch<T, true>(x, codes, scales, codebook, out, M, K, N, group, s);
  return launch<T, false>(x, codes, scales, codebook, out, M, K, N, group, s);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (x and the output).  tile: 1 for
// (K/2, N/(group/2)) tile scales, 0 for (K/group, N) common scales.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int lut_dequant_gemm_launch(int dtype, int tile, const void* x,
                                       const void* codes, const void* scales,
                                       const void* codebook, void* out, int M,
                                       int K, int N, int group,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)by_scheme<float>(tile, x, codes, scales, codebook, out, M,
                                   K, N, group, s);
    case 1:
      return (int)by_scheme<__half>(tile, x, codes, scales, codebook, out, M,
                                    K, N, group, s);
    case 2:
      return (int)by_scheme<__nv_bfloat16>(tile, x, codes, scales, codebook,
                                           out, M, K, N, group, s);
  }
  return (int)cudaErrorInvalidValue;
}
