// On-device tile quantization to Q4_0 codes for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   K6  src/repro/kernels/tile_quantize.py  tile_quantize
// w (K, N) in f32, fp16 or bf16 -> codes (K, N / 2) uint8 (two per byte
// along N, low nibble = even column) and scales (K / 2, N / 16) fp16, per
// (2, 16) group: scale = absmax / 8 in f32, stored rounded to fp16; code =
// clip(rint(w / max(scale, 1e-8)), -8, 7) + 8, dividing by the f32 scale.
// rintf rounds half to even, as jnp.round and torch.round do, and the
// division is IEEE (__fdiv_rn); the file is built without fast math, so
// codes and scales are bit-identical to the plain version and to the
// Pallas kernel.
//
// What bounds it on the H100: bytes.  It does a few operations per weight
// and reads 2 or 4 bytes of weight for every half byte of code it writes;
// at qwen2.5-1.5b's largest Q4 projection (1536 x 8960, f32) it moves
// ~63 MB.
//
// Design: one thread per (2, 16) group.  A thread reads its two 16-value
// rows with 16-byte loads, takes the absmax, writes one scale, and writes
// each row's 16 codes as one 8-byte store.  Neighbouring threads take
// neighbouring groups along N, so a warp's loads and stores cover
// contiguous runs of each row.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGc = 16;  // group columns; rows per group: 2

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_quantize_kernel(const T* __restrict__ w, uint8_t* __restrict__ codes,
                         __half* __restrict__ scales, int N,
                         long long n_groups) {
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte load
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const int ng = N / kGc;
  const long long kg = g / ng;
  const int cg = (int)(g - kg * ng);

  float x[2][kGc];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint4* src = reinterpret_cast<const uint4*>(
        w + (2 * kg + r) * (long long)N + cg * kGc);
#pragma unroll
    for (int i = 0; i < kGc / kVec; ++i) {
      const uint4 raw = __ldg(src + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[r][i * kVec + j] = to_f(e[j]);
    }
  }
  float absmax = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kGc; ++j) absmax = fmaxf(absmax, fabsf(x[r][j]));
  const float scale = __fdiv_rn(absmax, 8.0f);
  scales[g] = __float2half_rn(scale);
  // 1e-8 rounded from double to float, as the reference rounds it
  const float sc = fmaxf(scale, (float)1e-8);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < kGc; ++j) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(x[r][j], sc)), -8.f), 7.f);
      const uint32_t code = (uint32_t)(int)(q + 8.f);
      packed[j / 8] |= code << (4 * (j % 8));
    }
    *reinterpret_cast<uint2*>(codes + (2 * kg + r) * (long long)(N / 2) +
                              cg * (kGc / 2)) = make_uint2(packed[0], packed[1]);
  }
}

}  // namespace

// dtype: 0 f32, 1 fp16, 2 bf16.  w (K, N) with K even and N a multiple of
// 32, 16-byte aligned; codes (K, N / 2) uint8 8-byte aligned; scales
// (K / 2, N / 16) fp16.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int tile_quantize_launch(int dtype, const void* w, void* codes,
                                    void* scales, int K, int N,
                                    void* stream) {
  if (K % 2 || N % 32) return (int)cudaErrorInvalidValue;
  const long long n_groups = (long long)(K / 2) * (N / kGc);
  if (n_groups == 0) return 0;
  const unsigned blocks = (unsigned)((n_groups + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* c = static_cast<uint8_t*>(codes);
  __half* sc = static_cast<__half*>(scales);
  switch (dtype) {
    case 0:
      tile_quantize_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(w), c, sc, N, n_groups);
      break;
    case 1:
      tile_quantize_kernel<__half><<<blocks, kThreads, 0, s>>>(
          static_cast<const __half*>(w), c, sc, N, n_groups);
      break;
    case 2:
      tile_quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(w), c, sc, N, n_groups);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
