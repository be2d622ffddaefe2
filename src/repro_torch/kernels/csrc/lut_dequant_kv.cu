// KV token-slab dequantization for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   K4  src/repro/kernels/lut_dequant_gemm.py  lut_dequant_kv
// out[r, h, d] = val(code) * f32(scale[r, h / gr, d / gc]) over R gathered
// token slabs of a tile-quantized KV pool: codes (R, Hkv, Dc) int8 (q8,
// val = the code) or packed uint8 (q4, Dc = D / 2, low nibble = even d,
// val = codebook[nibble]); scales (R, Hkv / gr, D / gc) f16; out f32.  One
// f32 multiply per element, rounded to nearest (no fast math, nothing
// fused), so the result is bit-identical to the plain version and to
// kv_quant.dequantize_kv.
//
// What bounds it on the H100: bytes.  It does one multiply per output
// element and writes 4 bytes of output for every 1 (q8) or 0.5 (q4) byte
// of codes it reads, so the output write dominates; at the partial-prefill
// shapes (R = 1,792 to 12,544 slabs of 2 x 128) it moves 2 to 16 MB.
//
// Design: one thread per 16-byte chunk of codes, so any R is taken (the
// Pallas kernel's row block had to divide R).  A thread loads its chunk
// with one vector load, unpacks 16 (q8) or 32 (q4) values (the 16-entry
// codebook sits in shared memory), reads each scale once per gc-run of
// dims, and writes its outputs with float4 stores.  Neighbouring threads
// take neighbouring chunks, so the loads coalesce; the stores do not: each
// thread writes 64 (q8) or 128 (q4) contiguous bytes, so one warp-wide
// float4 store touches 32 segments 64 or 128 bytes apart, and on the H100
// the kernel reaches only a fifth of the byte rate (PERF.md).  Giving each
// thread one float4 of output (4 q8 or 2 q4 code bytes in) would make
// neighbouring threads' stores adjacent.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool Q4>
__global__ void __launch_bounds__(kThreads)
    lut_dequant_kv_kernel(const uint8_t* __restrict__ codes,
                          const __half* __restrict__ scales,
                          const float* __restrict__ codebook,
                          float* __restrict__ out, long long n_chunks,
                          int chunks_per_slab, int H, int D, int Hs, int Ds,
                          int gr, int gc) {
  constexpr int kOut = Q4 ? 32 : 16;  // values per 16-byte chunk
  __shared__ float cb[16];
  if constexpr (Q4) {
    if (threadIdx.x < 16) cb[threadIdx.x] = codebook[threadIdx.x];
    __syncthreads();
  }
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  const long long slab = c / chunks_per_slab;  // r * H + h
  const int d0 = (int)(c - slab * chunks_per_slab) * kOut;
  const long long r = slab / H;
  const int h = (int)(slab - r * H);

  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(codes) + c);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  float v[kOut];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if constexpr (Q4) {
      v[2 * j] = cb[b[j] & 0xF];
      v[2 * j + 1] = cb[b[j] >> 4];
    } else {
      v[j] = (float)(int8_t)b[j];
    }
  }
  const __half* srow = scales + (r * Hs + h / gr) * (long long)Ds;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int d = d0 + j;
    if (j == 0 || d % gc == 0) s = __half2float(__ldg(srow + d / gc));
    v[j] = __fmul_rn(v[j], s);
  }
  float4* o = reinterpret_cast<float4*>(out + slab * (long long)D + d0);
#pragma unroll
  for (int j = 0; j < kOut / 4; ++j)
    o[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

}  // namespace

// q4: 1 for packed q4 codes (codebook read), 0 for int8 q8 codes.  R slabs
// of H heads with Dc code bytes each (Dc a multiple of 16, codes 16-byte
// aligned); D = Dc (q8) or 2 * Dc (q4).  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int lut_dequant_kv_launch(int q4, const void* codes,
                                     const void* scales, const void* codebook,
                                     void* out, int R, int H, int Dc, int Hs,
                                     int Ds, int gr, int gc, void* stream) {
  const int chunks_per_slab = Dc / 16;
  const long long n_chunks = (long long)R * H * chunks_per_slab;
  const int D = q4 ? 2 * Dc : Dc;
  if (n_chunks == 0) return 0;
  const long long blocks = (n_chunks + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const __half* sc = static_cast<const __half*>(scales);
  const float* cb = static_cast<const float*>(codebook);
  float* o = static_cast<float*>(out);
  if (q4)
    lut_dequant_kv_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        c, sc, cb, o, n_chunks, chunks_per_slab, H, D, Hs, Ds, gr, gc);
  else
    lut_dequant_kv_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        c, sc, cb, o, n_chunks, chunks_per_slab, H, D, Hs, Ds, gr, gc);
  return (int)cudaGetLastError();
}
