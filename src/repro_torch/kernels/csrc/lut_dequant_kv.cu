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
// Design: one float4 of output per thread and step, so that neighbouring
// lanes store neighbouring 16 bytes and a warp's store covers 512
// contiguous bytes; its codes are 4 bytes (q8) or 2 bytes (q4) read with
// one load, also contiguous across the warp.  The flat output is cut into
// float4s whatever R is (the Pallas kernel's row block had to divide R);
// a thread takes kVec of them, kThreads apart, and starts all its loads
// before its stores.  When the scale group gc is a multiple of 4, a float4
// needs one scale; otherwise each element reads its own.  The 16-entry
// codebook sits in shared memory.  Index arithmetic is 32-bit unless the
// output has 2^32 float4s or more.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;  // float4s per thread

struct Args {
  const uint8_t* codes;    // (R, H, Dc)
  const __half* scales;    // (R, Hs, Ds)
  const float* codebook;   // (16,), q4 only
  float* out;              // (R, H, D), D4 = D / 4 float4s per row
  unsigned long long n_vec;  // R * H * D4
  int D4, H, Hs, Ds, gr, gc;
};

template <bool Q4, bool SCALE4, typename Idx>
__global__ void __launch_bounds__(kThreads) lut_dequant_kv_kernel(Args a) {
  __shared__ float cb[16];
  if constexpr (Q4) {
    if (threadIdx.x < 16) cb[threadIdx.x] = a.codebook[threadIdx.x];
    __syncthreads();
  }
  const Idx n_vec = (Idx)a.n_vec, D4 = (Idx)a.D4, H = (Idx)a.H;
  const Idx base = (Idx)blockIdx.x * (kThreads * kVec) + threadIdx.x;
  uint32_t raw[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const Idx e = base + (Idx)u * kThreads;
    if (e < n_vec)
      raw[u] = Q4 ? (uint32_t)__ldg(
                        reinterpret_cast<const unsigned short*>(a.codes) + e)
                  : __ldg(reinterpret_cast<const unsigned int*>(a.codes) + e);
  }
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const Idx e = base + (Idx)u * kThreads;
    if (e >= n_vec) continue;
    const Idx slab = e / D4;  // r * H + h
    const int d0 = (int)(e - slab * D4) * 4;
    const Idx r = slab / H;
    const int h = (int)(slab - r * H);
    const __half* srow =
        a.scales + ((size_t)r * a.Hs + h / a.gr) * (size_t)a.Ds;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (Q4)
        v[i] = cb[(raw[u] >> (4 * i)) & 0xF];
      else
        v[i] = (float)(int8_t)(raw[u] >> (8 * i));
    }
    if constexpr (SCALE4) {
      const float sc = __half2float(__ldg(srow + d0 / a.gc));
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __fmul_rn(v[i], sc);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __fmul_rn(v[i], __half2float(__ldg(srow + (d0 + i) / a.gc)));
    }
    reinterpret_cast<float4*>(a.out)[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool Q4, bool SCALE4>
void launch(const Args& a, cudaStream_t s) {
  const unsigned long long per_block = kThreads * kVec;
  const unsigned blocks = (unsigned)((a.n_vec + per_block - 1) / per_block);
  if (a.n_vec + per_block < (1ull << 32))
    lut_dequant_kv_kernel<Q4, SCALE4, uint32_t><<<blocks, kThreads, 0, s>>>(a);
  else
    lut_dequant_kv_kernel<Q4, SCALE4, unsigned long long>
        <<<blocks, kThreads, 0, s>>>(a);
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
  const int D4 = (q4 ? 2 * Dc : Dc) / 4;
  const Args a{static_cast<const uint8_t*>(codes),
               static_cast<const __half*>(scales),
               static_cast<const float*>(codebook), static_cast<float*>(out),
               (unsigned long long)R * H * D4, D4, H, Hs, Ds, gr, gc};
  if (a.n_vec == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool s4 = gc % 4 == 0;
  if (q4)
    s4 ? launch<true, true>(a, s) : launch<true, false>(a, s);
  else
    s4 ? launch<false, true>(a, s) : launch<false, false>(a, s);
  return (int)cudaGetLastError();
}
