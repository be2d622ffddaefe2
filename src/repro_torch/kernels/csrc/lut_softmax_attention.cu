// LUT-softmax FlashAttention (paper Alg. 1) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   K5  src/repro/kernels/lut_softmax_attention.py  lut_softmax_attention
// q (BH, Sq, D) fp16 against k, v (BH / G, Skv, D) fp16 (query head bh
// reads KV head bh / G, so GQA needs no repeated K/V), causal (top-left
// aligned: kpos <= qpos) or not, with exp in one of three modes: the
// paper's 32768-entry fp16 exp table indexed by the low 15 bits of the
// fp16 argument (lut), the fp16 polynomial exp2 baseline of Fig. 14
// (poly), or f32 exp (exact).  Output (BH, Sq, D) fp16.
//
// Rounding points, copied from the Pallas kernel: S = f32 q.k^T times the
// f32 scale, NEG_CAP (-30000) where masked, rounded to fp16
// (__float2half_rn); m kept in fp16; x = s16 - m_new by __hsub; p and the
// correction factor e^(m_prev - m_new) from the exp mode, rounded to fp16;
// l and acc in f32 (l * corr + sum p, acc * corr + p.v, each multiply and
// add rounded on its own); out = acc / max(l, 1e-30).  m is rounded once
// per KV block, so the block length bkv is part of the function: it is a
// runtime argument (any divisor of Skv up to kMaxBkv, odd ones too), and
// each row's scores over the whole block are formed before its max is
// taken.  The exact mode uses expf (not __expf), and the file is built
// without fast math.  The poly mode uses floorf and ldexpf and writes its
// Horner steps with __fmul_rn / __fadd_rn so that nvcc cannot contract
// them into FMAs: it is bit-identical to the plain version's f32 steps.
// Products of two fp16 values are exact in f32, so the FMAs of q.k and
// p.v round only their sums; those sums run in another order than the
// plain version's, which can move an fp16-rounded score by one step.
//
// What bounds it on the H100: operations.  At qwen2.5-1.5b's prefill
// geometry (12 query heads, 2 KV heads, head_dim 128, 2048 tokens) the
// causal product is ~13 GFLOP against ~15 MB of q, k, v and out, far
// above the card's ~295 flops-per-byte ridge.  This first version does
// its products in f32 on the CUDA cores (no tensor cores), so it runs far
// from the fp16 tensor-core bound; mma.sync / wgmma are the fix.
//
// Design: one thread block of 128 threads per (bh, 16-row query tile),
// a loop over the KV blocks of bkv rows.  Per block: K and V are staged
// in shared memory with 16-byte loads (K rows padded to an odd word
// stride so that threads reading different rows at one dim hit different
// banks); each thread forms one block column's scores for the 16 rows
// (q is held in shared memory as f32 and read by broadcast); 8 lanes per
// row take the fp16 max, p, the row sum and the correction factor; then
// each thread accumulates p.v for its (rows, dim) share in registers.
// A causal tile stops at the last KV block it can see: a block that the
// mask covers entirely gives p = exp(-30000 - m) = 0 and corr = exp(0) =
// 1 in every mode, so skipping it changes nothing.  The 64 KiB LUT stays
// in global memory and is read through the read-only cache (__ldg).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegCap = -30000.0f;  // finite fp16 "-inf"; LUT gives 0
constexpr int kThreads = 128;
constexpr int kRows = 16;      // query rows per thread block
constexpr int kMaxBkv = 256;   // longest KV block the shared memory takes

enum ExpMode { kLut = 0, kPoly = 1, kExact = 2 };

// exp of an fp16 value <= 0, rounded to fp16
template <int MODE>
__device__ __forceinline__ __half exp16(__half x,
                                        const unsigned short* __restrict__ lut) {
  if constexpr (MODE == kLut) {
    return __ushort_as_half(__ldg(lut + (__half_as_ushort(x) & 0x7FFF)));
  } else if constexpr (MODE == kPoly) {
    // constants rounded from double to float, as the reference rounds them
    const float y = __fmul_rn(__half2float(x), (float)1.4426950408889634);
    const float k = floorf(y);
    const float t = __fmul_rn(__fsub_rn(y, k), (float)0.6931471805599453);
    float p = __fadd_rn((float)(1.0 / 6.0), __fmul_rn(t, (float)(1.0 / 24.0)));
    p = __fadd_rn(0.5f, __fmul_rn(t, p));
    p = __fadd_rn(1.0f, __fmul_rn(t, p));
    p = __fadd_rn(1.0f, __fmul_rn(t, p));
    return __float2half_rn(ldexpf(p, (int)k));
  } else {
    return __float2half_rn(expf(__half2float(x)));
  }
}

struct Params {
  const __half* q;            // (BH, Sq, D)
  const __half* k;            // (BH / G, Skv, D)
  const __half* v;
  const unsigned short* lut;  // (32768,) fp16 bit patterns (lut mode)
  __half* out;                // (BH, Sq, D)
  int Sq, Skv, G, bkv, causal;
  float scale;
};

// Shared-memory layout in 32-bit words (host and device agree on it).
template <int D>
struct Smem {
  static constexpr int kKw = D / 2 + 1;  // K row stride: odd, conflict-free
  static constexpr int kVw = D / 2;      // V row stride: 16-byte rows
  __host__ __device__ static int v_off() { return 0; }
  __host__ __device__ static int q_off(int bkv) { return bkv * kVw; }
  __host__ __device__ static int k_off(int bkv) {
    return q_off(bkv) + kRows * D;
  }
  __host__ __device__ static int s_off(int bkv) {
    return k_off(bkv) + bkv * kKw;
  }
  __host__ __device__ static int corr_off(int bkv) {
    return s_off(bkv) + kRows * (bkv + 1);
  }
  __host__ __device__ static int l_off(int bkv) { return corr_off(bkv) + kRows; }
  __host__ __device__ static int words(int bkv) { return l_off(bkv) + kRows; }
};

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
    lut_softmax_attention_kernel(Params p) {
  using L = Smem<D>;
  constexpr int kChunks = D / 8;                // 16-byte chunks per row
  constexpr int kRpt = kRows * D / kThreads;   // p.v rows per thread
  extern __shared__ __align__(16) uint32_t smem[];
  const int bkv = p.bkv;
  const int sw = bkv + 1;  // score row stride
  uint32_t* vs = smem + L::v_off();
  float* qs = reinterpret_cast<float*>(smem + L::q_off(bkv));
  uint32_t* ks = smem + L::k_off(bkv);
  float* ss = reinterpret_cast<float*>(smem + L::s_off(bkv));
  float* corr_s = reinterpret_cast<float*>(smem + L::corr_off(bkv));
  float* l_s = reinterpret_cast<float*>(smem + L::l_off(bkv));

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.Sq - q0);
  const __half* qg = p.q + ((size_t)bh * p.Sq + q0) * D;
  const size_t kv_base = (size_t)(bh / p.G) * p.Skv * D;

  for (int i = tid; i < kRows * D; i += kThreads)
    qs[i] = i / D < rows ? __half2float(qg[i]) : 0.f;

  int nkv = p.Skv / bkv;
  if (p.causal) nkv = min(nkv, (q0 + rows - 1) / bkv + 1);

  // softmax state: 8 lanes per row, each holding the row's m and l
  const int sr = tid >> 3, sl = tid & 7;
  float m_row = kNegCap;  // an fp16 value
  float l_row = 0.f;
  // p.v share: one dim, kRpt consecutive rows
  const int pd = tid % D, pr0 = (tid / D) * kRpt;
  float acc[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) acc[i] = 0.f;

  for (int j = 0; j < nkv; ++j) {
    const int kv0 = j * bkv;
    __syncthreads();  // the previous block's readers are done
    const uint4* kg = reinterpret_cast<const uint4*>(p.k + kv_base +
                                                     (size_t)kv0 * D);
    const uint4* vg = reinterpret_cast<const uint4*>(p.v + kv_base +
                                                     (size_t)kv0 * D);
    for (int i = tid; i < bkv * kChunks; i += kThreads) {
      const int c = i / kChunks, w = (i - c * kChunks) * 4;
      const uint4 a = __ldg(kg + i);
      const uint4 b = __ldg(vg + i);
      uint32_t* kd = ks + c * L::kKw + w;
      kd[0] = a.x; kd[1] = a.y; kd[2] = a.z; kd[3] = a.w;
      *reinterpret_cast<uint4*>(vs + c * L::kVw + w) = b;
    }
    __syncthreads();

    // scores of block column c for the tile's rows, rounded to fp16
    for (int c = tid; c < bkv; c += kThreads) {
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      const uint32_t* kr = ks + c * L::kKw;
#pragma unroll 4
      for (int w = 0; w < D / 2; ++w) {
        const float2 kf = __half22float2(
            *reinterpret_cast<const __half2*>(kr + w));
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float2 qf = *reinterpret_cast<const float2*>(qs + r * D + 2 * w);
          s[r] = fmaf(qf.x, kf.x, s[r]);
          s[r] = fmaf(qf.y, kf.y, s[r]);
        }
      }
      const int kpos = kv0 + c;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = __fmul_rn(s[r], p.scale);
        if (p.causal && kpos > q0 + r) v = kNegCap;
        ss[r * sw + c] = __half2float(__float2half_rn(v));
      }
    }
    __syncthreads();

    // fp16 max, p and the correction factor; l in f32
    {
      float* srow = ss + sr * sw;
      float mx = kNegCap;  // m_prev >= NEG_CAP, so this start changes nothing
      for (int c = sl; c < bkv; c += 8) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int o = 4; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const __half m_new = __float2half_rn(fmaxf(m_row, mx));
      float sum = 0.f;
      for (int c = sl; c < bkv; c += 8) {
        const float pv = __half2float(
            exp16<MODE>(__hsub(__float2half_rn(srow[c]), m_new), p.lut));
        srow[c] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 4; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = __half2float(
          exp16<MODE>(__hsub(__float2half_rn(m_row), m_new), p.lut));
      l_row = __fadd_rn(__fmul_rn(l_row, corr), sum);
      m_row = __half2float(m_new);
      if (sl == 0) corr_s[sr] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p.v over the block
    {
      const __half* vh = reinterpret_cast<const __half*>(vs);
      float pv[kRpt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) pv[i] = 0.f;
      for (int c = 0; c < bkv; ++c) {
        const float vv = __half2float(vh[c * D + pd]);
#pragma unroll
        for (int i = 0; i < kRpt; ++i)
          pv[i] = fmaf(ss[(pr0 + i) * sw + c], vv, pv[i]);
      }
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        acc[i] = __fadd_rn(__fmul_rn(acc[i], corr_s[pr0 + i]), pv[i]);
    }
  }

  if (sl == 0) l_s[sr] = l_row;
  __syncthreads();
  __half* og = p.out + ((size_t)bh * p.Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = pr0 + i;
    if (r < rows)
      og[r * D + pd] = __float2half_rn(__fdiv_rn(acc[i], fmaxf(l_s[r], 1e-30f)));
  }
}

template <int D, int MODE>
int launch(const Params& p, int BH, cudaStream_t stream) {
  const size_t bytes = (size_t)Smem<D>::words(p.bkv) * 4;
  auto kern = lut_softmax_attention_kernel<D, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kRows - 1) / kRows, BH);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const Params& p, int BH, int mode, cudaStream_t stream) {
  switch (mode) {
    case kLut: return launch<D, kLut>(p, BH, stream);
    case kPoly: return launch<D, kPoly>(p, BH, stream);
    case kExact: return launch<D, kExact>(p, BH, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 lut, 1 poly, 2 exact.  q (BH, Sq, D), k and v (BH / G, Skv, D),
// out (BH, Sq, D), all fp16 and 16-byte aligned; D in {32, 64, 128};
// bkv divides Skv and is at most 256.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int lut_softmax_attention_launch(
    const void* q, const void* k, const void* v, const void* lut, void* out,
    int BH, int Sq, int Skv, int D, int G, int bkv, int causal, int mode,
    float scale, void* stream) {
  if (bkv < 1 || bkv > kMaxBkv || Skv % bkv || G < 1 || BH % G)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  Params p{static_cast<const __half*>(q), static_cast<const __half*>(k),
           static_cast<const __half*>(v),
           static_cast<const unsigned short*>(lut), static_cast<__half*>(out),
           Sq, Skv, G, bkv, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_mode<32>(p, BH, mode, s);
    case 64: return launch_mode<64>(p, BH, mode, s);
    case 128: return launch_mode<128>(p, BH, mode, s);
  }
  return (int)cudaErrorInvalidValue;
}
