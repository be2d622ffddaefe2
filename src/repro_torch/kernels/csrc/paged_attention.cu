// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  src/repro/kernels/paged_attention.py  paged_attention        (fp pool)
//   K2  src/repro/kernels/paged_attention.py  quant_paged_attention  (Q8/Q4 pool)
// with one source templated on the block loader (fp / q8 / q4) and the exp
// mode (exact f32 recurrence / the paper's fp16 LUT recurrence, Alg. 1).
//
// What bounds it on the H100: at serving shapes (B = 8 rows, Hkv = 2, G = 6
// query heads per KV head, D = 128, 16-token blocks, a few hundred tokens
// per row) the work is tiny: a Q8 token slab is ~272 bytes per K or V, so a
// step reads well under a megabyte.  The grid is B * Hkv = 16 thread blocks
// for 132 SMs, and each walks its row's blocks one after another, so the
// kernel is bound by latency (one memory round trip and four barriers per
// 16-token block) and occupancy, not by bytes or operations.  Split-KV
// across thread blocks and prefetching the next block are the fixes and
// are left to later changes.
//
// Design: one thread block per (row b, KV head h) serves the G query heads
// that share that KV head, so each K/V block is read and dequantized once
// for G heads.  The block walks only the row's live table entries (the
// blocks covering [max(0, len - window), len)); blocks outside that range
// are fully masked, and a fully masked block contributes exactly nothing
// in either recurrence (m unchanged, correction exp(0) = 1, p = 0), so the
// result is the same function as walking the whole table.  Per block: every
// thread issues its 16-byte K and V loads at once, then K and V are
// dequantized into shared memory as f32 (Q8: code * scale, Q4: the 16-entry
// codebook held in shared memory, low nibble = even dim); one thread per
// (query head, token) computes a score from padded shared-memory rows; 16
// lanes per query head run the online-softmax update over the block's
// positions; and the threads update acc[G][D] in shared memory.  The 64 KiB
// exp LUT exceeds the 48 KiB static shared-memory limit and is read through
// the read-only cache.
//
// LUT mode copies the reference's rounding points: s16 = fp16(masked s),
// m kept in fp16, s16 - m_new rounded to fp16, corr = LUT(m_prev - m_new)
// widened to f32, v rounded to fp16 for P.V with f32 accumulation.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegCap = -30000.0f;  // finite fp16 "-inf" of the LUT mode
constexpr float kNegInf = -1e30f;     // masked score of the exact mode
constexpr int kThreads = 128;
constexpr int kMaxChunks = 4;  // 16-byte K (and V) chunks per thread

enum Loader { kFp = 0, kQ8 = 1, kQ4 = 2 };

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

__device__ __forceinline__ float round_f16(float v) {
  return __half2float(__float2half_rn(v));
}

// exp of an fp16 value <= 0 through the 15-bit table index
__device__ __forceinline__ float lut_exp(const unsigned short* lut,
                                         float x16) {
  unsigned short bits = __half_as_ushort(__float2half_rn(x16));
  return __half2float(__ushort_as_half(__ldg(lut + (bits & 0x7FFF))));
}

struct Params {
  const void* q;        // (B, Hkv, G, D) T
  const void* k;        // fp: (n_blocks, bs, Hkv, D) T; quant: codes
  const void* v;
  const __half* ks;     // quant: (n_blocks, bs, Hkv/gr, D/gc) scales
  const __half* vs;
  const int* table;     // (B, W)
  const int* lengths;   // (B,)
  const unsigned short* lut;  // (32768,) fp16 bit patterns
  const float* codebook;      // (16,) q4 codebook
  void* out;            // (B, Hkv, G, D) T
  int B, Hkv, G, D, bs, W, Hs, Ds, gr, gc, window;
  float scale, softcap;
};

// Bytes of one token's row (D values) for one KV head.
template <typename T, int LOADER>
__host__ __device__ __forceinline__ int row_bytes(int D) {
  return LOADER == kFp ? D * (int)sizeof(T) : (LOADER == kQ8 ? D : D / 2);
}

// Values per 16-byte chunk of a row.
template <typename T, int LOADER>
__device__ __forceinline__ constexpr int chunk_elems() {
  return LOADER == kFp ? 16 / (int)sizeof(T) : (LOADER == kQ8 ? 16 : 32);
}

// Decode one 16-byte chunk (values d0 .. d0 + chunk_elems - 1 of token t)
// into dst[t * D + d] as f32.
template <typename T, int LOADER, bool ROUND16>
__device__ __forceinline__ void decode_chunk(const Params& p, uint4 raw,
                                             const __half* scales,
                                             const float* cb, size_t slab,
                                             int h, int t, int d0,
                                             float* dst, int stride) {
  constexpr int E = chunk_elems<T, LOADER>();
  float* out = dst + t * stride + d0;
  if (LOADER == kFp) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i)
      out[i] = ROUND16 ? round_f16(to_f(e[i])) : to_f(e[i]);
    return;
  }
  const __half* srow = scales + (slab * p.Hs + h / p.gr) * p.Ds;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int d = d0 + i;
    const float s = __half2float(srow[d / p.gc]);
    float v;
    if (LOADER == kQ8) {
      v = (float)(int8_t)bytes[i] * s;
    } else {
      const uint8_t byte = bytes[i >> 1];
      v = cb[(i & 1) ? (byte >> 4) : (byte & 0xF)] * s;
    }
    out[i] = ROUND16 ? round_f16(v) : v;
  }
}

// Dequantize block `blk` of KV head h into kb (f32 rows of stride D + 1,
// so a warp reading one d across tokens hits distinct banks) and vb (rows
// of stride D).  Every thread issues all of its 16-byte K and V loads
// before decoding any, so a block costs one memory round trip.  The
// wrapper admits only 16-byte-aligned pools whose rows are a multiple of
// 16 bytes and whose blocks are at most kMaxChunks * kThreads chunks.
template <typename T, int LOADER, bool LUT>
__device__ __forceinline__ void load_block(const Params& p, const float* cb,
                                           int blk, int h, float* kb,
                                           float* vb) {
  constexpr int E = chunk_elems<T, LOADER>();
  const int tid = threadIdx.x;
  const int rb = row_bytes<T, LOADER>(p.D);
  const int cpr = rb / 16;
  const int nch = p.bs * cpr;
  uint4 rk[kMaxChunks], rv[kMaxChunks];
#pragma unroll
  for (int u = 0; u < kMaxChunks; ++u) {
    const int c = tid + u * kThreads;
    if (c < nch) {
      const int t = c / cpr, cc = c - t * cpr;
      const size_t off =
          (((size_t)blk * p.bs + t) * p.Hkv + h) * rb + (size_t)cc * 16;
      rk[u] = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const char*>(p.k) + off));
      rv[u] = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const char*>(p.v) + off));
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxChunks; ++u) {
    const int c = tid + u * kThreads;
    if (c < nch) {
      const int t = c / cpr, cc = c - t * cpr;
      const size_t slab = (size_t)blk * p.bs + t;
      decode_chunk<T, LOADER, false>(p, rk[u], p.ks, cb, slab, h, t, cc * E,
                                     kb, p.D + 1);
      decode_chunk<T, LOADER, LUT>(p, rv[u], p.vs, cb, slab, h, t, cc * E,
                                   vb, p.D);
    }
  }
}

template <typename T, int LOADER, bool LUT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int G = p.G, D = p.D, bs = p.bs;
  float* qs = smem;             // G*(D+1)
  float* kb = qs + G * (D + 1); // bs*(D+1)
  float* vb = kb + bs * (D + 1);  // bs*D
  float* ps = vb + bs * D;      // G*bs scores, then probabilities
  float* acc = ps + G * bs;     // G*D
  float* m_s = acc + G * D;     // G (fp16 values in LUT mode)
  float* l_s = m_s + G;         // G
  float* corr_s = l_s + G;      // G
  float* cb = corr_s + G;       // 16

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = p.lengths[b];
  const int window = p.window;

  const T* q = static_cast<const T*>(p.q) + (size_t)(b * p.Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[(i / D) * (D + 1) + i % D] = to_f(q[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = LUT ? kNegCap : kNegInf;
    l_s[g] = 0.f;
  }
  if (LOADER == kQ4 && tid < 16) cb[tid] = p.codebook[tid];

  // live blocks: [first valid position / bs, ceil(len / bs)), never past
  // the table's width
  const int nblk = min((len + bs - 1) / bs, p.W);
  int jb0 = 0;
  if (window > 0 && len > window) jb0 = (len - window) / bs;
  const int qpos = len - 1;

  for (int j = jb0; j < nblk; ++j) {
    const int blk = p.table[(size_t)b * p.W + j];
    __syncthreads();  // previous block's kb/vb/ps are consumed
    load_block<T, LOADER, LUT>(p, cb, blk, h, kb, vb);
    __syncthreads();

    // scores s[g][t] = scale * <q_g, k_t>, one thread per (g, t) pair
    for (int pair = tid; pair < G * bs; pair += blockDim.x) {
      const int g = pair / bs, t = pair - g * bs;
      const float* qr = qs + g * (D + 1);
      const float* kr = kb + t * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot * p.scale;
      if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
      ps[pair] = s;
    }
    __syncthreads();

    // online-softmax update: 16 lanes per query head, each over positions
    // t = lane16, lane16 + 16, ...; every lane runs the same number of
    // passes so the 16-lane shuffles always see a full warp
    for (int g0 = 0; g0 < G; g0 += blockDim.x >> 4) {
      const int g = g0 + (tid >> 4), l16 = tid & 15;
      const bool act = g < G;
      float* row = ps + (act ? g : 0) * bs;
      const float m_prev = act ? m_s[g] : 0.f;
      float m_new = m_prev;
      for (int t = l16; t < bs; t += 16) {
        const int pos = j * bs + t;
        const bool valid = pos < len && (window <= 0 || qpos - pos < window);
        const float s = valid ? (LUT ? round_f16(row[t]) : row[t])
                              : (LUT ? kNegCap : kNegInf);
        if (act) row[t] = s;
        m_new = fmaxf(m_new, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
      float sum = 0.f;
      for (int t = l16; t < bs; t += 16) {
        const int pos = j * bs + t;
        const bool valid = pos < len && (window <= 0 || qpos - pos < window);
        float pt = 0.f;
        if (valid) pt = LUT ? lut_exp(p.lut, row[t] - m_new)
                            : expf(row[t] - m_new);
        if (act) row[t] = pt;
        sum += pt;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (act && l16 == 0) {
        const float corr = LUT ? lut_exp(p.lut, m_prev - m_new)
                               : expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        corr_s[g] = corr;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_t p[g][t] * v[t][d]
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* row = ps + g * bs;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv = fmaf(row[t], vb[t * D + d], pv);
      acc[i] = acc[i] * corr_s[g] + pv;
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out) + (size_t)(b * p.Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    out[i] = from_f<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int LOADER, bool LUT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t floats = (size_t)p.G * (p.D + 1) + (size_t)p.G * p.D +
                        (size_t)p.bs * (p.D + 1) + (size_t)p.bs * p.D +
                        (size_t)p.G * p.bs + 3 * (size_t)p.G + 16;
  const size_t smem = floats * sizeof(float);
  auto kern = paged_attention_kernel<T, LOADER, LUT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(p.Hkv, p.B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int loader, int lut, const Params& p, cudaStream_t s) {
  switch (loader * 2 + (lut ? 1 : 0)) {
    case kFp * 2: return launch<T, kFp, false>(p, s);
    case kFp * 2 + 1: return launch<T, kFp, true>(p, s);
    case kQ8 * 2: return launch<T, kQ8, false>(p, s);
    case kQ8 * 2 + 1: return launch<T, kQ8, true>(p, s);
    case kQ4 * 2: return launch<T, kQ4, false>(p, s);
    case kQ4 * 2 + 1: return launch<T, kQ4, true>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (q, fp pools and the output).
// loader: 0 fp pool, 1 q8 codes, 2 packed q4 codes.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int paged_attention_launch(
    int dtype, int loader, int lut, const void* q, const void* k,
    const void* v, const void* k_scales, const void* v_scales,
    const void* table, const void* lengths, const void* lut_table,
    const void* codebook, void* out, int B, int Hkv, int G, int D, int bs,
    int W, int Hs, int Ds, int gr, int gc, int window, float scale,
    float softcap, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const __half*>(k_scales);
  p.vs = static_cast<const __half*>(v_scales);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.lut = static_cast<const unsigned short*>(lut_table);
  p.codebook = static_cast<const float*>(codebook);
  p.out = out;
  p.B = B;
  p.Hkv = Hkv;
  p.G = G;
  p.D = D;
  p.bs = bs;
  p.W = W;
  p.Hs = Hs;
  p.Ds = Ds;
  p.gr = gr;
  p.gc = gc;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(loader, lut, p, s);
    case 1: return (int)dispatch<__half>(loader, lut, p, s);
    case 2: return (int)dispatch<__nv_bfloat16>(loader, lut, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
