// Paged single-query decode attention for Hopper (sm_90a), split over KV.
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  src/repro/kernels/paged_attention.py  paged_attention        (fp pool)
//   K2  src/repro/kernels/paged_attention.py  quant_paged_attention  (Q8/Q4 pool)
// with one source templated on the block loader (fp / q8 / q4) and the exp
// mode (exact f32 recurrence / the paper's fp16 LUT recurrence, Alg. 1).
//
// What bounds it on the H100: at serving shapes (B = 8 rows, Hkv = 2, G = 6
// query heads per KV head, D = 128, 16-token blocks, a few hundred tokens
// per row) the work is tiny: a step reads well under a megabyte.  A thread
// block per (row, KV head) gives 16 blocks for 132 SMs, each walking its
// row's blocks one after another, so the time is latency: the number of
// dependent block steps in the longest chain.  The design cuts that chain.
//
// Design: split-KV.  Split s of S covers the fixed table range
// [s * per, (s + 1) * per), per = ceil(W / S), intersected with the row's
// live blocks [max(0, len - window) / bs, ceil(len / bs)); S comes from the
// shapes (B, Hkv, W) alone (the wrapper's ``splits``).  With S > 1 a call is
// three launches:
//   1. score: each split dequantizes its blocks' K and writes the masked
//      scores (f32; LUT mode: rounded to fp16, NEG_CAP where masked) and
//      each block's maximum over its positions;
//   2. attend: each split starts from m = the maximum of the block maxima of
//      the live blocks before it (a max rounds nothing, so this is the very
//      running max of the sequential recurrence, in fp16 in LUT mode), with
//      l = 0, acc = 0, and runs the recurrence over its own blocks from the
//      stored scores and its V, keeping C_s, the f32 product of its corr
//      values; it writes (acc_s, l_s, C_s);
//   3. fold, one thread per output element: acc <- acc * C_s + acc_s and
//      l <- l * C_s + l_s in split order, out = acc / max(l, 1e-30).
// Every p and corr is then the value of the sequential recurrence; only the
// f32 sums are reassociated.  Fixed order everywhere, no atomics: two calls
// give the same bits.  A split with no live blocks writes C = 1, l = 0,
// acc = 0 and changes nothing; a zero-length row returns exactly 0.  With
// S = 1 one fused launch scores and attends and writes the output.
//
// Inside a thread block (128 threads) a K/V block is loaded with every
// thread's chunk loads in flight at once, the next block's loads issued
// before the current block is computed, and dequantized into shared memory
// as f32 (Q8: code * scale, Q4: the 16-entry codebook; the scale index is
// a shift, tile groups being powers of two).  Scores are warp-cooperative:
// 8 lanes per token split D (dims part + 8 i, conflict-free through a row
// stride of 8 mod 32 banks), each warp 4 tokens per pass, 3 shuffles per
// (head, token), three heads at once so their chains overlap.  16 lanes
// per query head run the online-softmax update; a thread updates three
// (head, dim) elements of acc at once.  The 64 KiB exp LUT is read
// through the read-only cache.
//
// A chunk is 16 bytes of a row.  Quantized rows that are not a multiple of
// 16 bytes (stablelm-3b's Q4 rows: head_dim 80, 40 bytes) and scale groups
// too narrow for a 16-byte chunk load in 4-byte chunks instead: the same
// code with twice the chunks per thread, chosen at launch by the wrapper.
// Rows of a multiple of 16 bytes keep the 16-byte chunks.
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
constexpr int kMaxChunks4 = 8; // 4-byte chunks per thread (narrow rows)
constexpr int kMaxDims = 32;   // head_dim / 8 per score lane (D <= 256)
constexpr int kMaxScores = 4;  // G * bs <= kMaxScores * kThreads
constexpr int kMaxSplits = 16;
constexpr int kHeads = 3;      // query heads scored together by a lane
constexpr int kAcc = 3;        // acc elements updated together by a thread

enum Loader { kFp = 0, kQ8 = 1, kQ4 = 2 };
enum Phase { kFused = 0, kScore = 1, kAttend = 2 };

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
  float* scores;        // (B, Hkv, G, W * bs) masked scores    (S > 1)
  float* bmax;          // (B, Hkv, G, W) block maxima          (S > 1)
  float* pacc;          // (B, Hkv, S, G, D) split accumulators (S > 1)
  float* pl;            // (B, Hkv, S, G) split sums l_s
  float* pc;            // (B, Hkv, S, G) split corr products C_s
  int B, Hkv, G, D, bs, W, Hs, Ds, gr_shift, gc_shift, window, S;
  float scale, softcap;
};

// Bytes of one token's row (D values) for one KV head.
template <typename T, int LOADER>
__host__ __device__ __forceinline__ int row_bytes(int D) {
  return LOADER == kFp ? D * (int)sizeof(T) : (LOADER == kQ8 ? D : D / 2);
}

// Values per CB-byte chunk of a row.
template <typename T, int LOADER, int CB>
__device__ __forceinline__ constexpr int chunk_elems() {
  return LOADER == kFp ? CB / (int)sizeof(T) : (LOADER == kQ8 ? CB : 2 * CB);
}

// A chunk in registers, its load, and the chunks a thread holds.
template <int CB> struct Chunk;
template <> struct Chunk<16> {
  using type = uint4;
  static constexpr int per_thread = kMaxChunks;
};
template <> struct Chunk<4> {
  using type = uint32_t;
  static constexpr int per_thread = kMaxChunks4;
};

template <int CB>
__device__ __forceinline__ typename Chunk<CB>::type load_chunk(
    const char* src) {
  return __ldg(reinterpret_cast<const typename Chunk<CB>::type*>(src));
}

// score-row stride in floats: >= D and 8 mod 32, so the 4 tokens x 8 dims
// a warp reads at once fall in 32 distinct banks
__host__ __device__ __forceinline__ int k_stride(int D) {
  return D + ((8 - D % 32) + 32) % 32;
}

// Decode one CB-byte chunk (values d0 .. d0 + E - 1 of token t) into
// dst[t * stride + d] as f32; `sc` holds the chunk's f16 scales (element i
// takes scale i >> gc_shift, or the one scale when a group covers the
// chunk).
template <typename T, int LOADER, int CB, bool ROUND16>
__device__ __forceinline__ void decode_chunk(const Params& p,
                                             typename Chunk<CB>::type raw,
                                             uint2 sc, const float* cb,
                                             int t, int d0, float* dst,
                                             int stride) {
  constexpr int E = chunk_elems<T, LOADER, CB>();
  float* out = dst + t * stride + d0;
  if constexpr (LOADER == kFp) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i)
      out[i] = ROUND16 ? round_f16(to_f(e[i])) : to_f(e[i]);
  } else {
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
    const bool one = (E >> p.gc_shift) <= 1;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = one ? 0 : (i >> p.gc_shift);
      const uint32_t word = j < 2 ? sc.x : sc.y;
      const float s = __half2float(__ushort_as_half(
          (unsigned short)((j & 1) ? word >> 16 : word & 0xFFFFu)));
      float v;
      if constexpr (LOADER == kQ8) {
        v = (float)(int8_t)bytes[i] * s;
      } else {
        const uint8_t byte = bytes[i >> 1];
        v = cb[(i & 1) ? (byte >> 4) : (byte & 0xF)] * s;
      }
      out[i] = ROUND16 ? round_f16(v) : v;
    }
  }
}

// The f16 scales of one chunk (at most 4; the wrapper admits only scale
// groups of >= E / 4 values), packed into a uint2.
template <typename T, int LOADER, int CB>
__device__ __forceinline__ uint2 load_scales(const Params& p,
                                             const __half* scales,
                                             size_t slab, int h, int d0) {
  uint2 r = make_uint2(0u, 0u);
  if constexpr (LOADER != kFp) {
    constexpr int E = chunk_elems<T, LOADER, CB>();
    const unsigned short* srow =
        reinterpret_cast<const unsigned short*>(scales) +
        (slab * p.Hs + (h >> p.gr_shift)) * p.Ds + (d0 >> p.gc_shift);
    const int n = max(1, E >> p.gc_shift);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < n ? __ldg(srow + i) : 0u;
    r.x = v[0] | (v[1] << 16);
    r.y = v[2] | (v[3] << 16);
  }
  return r;
}

// A block's loads in flight: each thread's K and V chunks, their scales,
// and (attend phase) its share of the stored scores.
template <int CB>
struct Inflight {
  typename Chunk<CB>::type k[Chunk<CB>::per_thread], v[Chunk<CB>::per_thread];
  uint2 ks[Chunk<CB>::per_thread], vs[Chunk<CB>::per_thread];
  float sc[kMaxScores];
};

// Issue the loads of table entry j (block blk) of KV head h: K when SCORE,
// V when ATTEND.  The wrapper admits only CB-byte-aligned pools whose rows
// are a multiple of CB bytes and whose blocks are at most
// Chunk<CB>::per_thread * kThreads chunks.
template <typename T, int LOADER, int CB, int PHASE>
__device__ __forceinline__ void issue_block(const Params& p, int blk, int j,
                                            int h, int bh, Inflight<CB>& f) {
  constexpr bool SCORE = PHASE != kAttend;
  constexpr bool ATTEND = PHASE != kScore;
  constexpr int E = chunk_elems<T, LOADER, CB>();
  const int rb = row_bytes<T, LOADER>(p.D);
  const int cpr = rb / CB;
  const int nch = p.bs * cpr;
#pragma unroll
  for (int u = 0; u < Chunk<CB>::per_thread; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c < nch) {
      const int t = c / cpr, cc = c - t * cpr;
      const size_t slab = (size_t)blk * p.bs + t;
      const size_t off = (slab * p.Hkv + h) * rb + (size_t)cc * CB;
      if (SCORE) {
        f.k[u] = load_chunk<CB>(static_cast<const char*>(p.k) + off);
        f.ks[u] = load_scales<T, LOADER, CB>(p, p.ks, slab, h, cc * E);
      }
      if (ATTEND) {
        f.v[u] = load_chunk<CB>(static_cast<const char*>(p.v) + off);
        f.vs[u] = load_scales<T, LOADER, CB>(p, p.vs, slab, h, cc * E);
      }
    }
  }
  if (PHASE == kAttend) {
    const int GB = p.G * p.bs;
#pragma unroll
    for (int u = 0; u < kMaxScores; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < GB) {
        const int g = i / p.bs, t = i - g * p.bs;
        f.sc[u] = __ldg(p.scores + ((size_t)bh * p.G + g) * p.W * p.bs +
                        j * p.bs + t);
      }
    }
  }
}

// Dequantize the block in flight into kb (rows of stride k_stride(D)) and
// vb (rows of stride D), and (attend phase) its scores into ps.
template <typename T, int LOADER, int CB, bool LUT, int PHASE>
__device__ __forceinline__ void decode_block(const Params& p, const float* cb,
                                             const Inflight<CB>& f, float* kb,
                                             float* vb, float* ps) {
  constexpr bool SCORE = PHASE != kAttend;
  constexpr bool ATTEND = PHASE != kScore;
  constexpr int E = chunk_elems<T, LOADER, CB>();
  const int cpr = row_bytes<T, LOADER>(p.D) / CB;
  const int nch = p.bs * cpr;
  const int ks = k_stride(p.D);
#pragma unroll
  for (int u = 0; u < Chunk<CB>::per_thread; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c < nch) {
      const int t = c / cpr, cc = c - t * cpr;
      if (SCORE)
        decode_chunk<T, LOADER, CB, false>(p, f.k[u], f.ks[u], cb, t, cc * E,
                                           kb, ks);
      if (ATTEND)
        decode_chunk<T, LOADER, CB, LUT>(p, f.v[u], f.vs[u], cb, t, cc * E,
                                         vb, p.D);
    }
  }
  if (PHASE == kAttend) {
#pragma unroll
    for (int u = 0; u < kMaxScores; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < p.G * p.bs) ps[i] = f.sc[u];
    }
  }
}

__device__ __forceinline__ bool valid_pos(int pos, int len, int window) {
  return pos < len && (window <= 0 || (len - 1) - pos < window);
}

// grid (Hkv, B, S); PHASE kFused (S = 1): score + attend + output;
// kScore: scores and block maxima; kAttend: the split's partial from the
// stored scores.
template <typename T, int LOADER, int CB, bool LUT, int PHASE>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  constexpr bool SCORE = PHASE != kAttend;
  constexpr bool ATTEND = PHASE != kScore;
  const float mask_val = LUT ? kNegCap : kNegInf;
  extern __shared__ float smem[];
  const int G = p.G, D = p.D, bs = p.bs;
  const int KS = k_stride(D);
  float* qs = smem;             // G*D
  float* kb = qs + G * D;       // bs*KS
  float* vb = kb + bs * KS;     // bs*D
  float* ps = vb + bs * D;      // G*bs masked scores, then probabilities
  float* acc = ps + G * bs;     // G*D
  float* m_s = acc + G * D;     // G (fp16 values in LUT mode)
  float* l_s = m_s + G;         // G
  float* corr_s = l_s + G;      // G
  float* c_s = corr_s + G;      // G: product of corr over the split
  float* cb = c_s + G;          // 16

  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = b * p.Hkv + h;
  const int len = p.lengths[b];
  const int window = p.window;
  const int WB = p.W * bs;

  // live blocks [jb0, nblk), never past the table's width; this split's
  // share [j_begin, j_end)
  const int nblk = min((len + bs - 1) / bs, p.W);
  const int jb0 = (window > 0 && len > window) ? (len - window) / bs : 0;
  const int per = (p.W + p.S - 1) / p.S;
  const int j_begin = max(jb0, s * per);
  const int j_end = min(nblk, (s + 1) * per);

  // the first block's loads go out before the set-up below
  Inflight<CB> f;
  const int* row_table = p.table + (size_t)b * p.W;
  if (j_begin < j_end)
    issue_block<T, LOADER, CB, PHASE>(p, row_table[j_begin], j_begin, h, bh,
                                      f);
  int blk_next = j_begin + 1 < j_end ? row_table[j_begin + 1] : 0;

  if (SCORE) {
    const T* q = static_cast<const T*>(p.q) + (size_t)bh * G * D;
    for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f(q[i]);
  }
  if (ATTEND) {
    for (int i = tid; i < G * D; i += kThreads) acc[i] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      float m = mask_val;
      if (PHASE == kAttend)  // the running max entering this split
        for (int j = jb0; j < j_begin; ++j)
          m = fmaxf(m, p.bmax[((size_t)bh * G + g) * p.W + j]);
      m_s[g] = m;
      l_s[g] = 0.f;
      c_s[g] = 1.f;
    }
  }
  if (LOADER == kQ4 && tid < 16) cb[tid] = p.codebook[tid];

  for (int j = j_begin; j < j_end; ++j) {
    __syncthreads();  // previous block's kb/vb/ps are consumed (qs, cb set)
    decode_block<T, LOADER, CB, LUT, PHASE>(p, cb, f, kb, vb, ps);
    if (j + 1 < j_end) {  // in flight while this block is computed
      issue_block<T, LOADER, CB, PHASE>(p, blk_next, j + 1, h, bh, f);
      blk_next = j + 2 < j_end ? row_table[j + 2] : 0;
    }
    __syncthreads();

    if (SCORE) {
      // s[g][t] = scale * <q_g, k_t>: 8 lanes per token, 4 tokens per warp
      const int part = lane & 7, nd = D >> 3;
      for (int t0 = warp * 4; t0 < bs; t0 += 16) {
        const int t = t0 + (lane >> 3);
        const bool tv = t < bs;
        float kr[kMaxDims];
#pragma unroll
        for (int i = 0; i < kMaxDims; ++i)
          if (i < nd) kr[i] = tv ? kb[t * KS + part + 8 * i] : 0.f;
        const bool valid = tv && valid_pos(j * bs + t, len, window);
        // kHeads query heads at once: independent FMA and shuffle chains
        for (int g0 = 0; g0 < G; g0 += kHeads) {
          float dot[kHeads];
#pragma unroll
          for (int u = 0; u < kHeads; ++u) dot[u] = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxDims; ++i)
            if (i < nd)
#pragma unroll
              for (int u = 0; u < kHeads; ++u)
                dot[u] = fmaf(qs[min(g0 + u, G - 1) * D + part + 8 * i],
                              kr[i], dot[u]);
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
#pragma unroll
            for (int u = 0; u < kHeads; ++u)
              dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
#pragma unroll
          for (int u = 0; u < kHeads; ++u) {
            const int g = g0 + u;
            if (part == 0 && tv && g < G) {
              float sc = dot[u] * p.scale;
              if (p.softcap != 0.f) sc = tanhf(sc / p.softcap) * p.softcap;
              ps[g * bs + t] = valid ? (LUT ? round_f16(sc) : sc) : mask_val;
            }
          }
        }
      }
      __syncthreads();
      if (PHASE == kScore) {
        for (int i = tid; i < G * bs; i += kThreads) {
          const int g = i / bs, t = i - g * bs;
          p.scores[((size_t)bh * G + g) * WB + j * bs + t] = ps[i];
        }
      }
    }

    // 16 lanes per query head over positions t = lane16, lane16 + 16, ...;
    // every lane runs the same number of passes so the 16-lane shuffles
    // always see a full warp
    for (int g0 = 0; g0 < G; g0 += kThreads >> 4) {
      const int g = g0 + (tid >> 4), l16 = tid & 15;
      const bool act = g < G;
      float* row = ps + (act ? g : 0) * bs;
      float m_blk = mask_val;
      for (int t = l16; t < bs; t += 16) m_blk = fmaxf(m_blk, row[t]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, off));
      if (PHASE == kScore) {
        if (act && l16 == 0) p.bmax[((size_t)bh * G + g) * p.W + j] = m_blk;
        continue;
      }
      const float m_prev = act ? m_s[g] : 0.f;
      const float m_new = fmaxf(m_prev, m_blk);
      float sum = 0.f;
      for (int t = l16; t < bs; t += 16) {
        float pt = 0.f;
        if (valid_pos(j * bs + t, len, window))
          pt = LUT ? lut_exp(p.lut, row[t] - m_new) : expf(row[t] - m_new);
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
        c_s[g] *= corr;
        m_s[g] = m_new;
      }
    }
    if (!ATTEND) continue;
    __syncthreads();

    // acc[g][d] = acc * corr + sum_t p[g][t] * v[t][d], kAcc elements a
    // thread at once (independent chains)
    for (int i0 = tid; i0 < G * D; i0 += kAcc * kThreads) {
      int g[kAcc], d[kAcc];
      float pv[kAcc];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) {
        const int i = min(i0 + u * kThreads, G * D - 1);
        g[u] = i / D;
        d[u] = i - g[u] * D;
        pv[u] = 0.f;
      }
      for (int t = 0; t < bs; ++t)
#pragma unroll
        for (int u = 0; u < kAcc; ++u)
          pv[u] = fmaf(ps[g[u] * bs + t], vb[t * D + d[u]], pv[u]);
#pragma unroll
      for (int u = 0; u < kAcc; ++u) {
        const int i = i0 + u * kThreads;
        if (i < G * D) acc[i] = acc[i] * corr_s[g[u]] + pv[u];
      }
    }
  }
  if (!ATTEND) return;
  __syncthreads();

  if (PHASE == kFused) {
    T* out = static_cast<T*>(p.out) + (size_t)bh * G * D;
    for (int i = tid; i < G * D; i += kThreads)
      out[i] = from_f<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
    return;
  }
  const size_t split = (size_t)bh * p.S + s;
  for (int i = tid; i < G * D; i += kThreads)
    p.pacc[split * G * D + i] = acc[i];
  for (int g = tid; g < G; g += kThreads) {
    p.pl[split * G + g] = l_s[g];
    p.pc[split * G + g] = c_s[g];
  }
}

// One thread per output element: fold the S splits in order.  Every
// split's partial is loaded before the first is folded, so one memory
// round trip serves the whole fold.
template <typename T>
__global__ void __launch_bounds__(kThreads) fold_kernel(Params p) {
  const int GD = p.G * p.D;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.B * p.Hkv * GD) return;
  const int bh = e / GD, i = e - bh * GD, g = i / p.D;
  float c[kMaxSplits], l[kMaxSplits], a[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < p.S) {
      const size_t split = (size_t)bh * p.S + s;
      c[s] = p.pc[split * p.G + g];
      l[s] = p.pl[split * p.G + g];
      a[s] = p.pacc[split * GD + i];
    }
  float acc = 0.f, sum = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < p.S) {
      acc = acc * c[s] + a[s];
      sum = sum * c[s] + l[s];
    }
  static_cast<T*>(p.out)[e] = from_f<T>(acc / fmaxf(sum, 1e-30f));
}

size_t smem_bytes(const Params& p) {
  const size_t floats = (size_t)p.G * p.D * 2 + (size_t)p.bs * k_stride(p.D) +
                        (size_t)p.bs * p.D + (size_t)p.G * p.bs +
                        4 * (size_t)p.G + 16;
  return floats * sizeof(float);
}

template <typename T, int LOADER, int CB, bool LUT, int PHASE>
cudaError_t launch_phase(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p);
  auto kern = paged_attention_kernel<T, LOADER, CB, LUT, PHASE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(p.Hkv, p.B, PHASE == kFused ? 1 : p.S);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int LOADER, int CB, bool LUT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.S == 1) return launch_phase<T, LOADER, CB, LUT, kFused>(p, stream);
  cudaError_t e = launch_phase<T, LOADER, CB, LUT, kScore>(p, stream);
  if (e != cudaSuccess) return e;
  e = launch_phase<T, LOADER, CB, LUT, kAttend>(p, stream);
  if (e != cudaSuccess) return e;
  const int n = p.B * p.Hkv * p.G * p.D;
  fold_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int loader, int lut, int chunk, const Params& p,
                     cudaStream_t s) {
  if (chunk == 16) {
    switch (loader * 2 + (lut ? 1 : 0)) {
      case kFp * 2: return launch<T, kFp, 16, false>(p, s);
      case kFp * 2 + 1: return launch<T, kFp, 16, true>(p, s);
      case kQ8 * 2: return launch<T, kQ8, 16, false>(p, s);
      case kQ8 * 2 + 1: return launch<T, kQ8, 16, true>(p, s);
      case kQ4 * 2: return launch<T, kQ4, 16, false>(p, s);
      case kQ4 * 2 + 1: return launch<T, kQ4, 16, true>(p, s);
    }
  } else if (chunk == 4) {  // quantized rows only
    switch (loader * 2 + (lut ? 1 : 0)) {
      case kQ8 * 2: return launch<T, kQ8, 4, false>(p, s);
      case kQ8 * 2 + 1: return launch<T, kQ8, 4, true>(p, s);
      case kQ4 * 2: return launch<T, kQ4, 4, false>(p, s);
      case kQ4 * 2 + 1: return launch<T, kQ4, 4, true>(p, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (q, fp pools and the output).
// loader: 0 fp pool, 1 q8 codes, 2 packed q4 codes.  scratch: S > 1 only,
// f32 of B*Hkv*(G*W*bs + G*W + S*G*D + 2*S*G) floats (scores, block
// maxima, split accumulators, l_s, C_s).  gr_shift, gc_shift: log2 of the
// scale tile.  chunk: 16 or (q8/q4 only) 4, the bytes of a row each load
// takes.  Returns the CUDA error code of the launches (0 on success).
extern "C" int paged_attention_launch(
    int dtype, int loader, int lut, int chunk, const void* q, const void* k,
    const void* v, const void* k_scales, const void* v_scales,
    const void* table, const void* lengths, const void* lut_table,
    const void* codebook, void* out, void* scratch, int B, int Hkv, int G,
    int D, int bs, int W, int Hs, int Ds, int gr_shift, int gc_shift,
    int window, int splits, float scale, float softcap, void* stream) {
  if (splits < 1 || splits > kMaxSplits || D % 8 || D > 8 * kMaxDims ||
      G * bs > kMaxScores * kThreads || (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
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
  const size_t bh = (size_t)B * Hkv;
  p.scores = static_cast<float*>(scratch);
  p.bmax = p.scores ? p.scores + bh * G * W * bs : nullptr;
  p.pacc = p.bmax ? p.bmax + bh * G * W : nullptr;
  p.pl = p.pacc ? p.pacc + bh * splits * G * D : nullptr;
  p.pc = p.pl ? p.pl + bh * splits * G : nullptr;
  p.B = B;
  p.Hkv = Hkv;
  p.G = G;
  p.D = D;
  p.bs = bs;
  p.W = W;
  p.Hs = Hs;
  p.Ds = Ds;
  p.gr_shift = gr_shift;
  p.gc_shift = gc_shift;
  p.window = window;
  p.S = splits;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(loader, lut, chunk, p, s);
    case 1: return (int)dispatch<__half>(loader, lut, chunk, p, s);
    case 2: return (int)dispatch<__nv_bfloat16>(loader, lut, chunk, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
