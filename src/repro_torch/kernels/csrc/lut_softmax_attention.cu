// LUT-softmax FlashAttention (paper Alg. 1) for Hopper (sm_90a), on the
// tensor cores.
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
// (__float2half_rn); m kept in fp16; x = s16 - m_new by __hsub2; p and the
// correction factor e^(m_prev - m_new) from the exp mode, rounded to fp16;
// l and acc in f32 (l * corr and acc * corr rounded on their own, then
// sum p and p.v accumulated onto them); out = acc / max(l, 1e-30).  m is
// rounded once per KV block, so the block length bkv is part of the
// function: it is a runtime argument (any divisor of Skv up to kMaxBkv,
// odd ones too), and a warp forms its rows' scores over the whole
// block before it takes their max.  The exact mode uses expf (not __expf),
// and the file is built without fast math.  The poly mode uses floorf,
// writes its Horner steps with __fmul_rn / __fadd_rn so that nvcc cannot
// contract them into FMAs, and scales by 2^k with one exact multiply
// (what ldexpf gives here).  q.k, p.v and sum p run on the tensor cores
// (mma.sync.m16n8k16, fp16 in, f32 accumulate): the products of two fp16
// values are exact, only the order of the sums differs from the plain
// version's, which can move an fp16-rounded score by one step.
//
// What bounds it on the H100: operations.  At qwen2.5-1.5b's prefill
// geometry (12 query heads, 2 KV heads, head_dim 128, 2048 tokens) the
// causal product is ~13 GFLOP against ~15 MB of q, k, v and out, far above
// the card's ~295 flops-per-byte ridge.  In practice the CUDA cores'
// instruction stream bounds it: beside the tensor-core products every
// score takes a scale, an fp16 rounding, an fp16 subtract and an exp (a
// table gather, ~17 f32 steps in poly, MUFU in exact), and with 2 blocks
// of 4 warps per SM (~250 registers a thread) little of their latency is
// hidden (PERF.md: variant builds and SASS counts).
//
// Design: one thread block of 4 warps per (bh, 64 query rows), each warp
// owning 16 rows; causal tiles are launched heaviest (last rows) first.
// A loop over the KV blocks of bkv rows; per block, K and V go into
// shared memory with cp.async, rows XOR-swizzled by 16-byte chunk so that
// ldmatrix reads 8 rows without bank conflicts: K of the next block loads
// while this block's p.v runs, V of the next block while its scores are
// formed.  bkv is padded to the mma's k step of 16 (79 -> 80): the padded
// rows of K and V are zero-filled once, the padded columns enter neither
// the max nor l and give p = 0 exactly.  Per block a warp:
//   1. forms S = q.k^T (q in registers as A fragments, K through ldmatrix)
//      four k steps (eight independent mma chains) at a time, scales and
//      rounds each score to fp16 at once and keeps the block's S as packed
//      half2 (<= 64 registers for bkv <= 256);
//   2. takes each row's fp16 max over the block (__hmax2, quad shuffles),
//      m_new, p = exp(s - m_new) in place of S and the correction factor,
//      and scales its f32 acc by it (skipped when every corr is 1);
//   3. accumulates p.v and the row sums l on the tensor cores: the m16n8 C
//      fragment of S is laid out as the m16k16 A fragment of P, so p feeds
//      the mma without a shuffle, V comes through ldmatrix.trans, and l is
//      p times a column of ones.
// A block whose every k step the warp takes, with no mask and no padding,
// runs a copy of steps 1-3 without the per-step guards.  A causal warp
// stops at the last KV block, and within it at the last 16-column step,
// that its rows can see: a step that the mask covers for every row of the
// warp gives p = exp(-30000 - m) = 0 and corr = exp(0) = 1 in every mode,
// so skipping it changes nothing (every row's first block holds kpos 0,
// so m has left NEG_CAP by then).  The 64 KiB LUT is read either through
// the read-only cache (__ldg) or, staged once per block, from shared
// memory (lut_smem), which leaves room for one block per SM: the wrapper
// stages it when the grid fits in one such wave.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegCap = -30000.0f;  // finite fp16 "-inf"; LUT gives 0
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per thread block
constexpr int kMaxBkv = 256;        // longest KV block (S in registers)
constexpr int kLutBytes = 32768 * 2;

enum ExpMode { kLut = 0, kPoly = 1, kExact = 2 };

// exp of an fp16 value <= 0, rounded to fp16
template <int MODE, bool LUT_SMEM>
__device__ __forceinline__ __half exp16(__half x,
                                        const unsigned short* __restrict__ lut) {
  if constexpr (MODE == kLut) {
    const int i = __half_as_ushort(x) & 0x7FFF;
    return __ushort_as_half(LUT_SMEM ? lut[i] : __ldg(lut + i));
  } else if constexpr (MODE == kPoly) {
    // constants rounded from double to float, as the reference rounds them
    const float y = __fmul_rn(__half2float(x), (float)1.4426950408889634);
    const float k = floorf(y);
    const float t = __fmul_rn(__fsub_rn(y, k), (float)0.6931471805599453);
    float p = __fadd_rn((float)(1.0 / 6.0), __fmul_rn(t, (float)(1.0 / 24.0)));
    p = __fadd_rn(0.5f, __fmul_rn(t, p));
    p = __fadd_rn(1.0f, __fmul_rn(t, p));
    p = __fadd_rn(1.0f, __fmul_rn(t, p));
    // ldexpf(p, k) for p in [1, 2) and k <= 0: for k >= -126, 2^k is a
    // normal f32 and p * 2^k is exact; below, ldexpf gives less than
    // 2^-125, which rounds to fp16 0 as this does
    if (k < -126.f) return __float2half_rn(0.f);
    return __float2half_rn(
        __fmul_rn(p, __int_as_float(((int)k + 127) << 23)));
  } else {
    return __float2half_rn(expf(__half2float(x)));
  }
}

__device__ __forceinline__ uint32_t as_u32(__half2 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ __half2 as_h2(uint32_t u) {
  return *reinterpret_cast<__half2*>(&u);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a K or V tile of D fp16 per
// row.  XOR swizzle: the 8 rows one ldmatrix reads at one chunk fall in 8
// distinct 16-byte bank groups (rows of 128 or 256 bytes: c ^ (r & 7);
// 64-byte rows, two to a 128-byte line: c ^ ((r >> 1) & 3)).
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kCh = D / 8;
  const int s = kCh >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));
  return (uint32_t)((r * kCh + s) * 16);
}

// rows [0, rows) of a K or V block into its shared tile, one 16-byte
// cp.async per chunk
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const __half* g,
                                          int rows, int tid) {
  constexpr int kCh = D / 8;
  for (int i = tid; i < rows * kCh; i += kThreads) {
    const int r = i / kCh, c = i % kCh;
    cp_async16(tile + swz<D>(r, c), g + (size_t)r * D + c * 8);
  }
}

// a compile-time flag passed to the block's generic lambdas
template <bool B> struct Full { static constexpr bool value = B; };

struct Params {
  const __half* q;            // (BH, Sq, D)
  const __half* k;            // (BH / G, Skv, D)
  const __half* v;
  const unsigned short* lut;  // (32768,) fp16 bit patterns (lut mode)
  __half* out;                // (BH, Sq, D)
  int Sq, Skv, G, bkv, causal;
  float scale;
};

__host__ __device__ inline int tile_bytes(int bkv, int D) {
  return ((bkv + 15) / 16) * 16 * D * 2;  // bkv padded to 16 rows
}

// NKT: the most 16-column steps of a KV block (bkv <= 16 * NKT), which
// sizes the warp's register copy of S.
template <int D, int NKT, int MODE, bool LUT_SMEM>
__global__ void __launch_bounds__(kThreads)
    lut_softmax_attention_kernel(Params p) {
  constexpr int kCh = D / 8;   // 16-byte chunks per K / V row
  constexpr int kKd = D / 16;  // k steps of q.k^T
  constexpr int kNd = D / 8;   // n8 tiles of p.v
  extern __shared__ __align__(128) unsigned char smem[];
  const int bkv = p.bkv;
  const int nkt = (bkv + 15) >> 4;
  const int tb = tile_bytes(bkv, D);
  const uint32_t ks = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t vs = ks + tb;
  const unsigned short* lut =
      LUT_SMEM ? reinterpret_cast<const unsigned short*>(smem + 2 * tb)
               : p.lut;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int bh = blockIdx.x;
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows;
  const int r0 = q0 + warp * 16;                // the warp's first row
  const int last = min(r0 + 15, p.Sq - 1);      // < r0: the warp has none
  const int cta_last = min(q0 + kRows, p.Sq) - 1;
  const size_t kv_base = (size_t)(bh / p.G) * p.Skv * D;
  const __half* kg = p.k + kv_base;
  const __half* vg = p.v + kv_base;

  int nblk = p.Skv / bkv;
  if (p.causal) nblk = min(nblk, cta_last / bkv + 1);

  // the padded rows of K and V are zero (0 x stale bits could be NaN);
  // the copies below never write them
  for (int i = tid; i < (nkt * 16 - bkv) * kCh; i += kThreads) {
    const int r = bkv + i / kCh, c = i % kCh;
    *reinterpret_cast<uint4*>(smem + swz<D>(r, c)) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(smem + tb + swz<D>(r, c)) =
        make_uint4(0, 0, 0, 0);
  }
  if constexpr (LUT_SMEM) {
    for (int i = tid; i < kLutBytes / 16; i += kThreads)
      cp_async16(ks + 2 * tb + i * 16, p.lut + i * 8);
  }
  load_tile<D>(ks, kg, bkv, tid);
  cp_commit();
  load_tile<D>(vs, vg, bkv, tid);
  cp_commit();

  // q as m16k16 A fragments: rows g and g + 8, columns 2t.. and 2t + 8..
  uint32_t qa[kKd][4];
  {
    const __half* qg = p.q + (size_t)bh * p.Sq * D;
    const int ra = r0 + g, rb = ra + 8;
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      const int c = kk * 16 + 2 * t;
      auto ld = [&](int r, int col) -> uint32_t {
        return r < p.Sq ? __ldg(reinterpret_cast<const unsigned int*>(
                              qg + (size_t)r * D + col))
                        : 0u;
      };
      qa[kk][0] = ld(ra, c);
      qa[kk][1] = ld(rb, c);
      qa[kk][2] = ld(ra, c + 8);
      qa[kk][3] = ld(rb, c + 8);
    }
  }

  float acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_row[2] = {kNegCap, kNegCap};  // rows g, g + 8; fp16 values
  float l_row[2] = {0.f, 0.f};
  // S, then P, of the block: [k step][n8 half][row g / g + 8], half2 each
  uint32_t s[NKT][2][2];

  // ldmatrix lane addresses: lane l gives row l & 7 of matrix l >> 3.
  // K (x4 = two n8 tiles' B fragments at one k step): rows (lm >> 1) * 8,
  // chunk lm & 1; V (.trans, two n8 tiles of D): rows (lm & 1) * 8, chunk
  // lm >> 1.  A k step's 16 rows keep each row's swizzle, so a lane's
  // address at k step kt is one of these plus kt * kStep.
  const int lr = lane & 7, lm = lane >> 3;
  uint32_t k_off[kKd], v_off[kNd / 2];
#pragma unroll
  for (int kk = 0; kk < kKd; ++kk)
    k_off[kk] = ks + swz<D>((lm >> 1) * 8 + lr, 2 * kk + (lm & 1));
#pragma unroll
  for (int np = 0; np < kNd / 2; ++np)
    v_off[np] = vs + swz<D>((lm & 1) * 8 + lr, 2 * np + (lm >> 1));
  constexpr uint32_t kStep = 16 * D * 2;  // bytes of a k step's 16 rows

  for (int j = 0; j < nblk; ++j) {
    const int kv0 = j * bkv;
    const bool active = last >= r0 && (!p.causal || kv0 <= last);
    const int nkt_w = p.causal ? min(nkt, (last - kv0) / 16 + 1) : nkt;
    const bool masked = p.causal && kv0 + nkt_w * 16 - 1 > r0;
    cp_wait<1>();  // K of this block (and the LUT) has landed
    __syncthreads();

    // l in the m16n8 C layout (c0, c1: row g; c2, c3: row g + 8), summed
    // on the tensor cores as p times a column of ones
    float lsum[4];
    // a block whose every k step the warp takes, with no mask and no
    // padded column, runs without the guards (kFull)
    const bool full = nkt_w == NKT && !masked && !(bkv & 15);
    auto scores = [&](auto tag) {
      constexpr bool kFull = decltype(tag)::value;
      // 1. scores, four k steps (eight n8 tiles, eight independent mma
      // chains) at a time, rounded to fp16 as they are formed; the masked
      // columns (diagonal blocks only) and the padded columns of a block's
      // last k step are set to NEG_CAP, which leaves the max as it is
      // (m >= NEG_CAP)
      const int lim = r0 + g - kv0 - 2 * t;  // row g's last visible column
#pragma unroll
      for (int k4 = 0; k4 < NKT; k4 += 4) {
        if (kFull || k4 < nkt_w) {
          float c[4][2][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 8; ++e) c[u][e >> 2][e & 3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kKd; ++kk) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (kFull || k4 + u < nkt_w) {
                uint32_t b[4];
                ldsm_x4(b, k_off[kk] + (k4 + u) * kStep);
                mma16816(c[u][0], qa[kk], b[0], b[1]);
                mma16816(c[u][1], qa[kk], b[2], b[3]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int kt = k4 + u;
            if (kFull || kt < nkt_w) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  c[u][h][e] = __fmul_rn(c[u][h][e], p.scale);
                if (!kFull && masked) {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (kt * 16 + h * 8 + (e & 1) > lim + (e >> 1) * 8)
                      c[u][h][e] = kNegCap;
                }
                if (!kFull && kt == nkt - 1 && (bkv & 15)) {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (kt * 16 + h * 8 + 2 * t + (e & 1) >= bkv)
                      c[u][h][e] = kNegCap;
                }
                s[kt][h][0] = as_u32(__floats2half2_rn(c[u][h][0], c[u][h][1]));
                s[kt][h][1] = as_u32(__floats2half2_rn(c[u][h][2], c[u][h][3]));
              }
            }
          }
        }
      }
      // 2. fp16 row max over the block (exact in fp16), m_new, corr
      const __half2 neg = __float2half2_rn(kNegCap);
      __half2 mx2[2] = {neg, neg};
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        if (kFull || kt < nkt_w) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx2[0] = __hmax2(mx2[0], as_h2(s[kt][h][0]));
            mx2[1] = __hmax2(mx2[1], as_h2(s[kt][h][1]));
          }
        }
      }
      __half2 m_new2[2];
      float corr[2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float mx = fmaxf(__low2float(mx2[rh]), __high2float(mx2[rh]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const __half m_new = __float2half_rn(fmaxf(m_row[rh], mx));
        corr[rh] = __half2float(exp16<MODE, LUT_SMEM>(
            __hsub(__float2half_rn(m_row[rh]), m_new), lut));
        m_row[rh] = __half2float(m_new);
        m_new2[rh] = __half2half2(m_new);
      }
      // p = exp(s - m_new) in place of S; the padded columns give 0
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        if (kFull || kt < nkt_w) {
          const bool pad = !kFull && kt == nkt - 1 && (bkv & 15);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = kt * 16 + h * 8 + 2 * t;
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const __half2 x = __hsub2(as_h2(s[kt][h][rh]), m_new2[rh]);
              uint32_t pv = as_u32(__halves2half2(
                  exp16<MODE, LUT_SMEM>(__low2half(x), lut),
                  exp16<MODE, LUT_SMEM>(__high2half(x), lut)));
              if (pad) {
                if (col >= bkv) pv &= 0xFFFF0000u;
                if (col + 1 >= bkv) pv &= 0x0000FFFFu;
              }
              s[kt][h][rh] = pv;
            }
          }
        }
      }
      lsum[0] = lsum[1] = __fmul_rn(l_row[0], corr[0]);
      lsum[2] = lsum[3] = __fmul_rn(l_row[1], corr[1]);
      // acc * corr, skipped where every row's corr is 1 (x * 1 = x)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kNd; ++n) {
          acc[n][0] = __fmul_rn(acc[n][0], corr[0]);
          acc[n][1] = __fmul_rn(acc[n][1], corr[0]);
          acc[n][2] = __fmul_rn(acc[n][2], corr[1]);
          acc[n][3] = __fmul_rn(acc[n][3], corr[1]);
        }
      }
    };
    if (active) {
      if (full) scores(Full<true>{});
      else scores(Full<false>{});
    }
    __syncthreads();  // every warp is done with this block's K
    if (j + 1 < nblk) load_tile<D>(ks, kg + (size_t)(kv0 + bkv) * D, bkv, tid);
    cp_commit();
    cp_wait<1>();  // V of this block has landed
    __syncthreads();

    // 3. acc += p.v and l += sum p on the tensor cores
    auto attend = [&](auto tag) {
      constexpr bool kFull = decltype(tag)::value;
      constexpr uint32_t kOnes = 0x3C003C00u;  // half2 (1, 1)
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        if (kFull || kt < nkt_w) {
          const uint32_t a[4] = {s[kt][0][0], s[kt][0][1], s[kt][1][0],
                                 s[kt][1][1]};
          mma16816(lsum, a, kOnes, kOnes);
#pragma unroll
          for (int np = 0; np < kNd / 2; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, v_off[np] + kt * kStep);
            mma16816(acc[2 * np], a, b[0], b[1]);
            mma16816(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      l_row[0] = lsum[0];
      l_row[1] = lsum[2];
    };
    if (active) {
      if (full) attend(Full<true>{});
      else attend(Full<false>{});
    }
    __syncthreads();  // every warp is done with this block's V
    if (j + 1 < nblk) load_tile<D>(vs, vg + (size_t)(kv0 + bkv) * D, bkv, tid);
    cp_commit();
  }
  cp_wait<0>();

  __half* og = p.out + (size_t)bh * p.Sq * D;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = r0 + g + rh * 8;
    if (r >= p.Sq) continue;
    const float l = fmaxf(l_row[rh], 1e-30f);
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      *reinterpret_cast<__half2*>(og + (size_t)r * D + n * 8 + 2 * t) =
          __floats2half2_rn(__fdiv_rn(acc[n][2 * rh], l),
                            __fdiv_rn(acc[n][2 * rh + 1], l));
  }
}

template <int D, int NKT, int MODE, bool LUT_SMEM>
int launch(const Params& p, int BH, cudaStream_t stream) {
  const size_t bytes =
      2 * (size_t)tile_bytes(p.bkv, D) + (LUT_SMEM ? kLutBytes : 0);
  auto kern = lut_softmax_attention_kernel<D, NKT, MODE, LUT_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (p.Sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int NKT>
int launch_mode(const Params& p, int BH, int mode, int lut_smem,
                cudaStream_t stream) {
  switch (mode) {
    case kLut:
      return lut_smem ? launch<D, NKT, kLut, true>(p, BH, stream)
                      : launch<D, NKT, kLut, false>(p, BH, stream);
    case kPoly: return launch<D, NKT, kPoly, false>(p, BH, stream);
    case kExact: return launch<D, NKT, kExact, false>(p, BH, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_bkv(const Params& p, int BH, int mode, int lut_smem,
               cudaStream_t stream) {
  return p.bkv <= 128 ? launch_mode<D, 8>(p, BH, mode, lut_smem, stream)
                      : launch_mode<D, 16>(p, BH, mode, lut_smem, stream);
}

}  // namespace

// mode: 0 lut, 1 poly, 2 exact; lut_smem: stage the LUT in shared memory
// (lut mode).  q (BH, Sq, D), k and v (BH / G, Skv, D), out (BH, Sq, D),
// all fp16 and 16-byte aligned; D in {32, 64, 128}; bkv divides Skv and is
// at most 256.  Returns the CUDA error code of the launch (0 on success).
extern "C" int lut_softmax_attention_launch(
    const void* q, const void* k, const void* v, const void* lut, void* out,
    int BH, int Sq, int Skv, int D, int G, int bkv, int causal, int mode,
    int lut_smem, float scale, void* stream) {
  if (bkv < 1 || bkv > kMaxBkv || Skv % bkv || G < 1 || BH % G)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  Params p{static_cast<const __half*>(q), static_cast<const __half*>(k),
           static_cast<const __half*>(v),
           static_cast<const unsigned short*>(lut), static_cast<__half*>(out),
           Sq, Skv, G, bkv, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bkv<32>(p, BH, mode, lut_smem, s);
    case 64: return launch_bkv<64>(p, BH, mode, lut_smem, s);
    case 128: return launch_bkv<128>(p, BH, mode, lut_smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
