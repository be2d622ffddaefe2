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
// What bounds it on the H100: at decode and cache-hit prefills (M <= 32
// rows) the bytes of the packed weight (~0.56 byte per weight with
// scales); at cold and batched prefills (M in the tens to hundreds) the
// tensor cores' operations.  Measured (PERF.md), both kernels stay well
// above these bounds: their time is set by launch and set-up and by the
// latency of each K step's dependent chain (copy, dequantize, multiply) at
// two to eight warps per SM partition.
//
// Two tensor-core kernels for 16-bit x, chosen by the wrapper from M, both
// on mma.sync.m16n8k16 (bf16 or f16 in, f32 accumulate):
//
// small M (<= 32, decode and cache-hit prefills) computes Y^T = W^T x^T:
// the dequantized weight is the 16-row A operand and x the n8 B operand,
// so M = 8 fills one n8 tile.  A warp owns 64 columns and 8, 16 or 32
// rows; K is split over up to 8 warps of a block (summed in shared memory
// in warp order) and, for N shapes with fewer blocks than SMs or at
// M <= 8, over the kz blocks of a cluster.
//   * Copies.  Each lane copies 16 bytes of a code row (the warp's 16 rows
//     x 32 bytes of a K step), its scale words and 16 bytes of an x row
//     into the warp's cp.async ring, several K steps ahead; no block
//     barrier.
//   * Dequantization in registers.  A row g (g + 8) of an N-tile is the
//     low (high) nibble of one byte, and the lane's logical K pairs (2t,
//     2t+1, 2t+8, 2t+9) are the physical rows 4t .. 4t+3, so x's B
//     fragment is 4 consecutive K values and a lane's outputs are
//     consecutive columns of one row.  For a codebook c + cb0 (q4_0) two
//     weights come from one PRMT, one packed subtraction and one packed
//     multiply (f16) or multiply-add (bf16, with the scale split into a
//     bf16 part and its exact remainder), exactly the plain version's f32
//     product rounded once to x's type; other codebooks go through a
//     shared-memory lookup and an f32 product (10-34% slower at N = 8960,
//     PERF.md).
//
// large M (> 32) computes Y = x W on 64 x 128 output tiles with the weight
// tile dequantized into shared memory and ldmatrix operands (below).
//
// The kz blocks of a split K form a thread-block cluster and are added
// through distributed shared memory in rank order (no atomics, no global
// round trip; the same bits on every call).  f32 x (tests and the
// reference check only; TF32 would not hold the f32 bar) and geometries
// the tensor-core kernels do not take run the CUDA-core kernel below: a
// 256-thread block computes a 16 x 32 output tile with f32 FMA over a
// shared dequantized weight tile.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// CUDA-core kernel tile: 16 rows by 32 columns, 128-deep K slices
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


// ---------------------------------------------------------------------------
// tensor-core kernel (bf16 / f16 x)
// ---------------------------------------------------------------------------

// two f32 values rounded to T and packed (lo in the low 16 bits), and the
// m16n8k16 product with f32 accumulation
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint2 b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint2 b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  }
};

// --- the warp's cp.async ring ----------------------------------------------
//
// A warp's K step (16 rows of its 64 columns) is one ring slot in shared
// memory: the code rows (16 x 32 bytes, one 16-byte copy per lane), the
// scale words (tile: the 4-byte words holding the f16 scales of the lane's
// row pairs (k, k+1) and (k+2, k+3); common: its 8 column scales, 16 bytes;
// lane-interleaved) and x's rows (8 MT rows x 32 bytes, 16-byte copies).
// Code row 4t + i is stored in slot row 4i + t, so the 4 rows a lane reads
// fall in 32 distinct banks.  cp.async.wait_group makes a lane's own copies
// visible to it and __syncwarp the other lanes': the ring needs no block
// barrier.

// K steps in the ring: 7 in flight while one is computed
constexpr int kStages = 8;

template <bool TILE>
__host__ __device__ constexpr int scale_bytes() { return TILE ? 256 : 512; }
template <bool TILE, int MT>
__host__ __device__ constexpr int step_bytes() {
  return 512 + scale_bytes<TILE>() + 256 * MT;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool ok) {
  // src-size 0 fills the destination with zeros and reads nothing
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 8 : 0));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float ldsf(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// A lane's copies at the next K step to issue, and their strides.
template <typename T>
struct Lane {
  const uint8_t* cp;     // its 16 bytes of code row lane / 2
  const uint32_t* sp;    // tile: the scale word of row pair 2t; common:
                         // the lane's 8 scales (uint4 aligned)
  const T* xp;           // its 16 bytes of x row lane / 2 (+ 16 per copy)
  int c_step;            // code bytes per K step
  int s_step, s_row;     // scale words per K step (tile) / per row
  int x_16;              // elements to the x row 16 further
  int x_rows;            // x rows of the lane's copies inside M: row < this
  int g_left, per_group; // common: steps left in / per scale group
  bool cok;              // its code bytes lie inside N
  bool nok;              // the lane's 8 columns lie inside N
  bool s_hi;             // tile: the lane's scale is the word's high half
};

// Issue the copies of the lane's next K step into ring slot `slot` and
// advance the lane to the step after it.
template <typename T, bool TILE, int MT>
__device__ __forceinline__ void issue_step(uint32_t ring, int slot, int lane,
                                           Lane<T>& L) {
  const uint32_t sb = ring + (uint32_t)slot * step_bytes<TILE, MT>();
  const int r = lane >> 1;  // code row r goes to slot row 4 (r % 4) + r / 4
  cp_async(sb + (((r & 3) << 2) | (r >> 2)) * 32 + (lane & 1) * 16, L.cp, 16,
           L.cok);
  if constexpr (TILE) {
    cp_async(sb + 512 + lane * 4, L.sp, 4, L.nok);
    cp_async(sb + 512 + 128 + lane * 4, L.sp + L.s_row, 4, L.nok);
    L.sp += L.s_step;
  } else {
    cp_async(sb + 512 + lane * 16, L.sp, 16, L.nok);
    if (--L.g_left == 0) {
      L.sp += L.s_row;
      L.g_left = L.per_group;
    }
  }
  const uint32_t xb = sb + 512 + scale_bytes<TILE>() + lane * 16;
#pragma unroll
  for (int u = 0; u < (MT + 1) / 2; ++u)  // 16 rows per copy of the warp
    if (MT > 1 || lane < 16)
    {
      const bool ok = (lane >> 1) + 16 * u < L.x_rows;
      cp_async(xb + u * 512, ok ? L.xp + u * L.x_16 : L.xp, 16, ok);
    }
  L.cp += L.c_step;
  L.xp += 16;
}

template <bool TILE, int MT>
struct Step {
  uint32_t w[4];
  uint32_t s[TILE ? 2 : 4];
  uint2 xb[MT];
};

template <bool TILE, int MT>
__device__ __forceinline__ void read_step(Step<TILE, MT>& st, uint32_t ring,
                                          int slot, int lane) {
  const uint32_t sb = ring + (uint32_t)slot * step_bytes<TILE, MT>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) st.w[r] = lds32(sb + (4 * r + t) * 32 + 4 * g);
  if constexpr (TILE) {
    st.s[0] = lds32(sb + 512 + lane * 4);
    st.s[1] = lds32(sb + 512 + 128 + lane * 4);
  } else {
    const uint4 v = lds128(sb + 512 + lane * 16);
    st.s[0] = v.x;
    st.s[1] = v.y;
    st.s[2] = v.z;
    st.s[3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < MT; ++j)
    st.xb[j] = lds64(sb + 512 + scale_bytes<TILE>() + (8 * j + g) * 32 + 8 * t);
}

__device__ __forceinline__ float half_lo(uint32_t v) {
  return __half2float(__ushort_as_half((unsigned short)(v & 0xFFFFu)));
}
__device__ __forceinline__ float half_hi(uint32_t v) {
  return __half2float(__ushort_as_half((unsigned short)(v >> 16)));
}

// Codebooks c + cb0 (cb0 an integer, |cb0| <= 64; q4_0 is c - 8) in T's
// packed arithmetic, two weights per instruction and exact: the code put
// into the mantissa of kMagic is the T value kBias + c, and subtracting
// kBias - cb0 leaves c + cb0.  f16: one f16 multiply by the f16 scale
// rounds c + cb0 times it once, as the plain version's f32 product cast to
// f16 does.  bf16: the scale is split into s_hi = bf16(s) and the exact
// remainder s_lo, and fma(v, s_hi, v * s_lo) (v * s_lo is exact in bf16)
// rounds v * s once.
template <typename T> struct Grid;
template <> struct Grid<__nv_bfloat16> {
  static constexpr uint32_t kMagic = 0x43004300u;  // 128 in both halves
  static constexpr float kBias = 128.f;
  struct Scale {
    __nv_bfloat162 hi, lo;
  };
  static __device__ __forceinline__ Scale scale(float s) {
    const __nv_bfloat16 h = __float2bfloat16_rn(s);
    const __nv_bfloat16 l = __float2bfloat16_rn(s - __bfloat162float(h));
    return {__bfloat162bfloat162(h), __bfloat162bfloat162(l)};
  }
  static __device__ __forceinline__ uint32_t offset(float cb0) {
    const __nv_bfloat162 o = __float2bfloat162_rn(kBias - cb0);
    return *reinterpret_cast<const uint32_t*>(&o);
  }
  static __device__ __forceinline__ uint32_t value(uint32_t m, uint32_t off,
                                                   const Scale& s) {
    const __nv_bfloat162 v =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                *reinterpret_cast<const __nv_bfloat162*>(&off));
    const __nv_bfloat162 r = __hfma2(v, s.hi, __hmul2(v, s.lo));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
};
template <> struct Grid<__half> {
  static constexpr uint32_t kMagic = 0x64006400u;  // 1024 in both halves
  static constexpr float kBias = 1024.f;
  struct Scale {
    __half2 s;
  };
  static __device__ __forceinline__ Scale scale(float s) {
    return {__float2half2_rn(s)};  // s is an f16 value: exact
  }
  static __device__ __forceinline__ uint32_t offset(float cb0) {
    const __half2 o = __float2half2_rn(kBias - cb0);
    return *reinterpret_cast<const uint32_t*>(&o);
  }
  static __device__ __forceinline__ uint32_t value(uint32_t m, uint32_t off,
                                                   const Scale& s) {
    const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&m),
                              *reinterpret_cast<const __half2*>(&off));
    const __half2 r = __hmul2(v, s.s);
    return *reinterpret_cast<const uint32_t*>(&r);
  }
};

// The lane's 4 x 8 weights of one K step, rounded to T, times x.  With
// INT_GRID the codes go through Grid<T>; otherwise through a shared-memory
// lookup of the f32 codebook (a PRMT puts 4 x code into the low byte of the
// table's 256-byte-aligned address), an f32 product with the scale and one
// rounding to T, as the plain version computes.
template <typename T, bool TILE, int MT, bool INT_GRID>
__device__ __forceinline__ void mma_step(const Step<TILE, MT>& st,
                                         uint32_t cb_addr, uint32_t off,
                                         bool s_hi, float (&acc)[MT][4][4]) {
  // tile: the scales of row pairs (0, 1) and (2, 3), each shared by the
  // lane's 8 columns; common: the 8 column scales, shared by its 4 rows
  float sc[TILE ? 2 : 8];
  if constexpr (TILE) {
    sc[0] = s_hi ? half_hi(st.s[0]) : half_lo(st.s[0]);
    sc[1] = s_hi ? half_hi(st.s[1]) : half_lo(st.s[1]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[2 * i] = half_lo(st.s[i]);
      sc[2 * i + 1] = half_hi(st.s[i]);
    }
  }
  if constexpr (INT_GRID) {
    using GT = Grid<T>;
    typename GT::Scale gs[TILE ? 2 : 8];
#pragma unroll
    for (int i = 0; i < (TILE ? 2 : 8); ++i) gs[i] = GT::scale(sc[i]);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      // bytes h of rows (0, 1) and (2, 3) into the two 16-bit halves
      const uint32_t sel = h | (h << 4) | ((h + 4) << 8) | ((h + 4) << 12);
      const uint32_t p01 = __byte_perm(st.w[0], st.w[1], sel);
      const uint32_t p23 = __byte_perm(st.w[2], st.w[3], sel);
      const uint32_t m = 0x000F000Fu;
      const typename GT::Scale& s_lo01 = gs[TILE ? 0 : 2 * h];
      const typename GT::Scale& s_hi01 = gs[TILE ? 0 : 2 * h + 1];
      const typename GT::Scale& s_lo23 = gs[TILE ? 1 : 2 * h];
      const typename GT::Scale& s_hi23 = gs[TILE ? 1 : 2 * h + 1];
      uint32_t a[4];
      a[0] = GT::value((p01 & m) | GT::kMagic, off, s_lo01);
      a[1] = GT::value(((p01 >> 4) & m) | GT::kMagic, off, s_hi01);
      a[2] = GT::value((p23 & m) | GT::kMagic, off, s_lo23);
      a[3] = GT::value(((p23 >> 4) & m) | GT::kMagic, off, s_hi23);
#pragma unroll
      for (int j = 0; j < MT; ++j) Mma<T>::run(acc[j][h], a, st.xb[j]);
    }
  } else {
    // per row 4 x the codes as bytes: lo[r] byte h = 4 * low nibble of
    // byte h (column 2h), hi[r] byte h = 4 * high nibble (column 2h + 1)
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      lo[r] = (st.w[r] << 2) & 0x3C3C3C3Cu;
      hi[r] = (st.w[r] >> 2) & 0x3C3C3C3Cu;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t sel = 0x7650u | h;  // byte h, then cb_addr's bytes
      float w[4][2];  // [row][lo column 2h, hi column 2h + 1]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float s_lo = TILE ? sc[r >> 1] : sc[(2 * h) % (TILE ? 2 : 8)];
        const float s_hi =
            TILE ? sc[r >> 1] : sc[(2 * h + 1) % (TILE ? 2 : 8)];
        w[r][0] = ldsf(__byte_perm(lo[r], cb_addr, sel)) * s_lo;
        w[r][1] = ldsf(__byte_perm(hi[r], cb_addr, sel)) * s_hi;
      }
      uint32_t a[4];
      a[0] = Mma<T>::pack(w[0][0], w[1][0]);  // A row g,     K rows 0, 1
      a[1] = Mma<T>::pack(w[0][1], w[1][1]);  // A row g + 8, K rows 0, 1
      a[2] = Mma<T>::pack(w[2][0], w[3][0]);  // A row g,     K rows 2, 3
      a[3] = Mma<T>::pack(w[2][1], w[3][1]);  // A row g + 8, K rows 2, 3
#pragma unroll
      for (int j = 0; j < MT; ++j) Mma<T>::run(acc[j][h], a, st.xb[j]);
    }
  }
}

// A warp's n_steps K steps through its ring (the first kStages - 1 already
// issued).
template <typename T, bool TILE, int MT, bool INT_GRID>
__device__ __forceinline__ void k_loop(uint32_t ring, int n_steps, int lane,
                                       Lane<T>& L, uint32_t cb_addr,
                                       uint32_t off,
                                       float (&acc)[MT][4][4]) {
  for (int i = 0; i < n_steps; ++i) {
    cp_wait<kStages - 2>();  // step i has landed (this lane's copies)
    __syncwarp();            // ... and the other lanes'; slot i - 1 is free
    const int nx = i + kStages - 1;
    if (nx < n_steps)
      issue_step<T, TILE, MT>(ring, nx & (kStages - 1), lane, L);
    cp_commit();
    Step<TILE, MT> st;
    read_step<TILE, MT>(st, ring, i & (kStages - 1), lane);
    mma_step<T, TILE, MT, INT_GRID>(st, cb_addr, off, L.s_hi, acc);
  }
}

template <int MT>
constexpr int tc_threads() { return MT <= 2 ? 512 : 256; }

// Dynamic shared memory of a block of wk warps: the warps' rings, reused
// after the K loop for the split-K sums.
template <bool TILE, int MT>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)kStages * step_bytes<TILE, MT>();
}
template <bool TILE, int MT>
size_t tc_smem(int wk) {
  const size_t ring = wk * ring_bytes<TILE, MT>();
  const size_t red = wk > 1 ? (size_t)wk * MT * 16 * 32 * 4 : 0;
  return ring > red ? ring : red;
}

// grid (ceil(N / 64), ceil(M / (8 MT)), kz) in clusters of (1, 1, kz),
// block 32 * wk threads: the block's 64 columns x 8 MT rows over the z-th
// of kz shares of K, its warp w over the w-th share of that.  Sums are
// taken in warp order, then in cluster-rank order: no atomics, the same
// bits on every call.
template <typename T, bool TILE, int MT>
__global__ void __launch_bounds__(tc_threads<MT>())
    tc_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                   const __half* __restrict__ scales,
                   const float* __restrict__ codebook, T* __restrict__ out,
                   int M, int K, int N, int group) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(256) float cb[64];  // 16 used; aligned for PRMT
  constexpr int NA = MT * 16;  // accumulators per lane
  const int lane = threadIdx.x & 31, wk = threadIdx.x >> 5;
  const int nwk = blockDim.x >> 5, kz = gridDim.z;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 8 * MT;
  const int col = n0 + 8 * g;  // the lane's 8 columns
  const int steps = K / 16;
  const int per = (steps + kz * nwk - 1) / (kz * nwk);
  const int s_begin = min(steps, (blockIdx.z * nwk + wk) * per);
  const int n_steps = min(steps, s_begin + per) - s_begin;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem) +
                        (uint32_t)(wk * ring_bytes<TILE, MT>());

  Lane<T> L;
  L.nok = col < N;
  L.cok = n0 + (lane & 1) * 32 < N;
  L.c_step = 16 * (N / 2);
  L.cp = codes + (size_t)(16 * s_begin + (lane >> 1)) * (N / 2) +
         (L.cok ? n0 / 2 + (lane & 1) * 16 : 0);
  if constexpr (TILE) {
    const int gc = group / 2, cols = N / gc;  // cols is even (wrapper)
    const size_t h0 = (size_t)(8 * s_begin + 2 * t) * cols + col / gc;
    L.s_row = cols / 2;
    L.s_step = 8 * (cols / 2);
    L.sp = reinterpret_cast<const uint32_t*>(scales) + h0 / 2;
    L.s_hi = h0 & 1;
  } else {
    const int per_group = group / 16;
    L.s_row = N / 2;
    L.per_group = per_group;
    L.g_left = per_group - s_begin % per_group;
    L.sp = reinterpret_cast<const uint32_t*>(
        scales + (size_t)(s_begin / per_group) * N + col);
    L.s_hi = false;
  }
  L.x_rows = min(8 * MT, M - m0);
  L.x_16 = 16 * K;
  L.xp = x + (size_t)min(m0 + (lane >> 1), M - 1) * K + 16 * s_begin +
         (lane & 1) * 8;

  // the first stages go out before the codebook is staged
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) issue_step<T, TILE, MT>(ring, i, lane, L);
    cp_commit();
  }
  bool grid_ok = true;
  if (threadIdx.x < 16) {
    const float v = codebook[threadIdx.x];
    cb[threadIdx.x] = v;
    const float c0 = codebook[0];
    grid_ok = v == c0 + (float)threadIdx.x && c0 == rintf(c0) &&
              fabsf(c0) <= 64.f;
  }
  const uint32_t cb_addr = (uint32_t)__cvta_generic_to_shared(cb);

  float acc[MT][4][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][h][c] = 0.f;
  const bool int_grid = __syncthreads_and(grid_ok);  // also stages cb
  if (int_grid)
    k_loop<T, TILE, MT, true>(ring, n_steps, lane, L, cb_addr,
                              Grid<T>::offset(cb[0]), acc);
  else
    k_loop<T, TILE, MT, false>(ring, n_steps, lane, L, cb_addr, 0u, acc);

  // The block's sum lands in smem[0, NA * 32) in warp 0's lane layout:
  // the K-splitting warps store their accumulators (over the rings, once
  // every warp is done with its ring) and each thread adds one element
  // over the warps in warp order.  The kz blocks of a cluster then add
  // into rank 0 in rank order through distributed shared memory.
  if (nwk > 1 || kz > 1) {
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          smem[((wk * MT + j) * 16 + h * 4 + c) * 32 + lane] = acc[j][h][c];
    __syncthreads();
    if (nwk > 1) {
      for (int e = threadIdx.x; e < NA * 32; e += blockDim.x) {
        float sum = 0.f;
        for (int w = 0; w < nwk; ++w) sum += smem[w * NA * 32 + e];
        smem[e] = sum;
      }
    }
    if (kz > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every block's sum is in its shared memory
      if (cluster.block_rank() == 0) {
        for (int e = threadIdx.x; e < NA * 32; e += blockDim.x) {
          float sum = smem[e];
          for (int r = 1; r < kz; ++r)
            sum += cluster.map_shared_rank(smem, r)[e];
          smem[e] = sum;
        }
      }
      cluster.sync();  // the other blocks' memory is read: they may exit
      if (cluster.block_rank() != 0) return;
    } else {
      __syncthreads();
    }
    if (wk != 0) return;
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[j][h][c] = smem[((j * 16) + h * 4 + c) * 32 + lane];
  }
  if (!L.nok) return;

  // lane (g, t) holds rows m0 + 8j + 2t (+1) x columns n0 + 8g .. + 7
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      const int m = m0 + 8 * j + 2 * t + mm;
      if (m >= M) continue;
      uint4 v;
      v.x = Mma<T>::pack(acc[j][0][mm], acc[j][0][2 + mm]);
      v.y = Mma<T>::pack(acc[j][1][mm], acc[j][1][2 + mm]);
      v.z = Mma<T>::pack(acc[j][2][mm], acc[j][2][2 + mm]);
      v.w = Mma<T>::pack(acc[j][3][mm], acc[j][3][2 + mm]);
      *reinterpret_cast<uint4*>(out + (size_t)m * N + col) = v;
    }
}

template <typename T, bool TILE, int MT>
cudaError_t launch_tc(const void* x, const void* codes, const void* scales,
                      const void* codebook, void* out, int M, int K, int N,
                      int group, int wk, int kz, cudaStream_t stream) {
  if (wk < 1 || 32 * wk > tc_threads<MT>() || kz < 1 || kz > 8 || N % 32)
    return cudaErrorInvalidValue;
  auto kern = tc_gemm_kernel<T, TILE, MT>;
  const size_t smem = tc_smem<TILE, MT>(wk);
  static size_t allowed = 32 * 1024;  // opt in above it (static smem too)
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 63) / 64, (M + 8 * MT - 1) / (8 * MT), kz);
  cfg.blockDim = dim3(32 * wk);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kz;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                            static_cast<const uint8_t*>(codes),
                            static_cast<const __half*>(scales),
                            static_cast<const float*>(codebook),
                            static_cast<T*>(out), M, K, N, group);
}

template <typename T, bool TILE>
cudaError_t by_mt(int mt, const void* x, const void* codes,
                  const void* scales, const void* codebook, void* out, int M,
                  int K, int N, int group, int wk, int kz, cudaStream_t s) {
  switch (mt) {
    case 1:
      return launch_tc<T, TILE, 1>(x, codes, scales, codebook, out, M, K,
                                     N, group, wk, kz, s);
    case 2:
      return launch_tc<T, TILE, 2>(x, codes, scales, codebook, out, M, K,
                                     N, group, wk, kz, s);
    case 4:
      return launch_tc<T, TILE, 4>(x, codes, scales, codebook, out, M, K,
                                     N, group, wk, kz, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t tc_by_scheme(int tile, int mt, const void* x, const void* codes,
                         const void* scales, const void* codebook, void* out,
                         int M, int K, int N, int group, int wk, int kz,
                         cudaStream_t s) {
  if (tile)
    return by_mt<T, true>(mt, x, codes, scales, codebook, out, M, K, N,
                          group, wk, kz, s);
  return by_mt<T, false>(mt, x, codes, scales, codebook, out, M, K, N, group,
                         wk, kz, s);
}

// ---------------------------------------------------------------------------
// large-M tensor-core kernel (bf16 / f16 x, M > 32)
// ---------------------------------------------------------------------------
//
// Y = x W on output tiles of 64 rows x 128 columns, 32-deep K tiles, eight
// warps of 32 x 32 each.  A kLStages-deep cp.async
// pipeline (16-byte copies) brings each K tile's x rows, code rows and
// scales into shared memory.  The block dequantizes a K tile's 32 x 128 weights once into a
// shared bf16 / f16 tile (16-entry codebook lookup, f32 product with the
// scale, one rounding to T, as the plain version computes) while the warps
// run ldmatrix + mma.sync.m16n8k16 on the previous one (x as the A operand,
// the weight through ldmatrix.trans as the B operand): two weight tiles,
// one barrier per K tile.  Rows of 64 bytes (x, codes) and of 256 bytes
// (the weight tile) are XOR-swizzled by 16-byte chunk, so ldmatrix and the
// dequantized stores are free of bank conflicts.  K is split over the kz
// blocks of a cluster; each rank then adds one kz-th of the tile over the
// ranks' shared memory in rank order (no atomics) and writes it.

constexpr int kLBM = 64, kLBN = 128, kLBK = 32, kLStages = 4;
constexpr int kLThreads = 256;
constexpr int kLMI = 2;  // m16 tiles of a warp (32 rows)
// one stage: code tile, scale tile (<= 512 bytes either scheme), x tile
constexpr int kLCBytes = kLBK * kLBN / 2;        // 2048
constexpr int kLSBytes = 512;
constexpr int kLStageBytes = kLCBytes + kLSBytes + kLBM * kLBK * 2;
constexpr int kLWBytes = kLBK * kLBN * 2;        // one dequantized tile
constexpr int kLSmem = kLStages * kLStageBytes + 2 * kLWBytes;
static_assert(kLSmem >= kLThreads * kLMI * 16 * 4, "room for split-K sums");

// 16-byte chunk c of row r of a 64-byte-row tile / a 256-byte-row tile
__device__ __forceinline__ uint32_t swz64(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}
__device__ __forceinline__ uint32_t swz256(int r, int c) {
  return (uint32_t)(r * 256 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// The copies of K tile kt into the stage at sb.
template <typename T, bool TILE>
__device__ __forceinline__ void issue_tile(uint32_t sb, int kt, int tid,
                                           const T* x, const uint8_t* codes,
                                           const __half* scales, int m0,
                                           int n0, int M, int K, int N,
                                           int group, int gc_shift) {
  const int k0 = kt * kLBK;
  if (tid < 128) {  // codes: 32 rows x 4 chunks of 32 columns
    const int r = tid >> 2, ch = tid & 3;
    const bool ok = n0 + ch * 32 < N;
    cp_async(sb + swz64(r, ch),
             codes + (size_t)(k0 + r) * (N / 2) + (ok ? n0 / 2 + ch * 16 : 0),
             16, ok);
  }
  const uint32_t ss = sb + kLCBytes;
  if constexpr (TILE) {  // 16 scale rows x (128 / gc) scales, 4-byte words
    const int wpr = (kLBN >> gc_shift) >> 1;
    if (tid < 16 * wpr) {
      const int r = tid / wpr, w = tid - r * wpr;
      const bool ok = n0 + (2 * w << gc_shift) < N;
      cp_async(ss + tid * 4,
               scales + (size_t)(k0 / 2 + r) * (N >> gc_shift) +
                   (ok ? (n0 >> gc_shift) + 2 * w : 0),
               4, ok);
    }
  } else if (tid < 32) {  // the 2 scale rows the tile can touch
    const int r = tid >> 4, ch = tid & 15;
    const int row = min(k0 / group + r, K / group - 1);
    const bool ok = n0 + ch * 8 < N;
    cp_async(ss + tid * 16, scales + (size_t)row * N + (ok ? n0 + ch * 8 : 0),
             16, ok);
  }
#pragma unroll
  {  // x: 64 rows x 4 chunks
    const int r = tid >> 2, ch = tid & 3;
    const bool ok = m0 + r < M;
    cp_async(ss + kLSBytes + swz64(r, ch),
             x + (size_t)(ok ? m0 + r : 0) * K + k0 + ch * 8, 16, ok);
  }
}

// Dequantize this thread's 16 weights of K tile kt (row dr, columns 16 dp
// .. 16 dp + 15) from the stage at sb into the weight tile at wb.
template <typename T, bool TILE>
__device__ __forceinline__ void dequant_tile(uint32_t sb, uint32_t wb, int kt,
                                             int dr, int dp,
                                             const int (&sidx)[2],
                                             uint32_t cb_addr, int K,
                                             int group, int gc_shift) {
  const uint2 raw = lds64(sb + swz64(dr, dp >> 1) + 8 * (dp & 1));
  const uint32_t ss = sb + kLCBytes;
  float sc[16];
  if constexpr (TILE) {
    const int row = (dr >> 1) * (kLBN >> gc_shift);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t a = ss + 2 * (row + sidx[i]);
      const uint32_t w = lds32(a & ~3u);
      const float v = (a & 2) ? half_hi(w) : half_lo(w);
#pragma unroll
      for (int e = 0; e < 8; ++e) sc[8 * i + e] = v;
    }
  } else {
    const int k0 = kt * kLBK;
    const int r = (k0 + dr) / group - min(k0 / group, K / group - 1);
    const uint32_t a = ss + r * 256 + dp * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 v = lds128(a + 16 * i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[8 * i + 2 * e] = half_lo(w[e]);
        sc[8 * i + 2 * e + 1] = half_hi(w[e]);
      }
    }
  }
  const uint32_t wd[2] = {raw.x, raw.y};
#pragma unroll
  for (int q = 0; q < 2; ++q) {  // 16-byte output chunk 2 dp + q
    const uint32_t lo = (wd[q] << 2) & 0x3C3C3C3Cu;
    const uint32_t hi = (wd[q] >> 2) & 0x3C3C3C3Cu;
    uint32_t o[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // byte h: columns 8q + 2h, + 1
      const uint32_t sel = 0x7650u | h;
      const float w0 =
          ldsf(__byte_perm(lo, cb_addr, sel)) * sc[8 * q + 2 * h];
      const float w1 =
          ldsf(__byte_perm(hi, cb_addr, sel)) * sc[8 * q + 2 * h + 1];
      o[h] = Mma<T>::pack(w0, w1);
    }
    sts128(wb + swz256(dr, 2 * dp + q), make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// grid (ceil(N / 128), ceil(M / 64), kz) in clusters of (1, 1, kz), 256
// threads.  The wrapper admits K % 32 == 0, N % 32 == 0 and (tile) gc a
// power of two in [8, 64] with N / gc even, (common) group % 16 == 0.
template <typename T, bool TILE>
__global__ void __launch_bounds__(kLThreads)
    tile_gemm_kernel(const T* __restrict__ x,
                     const uint8_t* __restrict__ codes,
                     const __half* __restrict__ scales,
                     const float* __restrict__ codebook, T* __restrict__ out,
                     int M, int K, int N, int group, int gc_shift) {
  constexpr int MI = kLMI, SB = kLStageBytes;
  extern __shared__ __align__(128) uint8_t lsm[];
  __shared__ __align__(256) float cb[64];  // 16 used; aligned for PRMT
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kz = gridDim.z;
  const int n0 = blockIdx.x * kLBN, m0 = blockIdx.y * kLBM;
  const int tiles = K / kLBK;
  const int per = (tiles + kz - 1) / kz;
  const int t0 = min(tiles, (int)blockIdx.z * per);
  const int nt = min(tiles, t0 + per) - t0;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(lsm);
  const uint32_t wbase = base + kLStages * SB;
  auto stage = [&](int i) { return base + (i % kLStages) * SB; };

#pragma unroll
  for (int s = 0; s < kLStages - 1; ++s) {
    if (s < nt)
      issue_tile<T, TILE>(stage(s), t0 + s, tid, x, codes, scales, m0, n0,
                          M, K, N, group, gc_shift);
    cp_commit();
  }
  if (tid < 16) cb[tid] = codebook[tid];
  const uint32_t cb_addr = (uint32_t)__cvta_generic_to_shared(cb);

  // dequantization role: K row dr of a tile, 16 columns from 16 dp
  const int dr = tid & 31, dp = tid >> 5;
  int sidx[2];  // tile: the scale column of each 8-column group
#pragma unroll
  for (int i = 0; i < 2; ++i) sidx[i] = (16 * dp + 8 * i) >> gc_shift;

  // mma role: rows 32 wm, columns 32 wn of the output tile
  const int wm = warp & 1, wn = warp >> 1;
  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  if (nt > 0) {
    cp_wait<kLStages - 2>();
    __syncthreads();  // tile 0 and the codebook landed
    dequant_tile<T, TILE>(stage(0), wbase, t0, dr, dp, sidx, cb_addr, K,
                          group, gc_shift);
  }
  for (int it = 0; it < nt; ++it) {
    cp_wait<kLStages - 3>();
    // weight tile it is complete and tile it + 1 landed; stage it - 1 and
    // weight tile it - 1 are free
    __syncthreads();
    if (it + kLStages - 1 < nt)
      issue_tile<T, TILE>(stage(it + kLStages - 1), t0 + it + kLStages - 1,
                          tid, x, codes, scales, m0, n0, M, K, N, group,
                          gc_shift);
    cp_commit();
    const uint32_t xs = stage(it) + kLCBytes + kLSBytes;
    const uint32_t wb = wbase + (it & 1) * kLWBytes;
    // this tile's fragments first; the next weight tile's dequantization
    // between the products of its two 16-deep halves
    uint32_t a[2][MI][4], b[2][2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a[kk][mi], xs + swz64(32 * wm + 16 * mi + (lane & 15),
                                      2 * kk + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(b[kk][np], wb + swz256(16 * kk + (lane & 15),
                                         4 * wn + 2 * np + (lane >> 4)));
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (kk == 1 && it + 1 < nt)
        dequant_tile<T, TILE>(stage(it + 1),
                              wbase + ((it + 1) & 1) * kLWBytes, t0 + it + 1,
                              dr, dp, sidx, cb_addr, K, group, gc_shift);
#pragma unroll
      for (int np = 0; np < 2; ++np)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          Mma<T>::run(acc[mi][2 * np], a[kk][mi],
                      make_uint2(b[kk][np][0], b[kk][np][1]));
          Mma<T>::run(acc[mi][2 * np + 1], a[kk][mi],
                      make_uint2(b[kk][np][2], b[kk][np][3]));
        }
    }
  }

  // lane (g, t) holds rows + g (+ 8), columns + 2t, 2t + 1 of each n8 tile
  const int g = lane >> 2, t = lane & 3;
  auto store = [&](int mi, int ni, const float (&v)[4]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 32 * wm + 16 * mi + g + 8 * hh;
      const int n = n0 + 32 * wn + 8 * ni + 2 * t;
      if (m < M && n < N)
        *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) =
            Mma<T>::pack(v[2 * hh], v[2 * hh + 1]);
    }
  };
  if (kz == 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) store(mi, ni, acc[mi][ni]);
    return;
  }
  // split K: every rank leaves its sums in its shared memory; rank r adds
  // n8 tiles [4 MI r / kz, 4 MI (r + 1) / kz) of each thread over the ranks
  // in rank order and writes them
  float* red = reinterpret_cast<float*>(lsm);
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((i * 4 + j) * 4 + c) * kLThreads + tid] = acc[i][j][c];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int p_lo = 4 * MI * rank / kz, p_hi = 4 * MI * (rank + 1) / kz;
#pragma unroll
  for (int p = 0; p < 4 * MI; ++p) {
    if (p < p_lo || p >= p_hi) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < kz; ++r) {
      const float* src = cluster.map_shared_rank(red, r);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] += src[(p * 4 + c) * kLThreads + tid];
    }
    store(p >> 2, p & 3, v);
  }
  cluster.sync();  // the other ranks' memory is read: they may exit
}

template <typename T, bool TILE>
cudaError_t launch_tile(const void* x, const void* codes, const void* scales,
                        const void* codebook, void* out, int M, int K, int N,
                        int group, int kz, cudaStream_t stream) {
  if (kz < 1 || kz > 8 || K % kLBK || N % 32) return cudaErrorInvalidValue;
  int gc_shift = 0;
  if (TILE) {
    const int gc = group / 2;
    if (gc < 8 || gc > 64 || (gc & (gc - 1)) || (N / gc) % 2)
      return cudaErrorInvalidValue;
    gc_shift = __builtin_ctz(gc);
  } else if (group % 16) {
    return cudaErrorInvalidValue;
  }
  auto kern = tile_gemm_kernel<T, TILE>;
  static bool opted = false;  // dynamic shared memory above 48 KiB
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kLSmem);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kLBN + (N % kLBN != 0), (M + kLBM - 1) / kLBM, kz);
  cfg.blockDim = dim3(kLThreads);
  cfg.dynamicSmemBytes = kLSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kz;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                            static_cast<const uint8_t*>(codes),
                            static_cast<const __half*>(scales),
                            static_cast<const float*>(codebook),
                            static_cast<T*>(out), M, K, N, group, gc_shift);
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32 x, and geometries the tensor-core kernel refuses)
// ---------------------------------------------------------------------------

template <typename T, bool TILE, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    fma_gemm_kernel(const T* __restrict__ x,
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
cudaError_t launch_fma(const void* x, const void* codes, const void* scales,
                       const void* codebook, void* out, int M, int K, int N,
                       int group, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fma_gemm_kernel<T, TILE, kBM, kBN, kBK, kTM, kTN>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const uint8_t*>(codes),
          static_cast<const __half*>(scales),
          static_cast<const float*>(codebook), static_cast<T*>(out), M, K, N,
          group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fma_by_scheme(int tile, const void* x, const void* codes,
                          const void* scales, const void* codebook,
                          void* out, int M, int K, int N, int group,
                          cudaStream_t s) {
  if (tile)
    return launch_fma<T, true>(x, codes, scales, codebook, out, M, K, N,
                               group, s);
  return launch_fma<T, false>(x, codes, scales, codebook, out, M, K, N, group,
                              s);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (x and the output).  tile: 1 for
// (K/2, N/(group/2)) tile scales, 0 for (K/group, N) common scales.
// regime (the wrapper's plan; 1 and 2 take 16-bit x only): 0 the CUDA-core
// kernel; 1 the small-M tensor-core kernel with mt n8 tiles of rows per
// block, wk warps splitting K inside a block and kz blocks (a cluster,
// kz <= 8) splitting it across the grid; 2 the large-M tensor-core kernel
// with kz blocks splitting K.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int lut_dequant_gemm_launch(int dtype, int tile, int regime,
                                       int mt, int wk, int kz, const void* x,
                                       const void* codes, const void* scales,
                                       const void* codebook, void* out, int M,
                                       int K, int N, int group,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regime == 1) {
    if (dtype == 1)
      return (int)tc_by_scheme<__half>(tile, mt, x, codes, scales, codebook,
                                       out, M, K, N, group, wk, kz, s);
    if (dtype == 2)
      return (int)tc_by_scheme<__nv_bfloat16>(tile, mt, x, codes, scales,
                                              codebook, out, M, K, N, group,
                                              wk, kz, s);
    return (int)cudaErrorInvalidValue;
  }
  if (regime == 2) {
    if (dtype == 1)
      return (int)(tile ? launch_tile<__half, true>
                        : launch_tile<__half, false>)(
          x, codes, scales, codebook, out, M, K, N, group, kz, s);
    if (dtype == 2)
      return (int)(tile ? launch_tile<__nv_bfloat16, true>
                        : launch_tile<__nv_bfloat16, false>)(
          x, codes, scales, codebook, out, M, K, N, group, kz, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return (int)fma_by_scheme<float>(tile, x, codes, scales, codebook, out,
                                       M, K, N, group, s);
    case 1:
      return (int)fma_by_scheme<__half>(tile, x, codes, scales, codebook,
                                        out, M, K, N, group, s);
    case 2:
      return (int)fma_by_scheme<__nv_bfloat16>(tile, x, codes, scales,
                                               codebook, out, M, K, N, group,
                                               s);
  }
  return (int)cudaErrorInvalidValue;
}
