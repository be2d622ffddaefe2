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
// Pallas kernel.  The absmax is a max, exact in any order.
//
// What bounds it on the H100: bytes.  It does a few operations per weight
// and reads 2 or 4 bytes of weight for every half byte of code it writes;
// at qwen2.5-1.5b's largest Q4 projection (1536 x 8960, f32) it moves
// ~63 MB.  At the smallest (1536 x 256) it moves 1.8 MB, half a
// microsecond at the byte rate: there a launch costs more than the bytes.
//
// Design: a thread takes one 16-byte piece of a row pair (4 f32 or 8
// fp16/bf16 values, at the same columns of rows 2p and 2p + 1), so
// consecutive lanes read consecutive 16-byte pieces of a row and a warp
// reads 512 contiguous bytes of each row.  A (2, 16) group spans 4 (f32)
// or 2 (fp16, bf16) neighbouring lanes; its absmax is reduced across them
// by __shfl_xor_sync, the group's first lane writes the scale, and every
// lane stores its codes (2 or 4 bytes a row), so a warp's code stores are
// contiguous too.  Pieces are numbered flat over (row pair, piece), which
// takes any K even and N a multiple of 16; a piece's row pair comes from
// a multiply by a magic number, not a division.  Blocks of 128 threads,
// one piece each: timed against 256 and 512 threads and 2 or 4 pieces
// per thread at the served shapes, no other choice was more than 0.75%
// faster at any of them, and small blocks spread the smallest weight
// over every SM.  For a large weight the loads also ask L2 to fetch the
// whole 256-byte span around them (kWide): faster at 1536 x 8960 in each
// dtype, a few percent slower at 1536 x 1536 and 1536 x 256, so the
// wrapper picks the load by the weight's size (scripts/sweep_quantize.py
// times both loads in turns).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGc = 16;  // group columns; rows per group: 2

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kVec codes of one row (kVec <= 8) packed into the low 4 * kVec bits,
// column j of the piece in nibble j
template <int kVec>
__device__ __forceinline__ uint32_t pack_codes(const float* x, float sc) {
  uint32_t packed = 0u;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(x[j], sc)), -8.f), 7.f);
    packed |= (uint32_t)(int)(q + 8.f) << (4 * j);
  }
  return packed;
}

// A 16-byte read-only load that skips L1; kWide also has L2 fetch the
// 256-byte span around it.
template <bool kWide>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  uint4 v;
  if (kWide)
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
  else
    v = __ldg(p);
  return v;
}

// n / d for n < 2^31 as (n * magic) >> shift, with shift = 31 +
// ceil(log2 d) and magic = ceil(2^shift / d) <= 2^32 (exact: the
// rounding error of magic adds less than 1 / d to n / d)
struct Divider {
  unsigned long long magic;
  int shift;
};

__device__ __forceinline__ unsigned divide(unsigned n, Divider d) {
  return (unsigned)(((unsigned long long)n * d.magic) >> d.shift);
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    tile_quantize_kernel(const T* __restrict__ w, uint8_t* __restrict__ codes,
                         __half* __restrict__ scales, int N, unsigned n_pieces,
                         Divider by_row) {
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte piece
  constexpr int kLanes = kGc / kVec;    // lanes per group: 4 f32, 2 16-bit
  const unsigned per_row = N / kVec;    // pieces per row pair
  const long long row_u4 = N / kVec;    // a row's length in 16-byte pieces

  const unsigned piece = blockIdx.x * kThreads + threadIdx.x;
  const bool live = piece < n_pieces;
  const unsigned p = divide(piece, by_row);
  const long long pair = p;
  const int col = live ? (int)(piece - p * per_row) : 0;
  uint4 raw[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (live) {
    const uint4* src =
        reinterpret_cast<const uint4*>(w) + 2 * pair * row_u4 + col;
    raw[0] = load16<kWide>(src);
    raw[1] = load16<kWide>(src + row_u4);
  }
  float x[2][kVec];
  float absmax = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const T* e = reinterpret_cast<const T*>(&raw[r]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      x[r][j] = to_f(e[j]);
      absmax = fmaxf(absmax, fabsf(x[r][j]));
    }
  }
  // a group's lanes are kLanes-aligned neighbours within the warp, and
  // dead lanes (past n_pieces) only ever meet dead lanes: n_pieces is a
  // multiple of kLanes
#pragma unroll
  for (int m = 1; m < kLanes; m <<= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, m));
  if (!live) return;
  const float scale = __fdiv_rn(absmax, 8.0f);
  if (col % kLanes == 0)
    scales[pair * (N / kGc) + col / kLanes] = __float2half_rn(scale);
  // 1e-8 rounded from double to float, as the reference rounds it
  const float sc = fmaxf(scale, (float)1e-8);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t packed = pack_codes<kVec>(x[r], sc);
    uint8_t* dst =
        codes + (2 * pair + r) * (long long)(N / 2) + col * (kVec / 2);
    if (kVec == 4)
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed;
    else
      *reinterpret_cast<uint32_t*>(dst) = packed;
  }
}

__global__ void empty_kernel() {}

unsigned n_blocks(unsigned n_pieces) {
  return (n_pieces + kThreads - 1) / kThreads;
}

// pieces of a (K, N) weight of 16-byte values of 4 (dtype 0: f32) or 8
// (fp16, bf16) elements, or -1 where the launch cannot take the shape
long long pieces_of(int dtype, int K, int N) {
  if (K % 2 || N % kGc || dtype < 0 || dtype > 2) return -1;
  const long long pieces = (long long)(K / 2) * (N / (dtype == 0 ? 4 : 8));
  return pieces > (1ll << 31) - (1ll << 12) ? -1 : pieces;
}

template <typename T>
int launch_typed(const void* w, uint8_t* c, __half* sc, int N,
                 unsigned n_pieces, int wide, cudaStream_t s) {
  const unsigned per_row = N / (16 / sizeof(T));
  Divider by_row{0, 31};
  while ((1u << (by_row.shift - 31)) < per_row) ++by_row.shift;
  by_row.magic = ((1ull << by_row.shift) + per_row - 1) / per_row;
  const T* wt = static_cast<const T*>(w);
  if (wide)
    tile_quantize_kernel<T, true><<<n_blocks(n_pieces), kThreads, 0, s>>>(
        wt, c, sc, N, n_pieces, by_row);
  else
    tile_quantize_kernel<T, false><<<n_blocks(n_pieces), kThreads, 0, s>>>(
        wt, c, sc, N, n_pieces, by_row);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 fp16, 2 bf16.  w (K, N) with K even and N a multiple of
// 16, 16-byte aligned; codes (K, N / 2) uint8 4-byte aligned; scales
// (K / 2, N / 16) fp16.  wide: 1 for loads that fetch 256-byte L2 spans.
// At most 2^31 - 2^12 pieces (32 GiB of weight).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int tile_quantize_launch(int dtype, const void* w, void* codes,
                                    void* scales, int K, int N, int wide,
                                    void* stream) {
  const long long pieces = pieces_of(dtype, K, N);
  if (pieces < 0) return (int)cudaErrorInvalidValue;
  if (pieces == 0) return 0;
  const unsigned n_pieces = (unsigned)pieces;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* c = static_cast<uint8_t*>(codes);
  __half* sc = static_cast<__half*>(scales);
  switch (dtype) {
    case 0:
      return launch_typed<float>(w, c, sc, N, n_pieces, wide, s);
    case 1:
      return launch_typed<__half>(w, c, sc, N, n_pieces, wide, s);
    default:
      return launch_typed<__nv_bfloat16>(w, c, sc, N, n_pieces, wide, s);
  }
}

// An empty kernel on the grid tile_quantize_launch takes for a (K, N)
// weight of ``dtype``: the launch floor its time is read against.
extern "C" int tile_quantize_empty_launch(int dtype, int K, int N,
                                          void* stream) {
  const long long pieces = pieces_of(dtype, K, N);
  if (pieces <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<n_blocks((unsigned)pieces), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
