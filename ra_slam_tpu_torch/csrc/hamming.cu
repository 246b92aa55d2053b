// Dense Hamming-distance matrix between two sets of packed 256-bit ORB
// descriptors: out[i, j] = number of bits in which a[i] and b[j] differ,
// an exact integer in 0..256, written as float32 [ka, kb].
//
// Replaces the TPU kernel `ra_slam_tpu/ops/hamming.py:hamming_matrix_pallas`
// (body `_hamming_kernel`), which accumulates XOR + population_count over
// the 8 words on the vector unit.
//
// What bounds it on the card: the output bytes. It must write ka * kb * 4
// bytes (80 MB at 1000 x 20000, 24 us at 3.35 TB/s) and reads only
// (ka + kb) * 32. The earlier design counted bits with 8 `__popc` per
// output: Hopper retires 16 popc per clock per SM, so at 1000 x 20000 the
// integer pipe needed ~40 us and the kernel sat at that ceiling, 1.8x
// above the write floor. Here the tensor cores count the bits: one binary
// `mma.sync.m16n8k256...b1.and.popc` takes a 16 x 8 block of outputs over
// all 256 bits, straight from the packed words, with nothing unpacked:
//   popc(a ^ b) = popc(a) + popc(b) - 2 * popc(a & b),
// the per-row popcounts taken once per tile. That leaves the integer pipe
// ~2 operations per output (against 8 popc and 8 XOR before), and the
// kernel is left with the stores.
//
// Design: one CTA of 8 warps per 128 x 128 output tile, over a 1-D grid of
// tiles, 68 KB of shared memory, three CTAs resident on each SM so that
// one tile's stores overlap the others' loads and products.
//  1. Each warp owns a 64 x 32 sub-tile. Its lanes load their fragments
//     straight from global memory (the descriptors are small and stay in
//     L2): lane (g, t) of the MMA's layout takes words 2t and 2t+1 of its
//     rows g and g + 8 (A) and of its column g (B), one 8-byte load each,
//     rows past ka or kb read as 0. The MMA pairs K positions by t on both
//     sides, so any fixed assignment of words to lanes gives the same
//     counts.
//  2. The lanes of a quad sum the popcounts of their words to the row's
//     and the column's; shuffles bring each lane those of its outputs.
//  3. 16 MMAs per warp cover the sub-tile; distance = pa + pb - 2 * acc,
//     converted to float32 exactly (below).
//  4. The distances go through shared memory (rows padded by 8 floats, no
//     bank conflicts) and leave as 16-byte stores, one warp per 512
//     contiguous bytes of a row, with the default cache policy: the
//     matcher reads the matrix right after. When kb % 4 != 0 the rows are
//     not 16-byte aligned, and the tile leaves in 4-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;          // 32-bit words per descriptor
constexpr int kTile = 128;         // output rows and columns per CTA
constexpr int kThreads = 256;      // 8 warps: 2 along rows x 4 along columns
constexpr int kLdc = kTile + 8;    // staging row stride in floats
constexpr int kSmemBytes = kTile * kLdc * 4;  // 68 KB
constexpr unsigned kFull = 0xffffffffu;

// popc(a & b) summed over the 256 bits of a row of A and a column of B.
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An integer 0..256 as float32 without the slow int -> float conversion:
// the bit pattern 0x4B400000 + d is the float 1.5 * 2^23 + d, exact for
// |d| < 2^22, and one subtraction leaves d, also exact.
__device__ __forceinline__ float to_float(int d) {
  return __int_as_float(0x4B400000 + d) - 12582912.0f;
}

// Words 2t and 2t + 1 of descriptor `row`; a row past the end reads as 0.
__device__ __forceinline__ uint2 words(const uint32_t* __restrict__ p, int64_t row, int64_t rows, int t) {
  return row < rows ? __ldg(reinterpret_cast<const uint2*>(p + row * kWords) + t) : make_uint2(0u, 0u);
}

// Sum over the 4 lanes of a quad (the lanes that share g).
__device__ __forceinline__ int quad_sum(int x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__global__ void __launch_bounds__(kThreads, 3) hamming_popc_mma_kernel(
    const uint32_t* __restrict__ a,  // [ka, 8]
    const uint32_t* __restrict__ b,  // [kb, 8]
    float* __restrict__ out,         // [ka, kb]
    int64_t ka, int64_t kb, int64_t tiles_n) {
  extern __shared__ __align__(16) float staging[];  // [128][kLdc]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // rows 64 wm .. +63, columns 32 wn .. +31
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) / tiles_n) * kTile;
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) % tiles_n) * kTile;

  // 1. fragments: af[mt] = rows g, g + 8 of row block mt; bf[nt] = column g
  uint32_t af[4][4], bf[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int64_t r = row0 + wm * 64 + mt * 16 + g;
    const uint2 lo = words(a, r, ka, t), hi = words(a, r + 8, ka, t);
    af[mt][0] = lo.x;
    af[mt][1] = hi.x;
    af[mt][2] = lo.y;
    af[mt][3] = hi.y;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const uint2 w = words(b, col0 + wn * 32 + nt * 8 + g, kb, t);
    bf[nt][0] = w.x;
    bf[nt][1] = w.y;
  }

  // 2. popcounts: pa of rows g, g + 8; pb of this lane's columns 2t, 2t + 1
  int pa[4][2], pb[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    pa[mt][0] = quad_sum(__popc(af[mt][0]) + __popc(af[mt][2]));
    pa[mt][1] = quad_sum(__popc(af[mt][1]) + __popc(af[mt][3]));
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = quad_sum(__popc(bf[nt][0]) + __popc(bf[nt][1]));  // column g
    pb[nt][0] = __shfl_sync(kFull, col, 8 * t);                        // column 2t
    pb[nt][1] = __shfl_sync(kFull, col, 8 * t + 4);                    // column 2t + 1
  }

  // 3. products, 4. distances into the staging tile
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      int c4[4] = {0, 0, 0, 0};
      mma_and_popc(c4, af[mt], bf[nt][0], bf[nt][1]);
      const int r = wm * 64 + mt * 16 + g, c = wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(staging + r * kLdc + c) =
          make_float2(to_float(pa[mt][0] + pb[nt][0] - 2 * c4[0]), to_float(pa[mt][0] + pb[nt][1] - 2 * c4[1]));
      *reinterpret_cast<float2*>(staging + (r + 8) * kLdc + c) =
          make_float2(to_float(pa[mt][1] + pb[nt][0] - 2 * c4[2]), to_float(pa[mt][1] + pb[nt][1] - 2 * c4[3]));
    }
  }
  __syncthreads();

  constexpr int kRowsPerWarp = kTile / (kThreads / 32);  // 16
  if (kb % 4 == 0) {
    const int64_t gc = col0 + 4 * lane;
#pragma unroll 4
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int64_t gr = row0 + r;
      if (gr < ka && gc < kb)
        *reinterpret_cast<float4*>(out + gr * kb + gc) =
            *reinterpret_cast<const float4*>(staging + r * kLdc + 4 * lane);
    }
  } else {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int64_t gr = row0 + r;
      if (gr >= ka) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (col0 + c < kb) out[gr * kb + col0 + c] = staging[r * kLdc + c];
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or 0). ka, kb >= 1; the wrapper
// validates shapes, types and the 8-byte alignment of a and b, and skips
// empty sides. Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int hamming_launch(const int32_t* a, const int32_t* b, float* out,
                              int64_t ka, int64_t kb, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      hamming_popc_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles_n = (kb + kTile - 1) / kTile;
  const int64_t tiles = ((ka + kTile - 1) / kTile) * tiles_n;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  hamming_popc_mma_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b), out, ka, kb, tiles_n);
  return static_cast<int>(cudaGetLastError());
}
