// Dense Hamming-distance matrix between two sets of packed 256-bit ORB
// descriptors: out[i, j] = sum over the 8 words w of popc(a[i, w] ^ b[j, w]).
//
// Replaces the TPU kernel `ra_slam_tpu/ops/hamming.py:hamming_matrix_pallas`
// (body `_hamming_kernel`). That kernel pads both inputs to 256-row tiles,
// lays B out transposed so the lane axis runs along the match axis, and
// accumulates XOR + population_count over the words on the vector unit.
// Here the ragged edge is masked in the kernel (no padding in the
// wrapper), and the result is written as float32 directly: every value is
// an integer <= 256 and exact in float32, and the matcher consumes float32,
// so no int32 -> float32 pass follows.
//
// Shape: one CTA of 32 x 8 threads per 64 x 128 output tile. The tile's A
// rows and B rows are staged in shared memory as uint32 (B transposed,
// word-major, so the 32 lanes of a warp read 32 consecutive words: no bank
// conflicts; A is read as a warp-wide broadcast). Each thread owns
// 8 rows x 4 columns (rows ty + 8i, columns tx + 32j), so a warp stores
// 32 consecutive floats of one row: coalesced along Kb.
//
// What bounds it on the card: the output bytes (Ka * Kb * 4 written, e.g.
// 80 MB at 1000 x 20000) against 3.35 TB/s, and the integer pipe (8 popc
// per output). Fusing the matcher's projective gate and top-2 reduction so
// that the matrix never reaches device memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kTileA = 64;
constexpr int kTileB = 128;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTileA / kThreadsY;  // 8
constexpr int kColsPerThread = kTileB / kThreadsX;  // 4

__global__ void __launch_bounds__(kThreadsX * kThreadsY) hamming_f32_kernel(
    const uint32_t* __restrict__ a,  // [ka, 8]
    const uint32_t* __restrict__ b,  // [kb, 8]
    float* __restrict__ out,         // [ka, kb]
    int64_t ka, int64_t kb) {
  __shared__ uint32_t sa[kTileA][kWords];
  __shared__ uint32_t sb[kWords][kTileB];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTileA;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTileB;

  // stage the tile: 512 A words and 1024 B words, by 256 threads
  for (int e = tid; e < kTileA * kWords; e += kThreadsX * kThreadsY) {
    const int r = e / kWords, w = e % kWords;
    const int64_t gr = row0 + r;
    sa[r][w] = gr < ka ? a[gr * kWords + w] : 0u;
  }
  for (int e = tid; e < kTileB * kWords; e += kThreadsX * kThreadsY) {
    const int c = e / kWords, w = e % kWords;
    const int64_t gc = col0 + c;
    sb[w][c] = gc < kb ? b[gc * kWords + w] : 0u;
  }
  __syncthreads();

  int acc[kRowsPerThread][kColsPerThread] = {};
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t bw[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) bw[j] = sb[w][tx + kThreadsX * j];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const uint32_t aw = sa[ty + kThreadsY * i][w];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] += __popc(aw ^ bw[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t gr = row0 + ty + kThreadsY * i;
    if (gr >= ka) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int64_t gc = col0 + tx + kThreadsX * j;
      if (gc < kb) out[gr * kb + gc] = static_cast<float>(acc[i][j]);
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or 0). ka, kb >= 1; the wrapper
// validates shapes and types and skips empty sides. Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int hamming_launch(const int32_t* a, const int32_t* b, float* out,
                              int64_t ka, int64_t kb, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid(static_cast<unsigned>((kb + kTileB - 1) / kTileB),
                  static_cast<unsigned>((ka + kTileA - 1) / kTileA));
  hamming_f32_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b), out, ka, kb);
  return static_cast<int>(cudaGetLastError());
}
