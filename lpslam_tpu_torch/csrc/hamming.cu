// Hamming distance matrix of 256-bit binary descriptors, for sm_90a.
//
// Computes lpslam_tpu/kernels/match.py:hamming_matrix, which JAX leaves to
// XLA (XOR + population_count, summed over the 8 words); it is no Pallas
// kernel. out[i][j] = sum_k popc(a[i][k] ^ b[j][k]) over the 8 32-bit words,
// as an int32 (Na, Nb) matrix from (Na, 8) and (Nb, 8) int32 bit patterns.
//
// Bound: operations. At the tracker's matching size, 4096 local-map points
// x 1200 keypoints, the inputs are 170 KB and the output 19.7 MB (5.9 us at
// 3.35 TB/s), while the 39.3 M popcounts issue at 16 per SM per clock (the
// integer pipe's rate for __popc on sm_90): 9.4 us on 132 SMs at 1.98 GHz.
// The XORs and adds go to the 64-lane pipes and hide behind them.
//
// Design, simple and right first. A block of 256 threads owns a tile of
// kRowsA rows of a by kColsB columns of b. It stages both strips in shared
// memory, b transposed (word-major) so that the 32 lanes of a warp read 32
// neighbouring columns of one word without bank conflicts, and a row-major
// so that a warp's lanes, which share rows, read one broadcast word. Each
// thread keeps the 8 words of its kCols columns in registers and computes a
// kRows x kCols block of outputs; the lanes of a warp own neighbouring
// columns, so every store of a row is one coalesced 128-byte request.
// Ragged edges are masked; Na or Nb of 0 launches nothing (the wrapper's
// check), as a grid of 0 blocks is an invalid launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kThreadsX = 32;                // lanes: columns of b
constexpr int kThreadsY = 8;                 // warps: rows of a
constexpr int kCols = 4;                     // columns per thread
constexpr int kRows = 4;                     // rows per thread
constexpr int kColsB = kThreadsX * kCols;    // 128 columns per block
constexpr int kRowsA = kThreadsY * kRows;    // 32 rows per block

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int na, int nb) {
  __shared__ uint32_t sb[kWords][kColsB];
  __shared__ uint32_t sa[kRowsA][kWords];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int col0 = blockIdx.x * kColsB;
  const int row0 = blockIdx.y * kRowsA;

  for (int i = tid; i < kColsB * kWords; i += kThreadsX * kThreadsY) {
    const int c = i / kWords, k = i % kWords;      // consecutive threads: one row of b
    const int col = col0 + c;
    sb[k][c] = col < nb ? __ldg(b + (size_t)col * kWords + k) : 0u;
  }
  {
    const int r = tid / kWords, k = tid % kWords;  // 256 threads: 32 rows x 8 words
    const int row = row0 + r;
    sa[r][k] = row < na ? __ldg(a + (size_t)row * kWords + k) : 0u;
  }
  __syncthreads();

  uint32_t bw[kCols][kWords];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int k = 0; k < kWords; ++k) bw[j][k] = sb[k][tx + j * kThreadsX];

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + i * kThreadsY;
    const int row = row0 + r;
    if (row >= na) break;
    uint32_t aw[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) aw[k] = sa[r][k];
    int32_t* dst = out + (size_t)row * nb;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = col0 + tx + j * kThreadsX;
      int d = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) d += __popc(aw[k] ^ bw[j][k]);
      if (col < nb) dst[col] = d;
    }
  }
}

}  // namespace

// (na, 8) and (nb, 8) 32-bit words -> (na, nb) int32 Hamming distances, on
// `stream`; na and nb > 0. Returns the launch's CUDA error code (0 = none).
extern "C" int lpslam_hamming(const void* a, const void* b, void* out, int na, int nb,
                              void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((nb + kColsB - 1) / kColsB, (na + kRowsA - 1) / kRowsA);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), na, nb);
  return static_cast<int>(cudaGetLastError());
}
