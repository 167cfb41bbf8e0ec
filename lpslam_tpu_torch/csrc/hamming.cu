// Hamming distances of 256-bit binary descriptors, for sm_90a: the dense
// matrix (lpslam_hamming) and tracking's window-masked matcher fused into
// one launch (lpslam_match_projected).
//
// ---------------------------------------------------------------------------
// lpslam_hamming: lpslam_tpu/kernels/match.py:hamming_matrix, which JAX
// leaves to XLA (XOR + population_count, summed over the 8 words); it is no
// Pallas kernel. out[i][j] = sum_k popc(a[i][k] ^ b[j][k]) over the 8 32-bit
// words, as an int32 (Na, Nb) matrix from (Na, 8) and (Nb, 8) int32 bit
// patterns. Every matcher but tracking's projected one takes it.
//
// Bound: bytes. At 4096 x 1200 the inputs are 170 KB and the output 19.7 MB:
// 5.9 us at 3.35 TB/s. Counted with the integer pipe's __popc (16 per SM
// per clock) the 39.3 M popcounts would take 9.4 us on 132 SMs at 1.98 GHz,
// so this kernel does not count bits one word at a time: the tensor cores'
// single-bit product mma.sync.m16n8k256.b1 (AND + popcount) gives
// c = popc(a & b) for a 16 x 8 tile of descriptor pairs in one instruction
// (k = 256 is one descriptor), and d = popc(a) + popc(b) - 2 c, exact in
// int32, with popc(a) and popc(b) counted once per row and column of a tile.
//
// Design. A block of 256 threads owns 64 rows of a by 128 columns of b. It
// stages both strips in shared memory word-major (sa[word][row],
// sb[word][col], rows padded by 8 words so that the 32 lanes of a fragment
// load hit 32 banks) and counts each row's and column's bits on the way
// (8 lanes per descriptor, a shuffle sum). Each of the 8 warps owns 16 rows
// x 64 columns: one A fragment, then per 8 columns one B fragment, one mma
// and its epilogue written to a 64 x 128 int32 output tile in shared
// memory. The block then stores the tile row by row, each warp 512 bytes of
// one row as 32 16-byte stores (full 128-byte lines), scalar at a ragged
// right edge or when Nb is not a multiple of 4. Na or Nb of 0 launches
// nothing (the wrapper's check), as a grid of 0 blocks is an invalid launch.
//
// ---------------------------------------------------------------------------
// lpslam_match_projected: lpslam_tpu/kernels/match.py:match_projected (XLA,
// no Pallas kernel): for every query q, among the keypoints k with
// valid_q[q], valid_kp[k] and |uv_q[q] - uv_kp[k]|^2 <= r^2 (fp32, rounded
// as PyTorch's dx*dx + dy*dy: no FMA contraction, so pairs on the window's
// edge fall where they fall there; NaN is outside), the Hamming argmin,
// lowest index among equal distances; a row with no such pair gives index 0
// (the argmin of a row that is all BIG), and ok = d1 <= max_distance &
// valid_q with d1 = BIG = 1e9 for such a row. The plain version writes the
// (Nq, Nk) matrix, casts it, builds an (Nq, Nk, 2) difference, masks and
// reduces it: ~10 launches and over 150 MB of traffic at 4096 x 1200 to
// keep 4096 indices and flags.
//
// Bound: at 4096 x 1200 the inputs and outputs are 0.25 MB (0.076 us at
// 3.35 TB/s). The work these inputs need is the bit counting of the pairs
// inside the window (8 XORs and 7 adds on the integer pipe, 8 popcounts on
// the popcount pipe, which issue concurrently): 9,753 pairs on room frames
// at 25 px, 0.019 us on the popcount pipe. The window test of all Nq x Nk
// pairs, which this design does, is not counted (a keypoint grid would test
// only the pairs near each query), so bytes bound it.
//
// Design. The keypoints' pixels and flags are staged in shared memory
// (10.8 KB at Nk = 1200) by one cp.async.bulk (TMA 1-D) copy per array,
// completed on an mbarrier; a Nk above kChunk is taken in chunks. Each
// warp takes one query at a time: its lanes stride over the staged
// keypoints, test the window first and count bits only for the pairs
// inside it, reading those keypoints' words from L2, and keep the first
// (lowest index) of equal minima; a warp-shuffle reduction on (distance,
// index) then picks the lowest index among ties. As many blocks run as
// fit at once, each walking over batches of 16 queries.
//
// Measured at 4096 x 1200 (tools/bench_hamming.py, H100 80GB HBM3 at
// 700 W): 0.0093-0.0095 ms, against 0.0096-0.0097 with the words staged
// too (49 KB a block) and 0.0102 with each lane loading 4 keypoints before
// testing them; 4096 x 32 takes 0.0031-0.0034 ms, so about a third of the
// time does not grow with the work. No profiler runs on that machine to
// say where the rest goes; the byte bound is 0.000076 ms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;

// ---- the dense matrix ------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kTileRows = 64;                 // rows of a per block: 4 warps x 16
constexpr int kTileCols = 128;                // columns of b per block: 2 warps x 64
constexpr int kWarpCols = 64;                 // 8 mma tiles of 8 columns per warp
constexpr int kPadRows = kTileRows + 8;       // sa[word] row: 8 * word + row -> 32 banks
constexpr int kPadCols = kTileCols + 8;       // sb[word] and the output tile's rows

__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage `n` descriptors from `src` (rows first0.. of a row-major (rows, 8)
// array with `limit` rows) word-major into dst[word][pad], and each one's bit
// count into cnt[]. 8 consecutive threads read one descriptor; n * 8 is a
// multiple of the block, so every lane reaches the shuffles.
template <int N, int Pad>
__device__ __forceinline__ void stage_strip(const uint32_t* __restrict__ src, int first,
                                            int limit, uint32_t (*dst)[Pad],
                                            int* __restrict__ cnt) {
#pragma unroll
  for (int i = threadIdx.x; i < N * kWords; i += kThreads) {
    const int r = i / kWords, k = i % kWords;
    const int row = first + r;
    const uint32_t w = row < limit ? __ldg(src + (size_t)row * kWords + k) : 0u;
    dst[k][r] = w;
    int c = __popc(w);
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    c += __shfl_xor_sync(0xffffffffu, c, 4);
    if (k == 0) cnt[r] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int na, int nb) {
  __shared__ uint32_t sa[kWords][kPadRows];
  __shared__ uint32_t sb[kWords][kPadCols];
  __shared__ int pa[kTileRows], pb[kTileCols];
  __shared__ __align__(16) int32_t so[kTileRows][kPadCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = blockIdx.y * kTileRows, col0 = blockIdx.x * kTileCols;

  stage_strip<kTileRows, kPadRows>(a, row0, na, sa, pa);
  stage_strip<kTileCols, kPadCols>(b, col0, nb, sb, pb);
  __syncthreads();

  // the fragments of m16n8k256 .b1 (PTX ISA): lane = 4 g + t holds A's rows
  // g and g + 8 at words t and 4 + t, B's column g at words t and 4 + t, and
  // C's rows g, g + 8 at columns 2t, 2t + 1
  const int g = lane / 4, t = lane % 4;
  const int r = (warp % 4) * 16 + g;
  const uint32_t a0 = sa[t][r], a1 = sa[t][r + 8], a2 = sa[4 + t][r], a3 = sa[4 + t][r + 8];
  const int pr = pa[r], pr8 = pa[r + 8];
  const int cw = (warp / 4) * kWarpCols;
#pragma unroll
  for (int j = 0; j < kWarpCols / 8; ++j) {
    const int cb = cw + j * 8;
    int c[4] = {0, 0, 0, 0};
    mma_and_popc(c, a0, a1, a2, a3, sb[t][cb + g], sb[4 + t][cb + g]);
    const int col = cb + 2 * t;
    const int q0 = pb[col], q1 = pb[col + 1];
    *reinterpret_cast<int2*>(&so[r][col]) = make_int2(pr + q0 - 2 * c[0], pr + q1 - 2 * c[1]);
    *reinterpret_cast<int2*>(&so[r + 8][col]) =
        make_int2(pr8 + q0 - 2 * c[2], pr8 + q1 - 2 * c[3]);
  }
  __syncthreads();

  const bool vec = nb % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int col = col0 + lane * 4;
  for (int rr = warp; rr < kTileRows; rr += kThreads / 32) {
    const int row = row0 + rr;
    if (row >= na) break;
    const int4 v = *reinterpret_cast<const int4*>(&so[rr][lane * 4]);
    int32_t* dst = out + (size_t)row * nb + col;
    if (vec && col + 3 < nb) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      if (col < nb) dst[0] = v.x;
      if (col + 1 < nb) dst[1] = v.y;
      if (col + 2 < nb) dst[2] = v.z;
      if (col + 3 < nb) dst[3] = v.w;
    }
  }
}

// ---- the fused projected matcher ---------------------------------------------
constexpr int kMatchThreads = 512;            // 16 warps, one query each at a time
constexpr int kChunk = 8192;                  // keypoints staged per pass (72 KB)
constexpr int kBig = 1000000000;              // BIG = 1e9 of the plain version, exact in fp32

// the staged arrays of `n` keypoints: pixels (8 B each) from 0, flags (1 B
// each) from valid_offset, each start 16-byte aligned for the bulk copies
__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t valid_offset(int n) { return round16((size_t)n * 8); }
__host__ __device__ constexpr size_t match_smem_bytes(int n) {
  return valid_offset(n) + round16(n);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(phase) : "memory");
}

// Stage keypoints [base, base + n)'s pixels and flags into shared memory:
// thread 0 issues one bulk copy per array for its 16-byte multiple and arms
// the barrier with their bytes; the threads copy the tails (an odd pixel,
// the last flags) themselves. Every thread waits for the barrier's
// `phase`, then the block syncs so the tails are visible. The source arrays
// are 16-byte aligned and base is a multiple of 16 (the wrapper's checks,
// kChunk's size).
__device__ void stage_keypoints(const float2* __restrict__ uv, const uint8_t* __restrict__ valid,
                                int base, int n, float2* s_uv, uint8_t* s_valid,
                                uint64_t* bar, uint32_t phase) {
  const uint32_t uv_bytes = ((uint32_t)n * 8) & ~15u;
  const uint32_t valid_bytes = (uint32_t)n & ~15u;
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(uv_bytes + valid_bytes) : "memory");
    if (uv_bytes) bulk_g2s(s_uv, uv + base, uv_bytes, bar);
    if (valid_bytes) bulk_g2s(s_valid, valid + base, valid_bytes, bar);
  }
  for (int j = uv_bytes / 8 + threadIdx.x; j < n; j += blockDim.x) s_uv[j] = uv[base + j];
  for (int j = valid_bytes + threadIdx.x; j < n; j += blockDim.x) s_valid[j] = valid[base + j];
  mbar_wait(bar, phase);
  __syncthreads();
}

__global__ void __launch_bounds__(kMatchThreads)
match_projected_kernel(const uint4* __restrict__ desc_q, const float2* __restrict__ uv_q,
                       const uint8_t* __restrict__ valid_q, const uint4* __restrict__ desc_kp,
                       const float2* __restrict__ uv_kp, const uint8_t* __restrict__ valid_kp,
                       int64_t* __restrict__ idx_out, uint8_t* __restrict__ ok_out, int nq,
                       int nk, int chunk, float r2, float max_distance) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  float2* s_uv = reinterpret_cast<float2*>(smem);
  uint8_t* s_valid = smem + valid_offset(chunk);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int kWarps = kMatchThreads / 32;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n_chunks = (nk + chunk - 1) / chunk;
  uint32_t phase = 0;
  if (n_chunks == 1) {
    stage_keypoints(uv_kp, valid_kp, 0, nk, s_uv, s_valid, &bar, phase);
    phase ^= 1;
  }
  for (int q0 = blockIdx.x * kWarps; q0 < nq; q0 += gridDim.x * kWarps) {  // block-uniform
    const int q = q0 + warp;
    const bool active = q < nq && valid_q[q];
    float qx = 0.f, qy = 0.f;
    uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
    if (active) {
      const float2 p = uv_q[q];
      qx = p.x;
      qy = p.y;
      w0 = desc_q[2 * q];
      w1 = desc_q[2 * q + 1];
    }
    int best_d = kBig, best_j = 0x7fffffff;
    for (int c = 0; c < n_chunks; ++c) {
      const int base = c * chunk, n = min(chunk, nk - base);
      if (n_chunks > 1) {
        __syncthreads();      // every warp is done with the previous chunk
        stage_keypoints(uv_kp, valid_kp, base, n, s_uv, s_valid, &bar, phase);
        phase ^= 1;
      }
      if (!active) continue;
      for (int j = lane; j < n; j += 32) {
        const float2 p = s_uv[j];
        const float dx = __fsub_rn(qx, p.x), dy = __fsub_rn(qy, p.y);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (d2 <= r2 && s_valid[j]) {
          // inside the window (~0.6% of the pairs at 25 px): the keypoint's
          // words from L2, where the 38 KB of them stay
          const uint4 k0 = __ldg(desc_kp + 2 * (base + j));
          const uint4 k1 = __ldg(desc_kp + 2 * (base + j) + 1);
          const int d = __popc(w0.x ^ k0.x) + __popc(w0.y ^ k0.y) + __popc(w0.z ^ k0.z) +
                        __popc(w0.w ^ k0.w) + __popc(w1.x ^ k1.x) + __popc(w1.y ^ k1.y) +
                        __popc(w1.z ^ k1.z) + __popc(w1.w ^ k1.w);
          if (d < best_d) {       // j rises within a lane: the first minimum stays
            best_d = d;
            best_j = base + j;
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const int od = __shfl_xor_sync(0xffffffffu, best_d, off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
      if (od < best_d || (od == best_d && oj < best_j)) {
        best_d = od;
        best_j = oj;
      }
    }
    if (lane == 0 && q < nq) {
      idx_out[q] = best_d == kBig ? 0 : best_j;
      ok_out[q] = active && static_cast<float>(best_d) <= max_distance;
    }
  }
}

}  // namespace

// (na, 8) and (nb, 8) 32-bit words -> (na, nb) int32 Hamming distances, on
// `stream`; na and nb > 0. Returns the launch's CUDA error code (0 = none).
extern "C" int lpslam_hamming(const void* a, const void* b, void* out, int na, int nb,
                              void* stream) {
  const dim3 grid((nb + kTileCols - 1) / kTileCols, (na + kTileRows - 1) / kTileRows);
  hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), na, nb);
  return static_cast<int>(cudaGetLastError());
}

// Tracking's projected matcher: queries (nq, 8) words, (nq, 2) fp32 pixels,
// (nq,) bool; keypoints the same with nk rows; r2 the window's squared
// radius and max_distance the Hamming gate, both as fp32; -> idx (nq,)
// int64 and ok (nq,) bool. nq and nk > 0; every array contiguous and 16-byte
// aligned. Returns the launch's CUDA error code (0 = none).
extern "C" int lpslam_match_projected(const void* desc_q, const void* uv_q,
                                      const void* valid_q, const void* desc_kp,
                                      const void* uv_kp, const void* valid_kp, void* idx,
                                      void* ok, int nq, int nk, float r2,
                                      float max_distance, void* stream) {
  static int sms = 0;
  static size_t smem_set = 0;
  const int chunk = nk < kChunk ? nk : kChunk;
  const size_t smem = match_smem_bytes(chunk);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_projected_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(match_smem_bytes(kChunk)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = match_smem_bytes(kChunk);
  }
  // as many blocks as fit on the card at once (at most 4 of 512 threads per
  // SM), each walking over batches of 16 queries
  const size_t per_sm = (227 * 1024) / (smem + 1024);
  const int blocks = sms * static_cast<int>(per_sm < 4 ? per_sm : 4);
  const int batches = (nq + kMatchThreads / 32 - 1) / (kMatchThreads / 32);
  const int grid = batches < blocks ? batches : blocks;
  match_projected_kernel<<<grid, kMatchThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc_q), static_cast<const float2*>(uv_q),
      static_cast<const uint8_t*>(valid_q), static_cast<const uint4*>(desc_kp),
      static_cast<const float2*>(uv_kp), static_cast<const uint8_t*>(valid_kp),
      static_cast<int64_t*>(idx), static_cast<uint8_t*>(ok), nq, nk, chunk, r2,
      max_distance);
  return static_cast<int>(cudaGetLastError());
}
