// Fused two-threshold FAST-9/16 score + 3x3 non-max suppression, for sm_90a.
//
// Replaces the TPU kernel lpslam_tpu/kernels/pallas_fast.py:
// fast_nms_score_pallas (body _band_kernel). Same result, bit for bit, as the
// plain PyTorch version (kernels/fast_nms.py::fast_nms_score_reference):
//   for each threshold t in (thr_hi, thr_lo): over the 16 circle taps in
//   CIRCLE16 order, d = tap - centre; bright bit k = d > t, dark bit k =
//   d < -t; the bright sum adds d - t and the dark sum -d - t, in that order
//   from 0.0f; a corner has a run of 9 set bits on the circle; its score is
//   max(bright sum, dark sum), else 0; pixels within 3 of the border score 0.
//   score = s_hi > 0 ? 1 + s_hi : s_lo * ceiling (the fixed ceiling
//   1e-3 / (1 + 255 * 16), rounded to float32), then a pixel with a strictly
//   greater 8-neighbour becomes 0 (plateaus survive).
//
// The TPU version cuts the image into 64-row bands with an 8-row halo, DMAs
// each band into VMEM and shifts it with pltpu.roll; none of that carries
// over. Here one launch covers a whole (B, H, W) batch of one pyramid level
// (frame index in blockIdx.z). A 32x8 block owns a 32x32 output tile: it
// loads the tile plus a 4-pixel halo (3 for the taps, 1 for the NMS) into
// shared memory, computes the blended score of the tile plus a 1-pixel ring
// into a second shared array, syncs, and applies the NMS from there.
//
// Pixels outside the image are loaded as 0 and score 0. That matches the
// plain version, which shifts with wrap-around: the interior mask zeroes the
// 3-pixel border, so only zero-scored pixels ever read a wrapped neighbour.
//
// Bound: arithmetic. Each pixel does 16 taps x 2 thresholds of compare, mask
// and add work (~200 operations) for 8 bytes of device traffic, and the halo
// makes each block read 1.56x its tile. Compiled without fast-math, and no
// expression here contracts into an FMA, so every float is rounded as in the
// plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;           // threads per block, x
constexpr int kBY = 8;            // threads per block, y
constexpr int kTX = 32;           // output tile width
constexpr int kTY = 32;           // output tile height
constexpr int kHalo = 4;          // 3 (FAST taps) + 1 (NMS)
constexpr int kIW = kTX + 2 * kHalo;
constexpr int kIH = kTY + 2 * kHalo;
constexpr int kSW = kTX + 2;      // score tile: output tile + 1-pixel ring
constexpr int kSH = kTY + 2;

// CIRCLE16 (kernels/fast.py): (dx, dy) on the radius-3 Bresenham circle.
__constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool has_run9(uint32_t m16) {
  const uint32_t m = m16 | (m16 << 16);
  uint32_t r = m & (m >> 1);
  r = r & (r >> 2);
  r = r & (r >> 4);
  r = r & (m >> 8);
  return (r & 0xFFFFu) != 0u;
}

// Blended score of the pixel at (ly, lx) of the shared input tile.
__device__ __forceinline__ float blended_score(const float (*tile)[kIW + 1], int ly, int lx,
                                               float thr_hi, float thr_lo, float ceiling) {
  const float c = tile[ly][lx];
  uint32_t bh = 0u, dh = 0u, bl = 0u, dl = 0u;
  float bsh = 0.0f, dsh = 0.0f, bsl = 0.0f, dsl = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = tile[ly + kDY[k]][lx + kDX[k]] - c;
    if (d > thr_hi) { bh |= 1u << k; bsh = bsh + (d - thr_hi); }
    if (d < -thr_hi) { dh |= 1u << k; dsh = dsh + (-d - thr_hi); }
    if (d > thr_lo) { bl |= 1u << k; bsl = bsl + (d - thr_lo); }
    if (d < -thr_lo) { dl |= 1u << k; dsl = dsl + (-d - thr_lo); }
  }
  const float s_hi = (has_run9(bh) || has_run9(dh)) ? fmaxf(bsh, dsh) : 0.0f;
  const float s_lo = (has_run9(bl) || has_run9(dl)) ? fmaxf(bsl, dsl) : 0.0f;
  return s_hi > 0.0f ? 1.0f + s_hi : s_lo * ceiling;
}

__global__ void __launch_bounds__(kBX * kBY)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                float thr_hi, float thr_lo, float ceiling) {
  __shared__ float tile[kIH][kIW + 1];
  __shared__ float score[kSH][kSW + 1];
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.y * kBX + threadIdx.x;

  for (int i = tid; i < kIH * kIW; i += kBX * kBY) {
    const int ly = i / kIW, lx = i % kIW;
    const int gy = y0 - kHalo + ly, gx = x0 - kHalo + lx;
    tile[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? __ldg(img + frame + (size_t)gy * W + gx) : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < kSH * kSW; i += kBX * kBY) {
    const int ly = i / kSW, lx = i % kSW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const bool interior = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3;
    score[ly][lx] = interior ? blended_score(tile, ly + kHalo - 1, lx + kHalo - 1,
                                             thr_hi, thr_lo, ceiling)
                             : 0.0f;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x;
  for (int ry = threadIdx.y; ry < kTY; ry += kBY) {
    const int gy = y0 + ry;
    if (gy >= H || gx >= W) continue;
    const int sy = ry + 1, sx = threadIdx.x + 1;
    const float c = score[sy][sx];
    bool suppressed = false;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        if (dy != 0 || dx != 0) suppressed |= score[sy + dy][sx + dx] > c;
    out[frame + (size_t)gy * W + gx] = suppressed ? 0.0f : c;
  }
}

}  // namespace

// img, out: (B, H, W) contiguous float32 on the device. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int lpslam_fast_nms_score(const float* img, float* out, int B, int H, int W,
                                     float thr_hi, float thr_lo, float ceiling,
                                     void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B);
    dim3 block(kBX, kBY);
    fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        img, out, H, W, thr_hi, thr_lo, ceiling);
  }
  return static_cast<int>(cudaGetLastError());
}
