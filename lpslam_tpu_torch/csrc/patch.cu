// Batched 32x32 patch extraction around ORB keypoints, for sm_90a.
//
// Replaces the TPU kernel lpslam_tpu/kernels/pallas_patch.py:
// extract_patches_pallas (body _patch_kernel). Same result: for keypoint n of
// frame b, round its centre half-to-even (rintf, as jnp.round does), subtract
// 16, clamp to [0, H-32] x [0, W-32], and copy the 32x32 window of the
// blurred level image into row (b, n) of a (B, N, 1024) float32 output.
//
// The TPU version keeps the image in VMEM and uses aligned loads plus
// pltpu.roll only because Mosaic allows no unaligned slice starts; Hopper has
// no such rule, so nothing of that scheme is carried over.
//
// Bound: bytes; it does no arithmetic. Each image byte that some window
// covers read once, each output byte written once, at 3.35 TB/s. The covered
// part depends on the keypoints (chip_smoke.py counts the union of the
// windows it times); with the whole image read it is, per level 480x640 /
// 400x533 / 333x444 with N = 474 / 396 / 330 keypoints, at most
//   B = 16: 50.8 / 39.7 / 31.1 MB -> 15.2 / 11.8 / 9.3 us;
//   B = 1 (the host path): 3.17 / 2.48 / 1.95 MB -> 0.95 / 0.74 / 0.58 us,
//   below the few microseconds any launch takes.
// The output of a chunk (78.6 MB) is larger than the 50 MB L2 while the level
// images (42.8 MB) nearly fit, and every window is read from an image the
// blur has just written. What the card offers here is L2 residency, memory
// level parallelism and the store policy; TMA does not fit: a tiled tensor
// map needs row strides that are multiples of 16 bytes (533 columns x 4 B =
// 2132 B is not), and a bulk 1-D copy needs a 16-byte-aligned source, while
// a window starts at any column.
//
// Design. A warp, not a block, owns the work: lane l copies column l of
// kRows rows of one window. Each row is one 128-byte request on either side
// (an unaligned load of 32 neighbouring floats, an aligned store), so no
// request touches a cache line twice, where the first version's four scalar
// loads per float4 touched each line four times. All kRows loads go
// into registers before the first store, so a warp has kRows rows in flight
// and a block of four independent warps never waits on one keypoint's
// latency. The keypoint's centre is one broadcast 8-byte load per warp. The
// stores are streaming (st.global.cs): the patches are written once and read
// by a later kernel, and they should not push the level images out of L2.
// kRows is 8, four warps per window: one frame's 330-474 windows (the host
// path) then still spread over the 132 SMs, and a chunk's 5,280-7,584
// windows measured the same at 8, 16 and 32 rows per warp.
// Measured and not kept: 32, 16 and 4 rows per warp, default-policy stores
// (the cold image reads then miss L2 more often), and the first version's
// layout of four scalar loads and one float4 store per thread.
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kHalf = 16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // rows of a window that one warp copies
constexpr int kParts = kPatch / kRows;

__global__ void __launch_bounds__(kThreads)
patch_kernel(const float* __restrict__ img, const float* __restrict__ xy,
             float* __restrict__ out, int H, int W, int N, int total) {
  const int lane = threadIdx.x & 31;
  const int work = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int kp = work / kParts;
  const int part = work % kParts;
  if (kp >= total) return;
  const float2 c = __ldg(reinterpret_cast<const float2*>(xy) + kp);
  int x0 = (int)rintf(c.x) - kHalf;
  int y0 = (int)rintf(c.y) - kHalf;
  x0 = min(max(x0, 0), W - kPatch);
  y0 = min(max(y0, 0), H - kPatch);
  const float* win = img + (size_t)(kp / N) * H * W + (size_t)y0 * W + x0;
  float* dst = out + (size_t)kp * (kPatch * kPatch);
  const float* src = win + (size_t)(part * kRows) * W + lane;
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = __ldg(src + (size_t)r * W);
  dst += part * kRows * kPatch + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) __stcs(dst + r * kPatch, v[r]);
}

}  // namespace

// img (B, H, W), xy (B, N, 2), out (B, N, 1024): contiguous float32 on the
// device. Launches on `stream` and returns cudaGetLastError().
extern "C" int lpslam_extract_patches(const float* img, const float* xy, float* out,
                                      int B, int H, int W, int N, void* stream) {
  if (B > 0 && N > 0) {
    const int total = B * N;
    const long long warps = (long long)total * kParts;
    const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
    patch_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, xy, out, H, W, N, total);
  }
  return static_cast<int>(cudaGetLastError());
}
