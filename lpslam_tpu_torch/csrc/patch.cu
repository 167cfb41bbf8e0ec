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
// Bound: it moves bytes and does no arithmetic. At the operating point
// (B = 16 frames, N = 474 / 396 / 330 keypoints on the 480x640 / 400x533 /
// 333x444 levels) it writes 16 * 1200 * 4 KB, about 78 MB per chunk, and
// reads each window once from L2-resident level images. The design keeps the
// stores coalesced: a 256-thread block walks KP_PER_BLOCK keypoints, and for
// each one thread t stores the float4 at row t / 8, columns 4 * (t % 8) ..
// +3, so one warp writes 512 contiguous bytes. Loads are four scalar reads,
// since the window's start column has no alignment.
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kHalf = 16;
constexpr int kThreads = 256;
constexpr int kPerBlock = 8;

__global__ void __launch_bounds__(kThreads)
patch_kernel(const float* __restrict__ img, const float* __restrict__ xy,
             float* __restrict__ out, int H, int W, int N) {
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int row = t >> 3;
  const int col = (t & 7) * 4;
  const float* frame = img + (size_t)b * H * W;
  for (int k = 0; k < kPerBlock; ++k) {
    const int n = blockIdx.x * kPerBlock + k;
    if (n >= N) return;
    const size_t kp = (size_t)b * N + n;
    int x0 = (int)rintf(xy[kp * 2 + 0]) - kHalf;
    int y0 = (int)rintf(xy[kp * 2 + 1]) - kHalf;
    x0 = min(max(x0, 0), W - kPatch);
    y0 = min(max(y0, 0), H - kPatch);
    const float* src = frame + (size_t)(y0 + row) * W + x0 + col;
    float4 v = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
    reinterpret_cast<float4*>(out + kp * (kPatch * kPatch))[t] = v;
  }
}

}  // namespace

// img (B, H, W), xy (B, N, 2), out (B, N, 1024): contiguous float32 on the
// device. Launches on `stream` and returns cudaGetLastError().
extern "C" int lpslam_extract_patches(const float* img, const float* xy, float* out,
                                      int B, int H, int W, int N, void* stream) {
  if (B > 0 && N > 0) {
    dim3 grid((N + kPerBlock - 1) / kPerBlock, B);
    patch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, xy, out, H, W, N);
  }
  return static_cast<int>(cudaGetLastError());
}
