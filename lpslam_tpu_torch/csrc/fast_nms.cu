// Fused two-threshold FAST-9/16 score + 3x3 non-max suppression, and the
// per-frame maximum of the low-threshold score, for sm_90a.
//
// Replaces the TPU kernel lpslam_tpu/kernels/pallas_fast.py:
// fast_nms_score_pallas (body _band_kernel). Same result, bit for bit, as the
// plain PyTorch versions (kernels/fast_nms.py):
//   for each threshold t in (thr_hi, thr_lo): over the 16 circle taps in
//   CIRCLE16 order, d = tap - centre; bright bit k = d > t, dark bit k =
//   d < -t; the bright sum adds d - t and the dark sum -d - t, in that order
//   from 0.0f; a corner has a run of 9 set bits on the circle; its score is
//   max(bright sum, dark sum), else 0; pixels within 3 of the border score 0.
//   score = s_hi > 0 ? 1 + s_hi : s_lo * ceiling[frame], then a pixel with a
//   strictly greater 8-neighbour becomes 0 (plateaus survive).
// The ceiling is an operand, one float per frame, as the Pallas kernel takes
// its lo_ceiling: the fixed 1e-3 / (1 + 255 * 16) of the fused form, or
// 1e-3 / (1 + max s_lo of the frame) of the composite that the monocular
// path runs. For the latter, a max pass first reduces each frame's
// low-threshold score to its maximum: blocks run in no order, so each takes
// its own maximum and joins it with atomicMax on the bit pattern of the
// non-negative float (which orders like the float). max is exact, so the
// result does not depend on the order.
//
// The TPU version cuts the image into 64-row bands with an 8-row halo, DMAs
// each band into VMEM and shifts it with pltpu.roll; none of that carries
// over. One launch covers a whole (B, H, W) batch of one pyramid level
// (frame index in blockIdx.z).
//
// Bound. Bytes: 8 per pixel (read once, written once), per level 480x640 /
// 400x533 / 333x444 at 3.35 TB/s: B = 16: 39.3 / 27.3 / 18.9 MB -> 11.7 /
// 8.1 / 5.7 us; B = 1: 0.73 / 0.51 / 0.35 us; the max pass reads 4 bytes per
// pixel and writes none, half these times. Operations, at the card's
// 33.5 T non-FMA fp32 operations/s: they depend on the image, because a
// pixel that is no corner at thr_lo needs no sum. chip_smoke.py counts them
// for the images it times (every pixel 12 for blend and NMS, an interior
// pixel 20 for the compass test, a pixel that passes it 98 for the masks
// and run tests, a thr_lo corner 101, a thr_hi corner 19) and states which
// bound is the larger: bytes on textured frames, operations on noise. The
// count is this design's own work (its compass test and sign-bit masks), not
// a proven least for the function, so the operation bound errs high.
//
// Design. The first version did the full work on every pixel: 64 compares,
// 4 masks and 4 predicated sums, taps addressed through __constant__ offset
// tables, about 600 lane-cycles a pixel, which is what its time was (5
// cycles per pixel and SM). Few pixels need that work: on a textured frame
// one in ten has two bright or two dark compass taps, one in twenty is a
// thr_lo corner. But an early exit per thread saves nothing while a warp's
// 32 neighbouring pixels hold one such pixel, and they nearly always do (a
// design that only added the exits ran as long as the first version). So
// the block sorts the work instead:
// 1. a block of 256 threads stages its 64x32 tile plus a 4-pixel halo (3 for
//    the taps, 1 for the NMS ring) in shared memory: a warp takes every
//    eighth row, and all of its 15 loads are in flight before the first store.
//    Pixels outside the image are staged as 0; they are never read as a
//    centre, since only pixels 3 inside the image are scored, and that also
//    makes the result equal to the plain version's wrap-around: a wrapped
//    neighbour is a border pixel, which scores 0;
// 2. every pixel of the tile and its 1-pixel ring takes the compass test: a
//    run of 9 covers at least two of the taps 0, 4, 8, 12, so a pixel whose
//    second largest compass difference is not above thr_lo and whose second
//    smallest is not below -thr_lo scores 0 after 5 loads. A thread walks
//    down 12 rows of one column, its taps at immediate offsets, and each
//    warp appends the pixels that pass to its own queue in shared memory
//    (positions from a ballot; no atomics, no block barrier);
// 3. the warp takes its queue's entries, so every lane has a candidate: 16
//    differences at immediate offsets (the circle is a macro list), the
//    thr_lo masks from sign bits with one funnel shift each, the run test;
//    a thr_lo corner takes its sums, then the thr_hi masks from the
//    differences in registers (for thr_hi >= thr_lo they are subsets of
//    the thr_lo masks, so no other pixel can be a thr_hi corner; the entry
//    point refuses thr_hi < thr_lo). A sum adds max(d - t, 0) tap by tap in
//    CIRCLE16 order from 0.0f: that is the plain version's d - t where
//    d > t and its 0.0f elsewhere, with no predicate. Nothing here can
//    contract into an FMA, and denormals are kept, so the sign of a
//    computed difference is the sign of the exact one;
// 4. the NMS reads the blended scores from shared memory: a thread walks
//    down 8 rows of one column with the maxima of the two previous rows in
//    registers, 3 loads per pixel.
// The max pass is the same kernel without ring, score tile and NMS: it
// reduces the thr_lo scores of its queue.
// What is left: about 150 instructions per output pixel in the SASS
// (staging 16 per loaded pixel, the compass stage 53 per pixel with a fifth
// of its lanes idle, the NMS 21, a candidate up to 450 on its longest
// path), so the kernel is bound by instruction throughput and runs at about a
// third of its byte bound on textured frames (PERF.md). Measured and not
// kept: scoring a pixel that passes the compass test in place, in its own
// thread, and queueing every interior pixel without the compass test.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kHalo = 4;                    // 3 (FAST taps) + 1 (NMS)
constexpr int kPitch = kTileW + 2 * kHalo;
constexpr int kNmsRows = kTileW * kTileH / kThreads;  // rows a thread of the NMS walks
constexpr unsigned kFull = 0xFFFFFFFFu;

// CIRCLE16 (kernels/fast.py): T(k, dx, dy) on the radius-3 Bresenham circle.
#define LPSLAM_CIRCLE16(T)                                                       \
  T(0, 0, -3) T(1, 1, -3) T(2, 2, -2) T(3, 3, -1) T(4, 3, 0) T(5, 3, 1)          \
  T(6, 2, 2) T(7, 1, 3) T(8, 0, 3) T(9, -1, 3) T(10, -2, 2) T(11, -3, 1)         \
  T(12, -3, 0) T(13, -3, -1) T(14, -2, -2) T(15, -1, -3)

// A run of 9 set bits on the 16-bit circle (in either direction).
__device__ __forceinline__ bool has_run9(uint32_t m16) {
  const uint32_t m = m16 | (m16 << 16);
  uint32_t r = m & (m >> 1);
  r = r & (r >> 2);
  r = r & (r >> 4);
  r = r & (m >> 8);
  return (r & 0xFFFFu) != 0u;
}

// At least two bright or two dark compass taps at threshold t: the second
// largest of the four differences is above t, or the second smallest below
// -t (a sorting network of 8 min/max, which are exact).
__device__ __forceinline__ bool compass_test(const float* p, float t) {
  const float c = p[0];
  const float n = p[-3 * kPitch] - c, e = p[3] - c, s = p[3 * kPitch] - c, w = p[-3] - c;
  const float x = fminf(fmaxf(n, e), fmaxf(s, w));
  const float y = fmaxf(fminf(n, e), fminf(s, w));
  return fmaxf(x, y) > t || fminf(x, y) < -t;
}

// Bright and dark masks of the 16 differences at threshold t, tap 0 in bit
// 15: d > t is the sign bit of t - d, d < -t the sign bit of d + t.
__device__ __forceinline__ void masks(const float (&d)[16], float t, uint32_t& bright,
                                      uint32_t& dark) {
  bright = 0u;
  dark = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    bright = __funnelshift_l(__float_as_uint(t - d[k]), bright, 1);
    dark = __funnelshift_l(__float_as_uint(d[k] + t), dark, 1);
  }
}

// max(bright sum, dark sum) at threshold t, each summed in CIRCLE16 order.
__device__ __forceinline__ float sums(const float (&d)[16], float t) {
  float bs = 0.0f, ds = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    bs = bs + fmaxf(d[k] - t, 0.0f);
    ds = ds + fmaxf(-d[k] - t, 0.0f);
  }
  return fmaxf(bs, ds);
}

// (s_lo, s_hi) of the interior pixel at p in the shared tile. kHi = false
// leaves s_hi at 0.
template <bool kHi>
__device__ __forceinline__ float2 fast_scores(const float* p, float thr_hi, float thr_lo) {
  const float c = p[0];
  float d[16];
#define LPSLAM_TAP(k, dx, dy) d[k] = p[(dy) * kPitch + (dx)] - c;
  LPSLAM_CIRCLE16(LPSLAM_TAP)
#undef LPSLAM_TAP
  uint32_t bright, dark;
  masks(d, thr_lo, bright, dark);
  if (!has_run9(bright) && !has_run9(dark)) return make_float2(0.0f, 0.0f);
  float2 out = make_float2(sums(d, thr_lo), 0.0f);
  if (kHi) {
    masks(d, thr_hi, bright, dark);
    if (has_run9(bright) || has_run9(dark)) out.y = sums(d, thr_hi);
  }
  return out;
}

// kMaxPass = false: out = NMS of the blended score. kMaxPass = true: joins
// the tile's maximum thr_lo score into frame_max_bits[frame].
template <bool kMaxPass>
__global__ void __launch_bounds__(kThreads, 4)
fast_kernel(const float* __restrict__ img, const float* __restrict__ ceiling,
            float* __restrict__ out, int* __restrict__ frame_max_bits, int H, int W,
            float thr_hi, float thr_lo) {
  constexpr int kRing = kMaxPass ? 0 : 1;
  constexpr int kRW = kTileW + 2 * kRing;   // the scored region: the tile and its ring
  constexpr int kRH = kTileH + 2 * kRing;
  constexpr int kRegion = kRW * kRH;
  __shared__ float tile[(kTileH + 2 * kHalo) * kPitch];
  __shared__ float score[kMaxPass ? 1 : kRegion];
  // the compass test: a thread walks kSegRows rows of one region column
  constexpr int kSegs = kThreads / kRW;
  constexpr int kSegRows = (kRH + kSegs - 1) / kSegs;
  __shared__ unsigned short queue[kThreads / 32][32 * kSegRows];  // per warp
  __shared__ float warp_max[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bx0 = blockIdx.x * kTileW;
  const int by0 = blockIdx.y * kTileH;
  const size_t frame = (size_t)blockIdx.z * H * W;

  // a warp stages every eighth row of the tile, a row in three requests of
  // 32 lanes; every load is in flight before the first store
  {
    constexpr int kRows = (kTileH + 2 * kHalo) / (kThreads / 32);
    constexpr int kCols = (kPitch + 31) / 32;
    static_assert(kRows * (kThreads / 32) == kTileH + 2 * kHalo, "rows divide among warps");
    float v[kRows][kCols];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int gy = by0 - kHalo + warp + k * (kThreads / 32);
      const bool row_in = (unsigned)gy < (unsigned)H;
      const float* src = img + frame + (long long)gy * W + (bx0 - kHalo + lane);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int x = lane + 32 * c;
        const bool in = row_in && x < kPitch && (unsigned)(bx0 - kHalo + x) < (unsigned)W;
        v[k][c] = in ? __ldg(src + 32 * c) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < kPitch)
          tile[(warp + k * (kThreads / 32)) * kPitch + lane + 32 * c] = v[k][c];
  }
  __syncthreads();

  // the tile's address of region pixel (ry, rx), and of region index i
  auto at = [&](int ry, int rx) {
    return tile + (ry - kRing + kHalo) * kPitch + (rx - kRing + kHalo);
  };
  auto at_index = [&](int i) { return at(i / kRW, i % kRW); };
  float ceil_b = 0.0f;
  if (!kMaxPass) ceil_b = __ldg(ceiling + blockIdx.z);
  auto blended = [&](const float* p) {
    const float2 v = fast_scores<true>(p, thr_hi, thr_lo);
    return v.y > 0.0f ? 1.0f + v.y : v.x * ceil_b;
  };
  float m = 0.0f;  // the max pass: this thread's maximum

  // each warp queues the pixels of its columns that pass the compass test
  int n_queued = 0;
  if (warp * 32 < kSegs * kRW) {
    const int rx = tid % kRW;
    const int ry0 = tid / kRW * kSegRows;
    // pixels 3 inside the image, as one unsigned compare per axis
    const unsigned h_in = H > 6 ? H - 6 : 0, w_in = W > 6 ? W - 6 : 0;
    const bool col_live = tid < kSegs * kRW && (unsigned)(bx0 - kRing + rx - 3) < w_in;
    const float* p = at(ry0, rx);
#pragma unroll
    for (int j = 0; j < kSegRows; ++j) {
      const int ry = ry0 + j;
      if (!kMaxPass && tid < kSegs * kRW && ry < kRH) score[ry * kRW + rx] = 0.0f;
      const bool pass = col_live && ry < kRH && (unsigned)(by0 - kRing + ry - 3) < h_in
                        && compass_test(p + j * kPitch, thr_lo);
      const unsigned passed = __ballot_sync(kFull, pass);
      if (pass)
        queue[warp][n_queued + __popc(passed & ((1u << lane) - 1u))] =
            (unsigned short)(ry * kRW + rx);
      n_queued += __popc(passed);
    }
  }
  __syncwarp();
  for (int q = lane; q < n_queued; q += 32) {
    const int i = queue[warp][q];
    if (kMaxPass) m = fmaxf(m, fast_scores<false>(at_index(i), thr_hi, thr_lo).x);
    else score[i] = blended(at_index(i));
  }

  if (kMaxPass) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
      if (m > 0.0f) atomicMax(frame_max_bits + blockIdx.z, __float_as_int(m));
    }
  } else {
    __syncthreads();
    // output pixel (y, x) of the tile is region pixel (y + 1, x + 1)
    const int x = tid % kTileW;
    const int y_first = tid / kTileW * kNmsRows;
    const float* col = score + y_first * kRW + x;
    auto row_max = [&](int r, float& mid) {
      mid = col[r * kRW + 1];
      return fmaxf(fmaxf(col[r * kRW], mid), col[r * kRW + 2]);
    };
    float c, c_next;
    float above = row_max(0, c);
    float here = row_max(1, c);
    const int gx = bx0 + x;
#pragma unroll
    for (int j = 0; j < kNmsRows; ++j) {
      const float below = row_max(j + 2, c_next);
      const int gy = by0 + y_first + j;
      if (gy < H && gx < W)
        out[frame + (size_t)gy * W + gx] = fmaxf(fmaxf(above, here), below) > c ? 0.0f : c;
      above = here;
      here = below;
      c = c_next;
    }
  }
}

}  // namespace

// img, out: (B, H, W), ceiling: (B,), contiguous float32 on the device.
// Launches on `stream` and returns cudaGetLastError(); cudaErrorInvalidValue
// for thr_hi < thr_lo, which the early exits do not cover.
extern "C" int lpslam_fast_nms_score(const float* img, const float* ceiling, float* out,
                                     int B, int H, int W, float thr_hi, float thr_lo,
                                     void* stream) {
  if (!(thr_hi >= thr_lo)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && H > 0 && W > 0) {
    dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    fast_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, ceiling, out, nullptr, H, W, thr_hi, thr_lo);
  }
  return static_cast<int>(cudaGetLastError());
}

// img: (B, H, W), frame_max: (B,) float32 zeros on the device; after the
// launch frame_max[b] = max over frame b of the thr_lo FAST score.
extern "C" int lpslam_fast_lo_max(const float* img, float* frame_max, int B, int H, int W,
                                  float thr_lo, void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    fast_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, nullptr, nullptr, reinterpret_cast<int*>(frame_max), H, W, thr_lo, thr_lo);
  }
  return static_cast<int>(cudaGetLastError());
}
