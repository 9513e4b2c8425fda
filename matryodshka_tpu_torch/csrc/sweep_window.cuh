// The staged source windows of the identity-pose ODS sweep, shared by its
// two kernels: the volume mode (sweep.cu, K1: the net input) and the
// assembled mode (sweep_assembled.cu: the high-res layer stack).
//
// With an identity sweep pose a (plane, row) item reads two source rows
// and a unit-slope ramp of columns (sweep.cu's note). A window is a
// circular range of at most a few source rows and a bounded span of
// columns that holds the taps of consecutive items; every thread of a
// block computes the same windows from the shared row parameters
// (grow), and each window is staged once in shared memory, preprocessed
// (2x - 1) and split into planar channels, rows padded by one word per
// `cols` words (pos(x) = x + x / cols), so that lanes `cols` columns apart
// read different banks (stage_window).
#pragma once

#include "project.cuh"

namespace matry {

// The sweep's operands: ref and src images [B, H, W, 3] f32 in [0, 1],
// depths [P], intrinsics [B, 3, 3] (r = [b, 0, 0]), lat [H] and lon [W]
// (grids.lat_long_grid's vectors).
struct SweepArgs {
  const float* ref;
  const float* src;
  const float* depths;
  const float* intr;
  const float* lat;
  const float* lon;
  int B, P, H, W;
};

// Grows the circular window [start, start + len) of a ring of n to hold
// the span [s, s + span), within cap; false (window unchanged) if it
// cannot. A cap of n or more holds everything.
__device__ __forceinline__ bool grow(int& start, int& len, int s, int span,
                                     int n, int cap) {
  if (cap >= n) {
    start = 0;
    len = n;
    return true;
  }
  if (len == 0) {
    if (span > cap) return false;
    start = s;
    len = span;
    return true;
  }
  const int fwd = wrap(s - start, n);
  if (fwd + span <= cap) {
    len = max(len, fwd + span);
    return true;
  }
  const int back = wrap(start - s, n);
  const int grown = max(back + len, span);
  if (grown <= cap) {
    start = s;
    len = grown;
    return true;
  }
  return false;
}

// Stages the window (rows ys .. ys+yn-1, columns cs .. cs+cn-1, both
// wrapping) of one image [H, W, 3] into stage [yn][3][stride], each value
// preprocessed (2x - 1), by the block's THREADS threads.
template <int COLS, int THREADS>
__device__ __forceinline__ void stage_window(const float* __restrict__ img,
                                             float* __restrict__ stage,
                                             int ys, int yn, int cs, int cn,
                                             int stride, int H, int W) {
  for (int idx = threadIdx.x; idx < yn * cn; idx += THREADS) {
    const int sr = idx / cn, cc = idx - sr * cn;
    const int y = ys + sr >= H ? ys + sr - H : ys + sr;
    const int x = cs + cc >= W ? cs + cc - W : cs + cc;
    const float* px = img + ((long long)y * W + x) * 3;
    float* dst = stage + sr * 3 * stride + cc + cc / COLS;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dst[c * stride] = fsub(fmul(px[c], 2.f), 1.f);
  }
}

}  // namespace matry
