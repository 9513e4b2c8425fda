// Dual-eye identity-pose ODS sphere sweep.
//
// Replaces matryodshka_tpu/ops/pallas_sweep.py:_sweep_kernel (K1).
// With an identity sweep pose the ODS lookup field is row-separable: on
// (eye, plane, row) the source row pair y0/y1 and weight fy are constant,
// and the column is u0 - j (a unit-slope ramp that wraps mod W), so the
// horizontal weight fx is one per row too. The per-row parameters come
// from ops/sweep.py:row_params (plain torch, [B, 2, P, H] each).
//
// Bound: memory. The kernel writes the whole net input, 2*P*3*H*W
// elements (79 MB in bf16 at 640x320x32) and reads a 2.4 MB source that
// stays in L2. Design: one thread per output pixel (b, eye, plane, i, j)
// handling all three channels; consecutive threads take consecutive j so
// every store is coalesced, and the row parameters are warp-uniform
// broadcasts. No shared memory: the taps of a warp fall in two source
// rows that L1/L2 serve.
//
// Output layout: [B, 2*P*3, H, W], channel (eye*P + p)*3 + c -- the
// channels-first form of format_network_input's channel order, which the
// net reads as is and the render views as [B, 2, P, 3, H, W]. Rows with
// no tangent ray (valid == 0) take image[eye, :, 1, 1], the reference's
// park at pixel (1, 1).

#include "common.cuh"

namespace {

template <typename TO>
__global__ void sweep_kernel(const float* __restrict__ img,
                             const int* __restrict__ y0,
                             const int* __restrict__ y1,
                             const float* __restrict__ fy,
                             const int* __restrict__ x0,
                             const float* __restrict__ fx,
                             const int* __restrict__ valid,
                             TO* __restrict__ out, int B, int P, int H,
                             int W) {
  const long long total = (long long)B * 2 * P * H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % W);
  long long r = idx / W;
  const int i = (int)(r % H);
  r /= H;                               // r = (b * 2 + eye) * P + p
  const long long be = r / P;           // b * 2 + eye
  const long long row = r * H + i;      // index into the [B, 2, P, H] params
  const long long hw = (long long)H * W;
  const float* im = img + be * 3 * hw;
  TO* o = out + r * 3 * hw + (long long)i * W + j;

  if (!valid[row]) {
    for (int c = 0; c < 3; ++c)
      o[c * hw] = matry::from_f32<TO>(im[c * hw + W + 1]);
    return;
  }
  const int ya = y0[row], yb = y1[row];
  const float wy = fy[row], wx = fx[row];
  int xa = x0[row] - j;
  if (xa < 0) xa += W;
  const int xb = xa + 1 == W ? 0 : xa + 1;
  for (int c = 0; c < 3; ++c) {
    const float* ic = im + c * hw;
    const float va = (1.f - wy) * ic[ya * W + xa] + wy * ic[yb * W + xa];
    const float vb = (1.f - wy) * ic[ya * W + xb] + wy * ic[yb * W + xb];
    o[c * hw] = matry::from_f32<TO>((1.f - wx) * va + wx * vb);
  }
}

}  // namespace

extern "C" int matry_sweep(const void* img, const void* y0, const void* y1,
                           const void* fy, const void* x0, const void* fx,
                           const void* valid, void* out, int B, int P,
                           int H, int W, int out_bf16, void* stream) {
  const long long total = (long long)B * 2 * P * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    sweep_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const float*)img, (const int*)y0, (const int*)y1, (const float*)fy,
        (const int*)x0, (const float*)fx, (const int*)valid,
        (__nv_bfloat16*)out, B, P, H, W);
  else
    sweep_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)img, (const int*)y0, (const int*)y1, (const float*)fy,
        (const int*)x0, (const float*)fx, (const int*)valid, (float*)out, B,
        P, H, W);
  return (int)cudaGetLastError();
}
