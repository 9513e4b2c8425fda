// Blend-fused MPI render of one perspective view: each plane warped by its
// homography, blended at the taps and composited in registers.
//
// Replaces no TPU kernel. The JAX package renders an MPI with XLA gathers
// (matryodshka_tpu/geometry/homography.py:mpi_render_view after
// models/msi.py:assemble_rgba); the port's plain route does the same in
// PyTorch: a blended layer stack [B, H, W, P, 4], a float32 copy of it,
// int64 index and weight tensors over [B, P, H, W] for four taps, four
// gathers and the over-composite -- a dozen passes over device memory a
// sample. This kernel computes assemble_rgba("blend_psv") followed by
// mpi_render_view in one launch, in float32, and writes only the view.
//
// Each block computes its element's P homographies from target to source
// pixels into shared memory: inv_homography's with n = (0, 0, 1) and
// a = -depth[p],
//   H = K (R^T + (R^T t)(n R^T) / (a - n R^T t)) K^-1,
// R, t the target pose's rotation and translation, K the intrinsics, K^-1
// the wrapper's (torch.linalg.inv_ex on the device: nothing is read back
// to the host), a zero denominator taken as 1e-8 (_divide_safe). Every
// step is an f32 operation rounded once (__fmul_rn, __fadd_rn, ...), in
// the order of geometry/homography.py:mpi_homographies, which the plain
// route runs as elementwise tensor operations, so the kernel and the
// plain route warp by the same matrices bit for bit.
//
// Per target pixel (i, j), for planes p = P-1 (nearest) down to 0:
// (x, y, w) = H_bp (j, i, 1), a zero w divided as 1e-8; the four bilinear
// taps, each counting only inside [0, W-1] x [0, H-1] (zeros outside, as
// tf.contrib.resampler). Whether a tap is inside is decided on the float
// coordinate before any conversion to int, so a plane seen edge-on, whose
// coordinates exceed any integer, gives zeros. At each tap the source
// pixel is blended as the reference assembles it,
//   w = (pred[p] + 1)/2,  rgb = bg + w (fg - bg),  a = (pred[P + p] + 1)/2,
// then the four RGBA values are bilinear-weighted and composited over,
// plane 0's alpha taken as 1. No early exit: every (pixel, plane) sample
// is taken, as the plain route takes them.
//
// Bound: memory. The work reads the volume's fg and bg channels and the
// prediction's two channels once (6 P bf16 + 2 P f32 values a pixel) and
// writes 12 B a pixel; the arithmetic (~72 f32 operations a sample) is an
// order below it. Design: a block is a 32 x 4 pixel tile, a warp one row
// of 32 target pixels, so for the near-identity homographies of a moving
// viewer one plane's taps of a warp fall in about two source rows and a
// tile's in a compact window that L1 serves; the homographies sit in
// shared memory, the composite in registers; the layer stack is never
// written.
//
// Inputs: vol [B, C, H, W] (C >= 6P; fg is channel 3p + c, bg channel
// 3P + 3p + c, the slices assemble_rgba takes, so the 195-channel
// REALESTATE_PP volume is read as it is), pred [B, 2P, H, W] f32 (blend
// weights, then alphas), pose [B, 4, 4] f32 row-major (batch stride
// pose_stride floats), intrinsics and their inverse [B, 3, 3] f32
// row-major, depths [P] f32; output [B, H, W, 3] f32.

#include "common.cuh"

namespace {

constexpr int TILE_X = 32, TILE_Y = 4;

// Entry (r, c) of the homography of the plane at depth, in the steps of
// mpi_homographies: m[j][q] = R[q][j] + (R^T t)[j] R[q][2] / den,
// km[r][q] = (K[r][0] m[0][q] + K[r][1] m[1][q]) + K[r][2] m[2][q], and
// H[r][c] = (km[r][0] Ki[0][c] + km[r][1] Ki[1][c]) + km[r][2] Ki[2][c].
// pose is row-major [4, 4] (R = pose[:3, :3], t = pose[:3, 3]), k and
// kinv row-major [3, 3]. One entry a thread keeps few values live.
__device__ float homography_entry(const float* __restrict__ pose,
                                  const float* __restrict__ k,
                                  const float* __restrict__ kinv,
                                  float depth, int r, int c) {
  float rtt[3];  // R^T t
  for (int j = 0; j < 3; ++j)
    rtt[j] = __fadd_rn(__fadd_rn(__fmul_rn(pose[j], pose[3]),
                                 __fmul_rn(pose[4 + j], pose[7])),
                       __fmul_rn(pose[8 + j], pose[11]));
  float den = __fsub_rn(-depth, rtt[2]);
  if (den == 0.f) den = 1e-8f;
  float h = 0.f;
  for (int q = 0; q < 3; ++q) {
    float km = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float m = __fadd_rn(
          pose[q * 4 + j],
          __fdiv_rn(__fmul_rn(rtt[j], pose[q * 4 + 2]), den));
      const float term = __fmul_rn(k[r * 3 + j], m);
      km = j == 0 ? term : __fadd_rn(km, term);
    }
    const float term = __fmul_rn(km, kinv[q * 3 + c]);
    h = q == 0 ? term : __fadd_rn(h, term);
  }
  return h;
}

template <typename TV>
__global__ void __launch_bounds__(TILE_X* TILE_Y)
    mpi_render_kernel(const TV* __restrict__ vol, int C,
                      const float* __restrict__ pred,
                      const float* __restrict__ pose, long long pose_stride,
                      const float* __restrict__ intr,
                      const float* __restrict__ intr_inv,
                      const float* __restrict__ depths,
                      float* __restrict__ out, int P, int H, int W) {
  extern __shared__ float hom[];  // [P][9]
  const int b = blockIdx.z;
  for (int e = threadIdx.y * TILE_X + threadIdx.x; e < 9 * P;
       e += TILE_X * TILE_Y)
    hom[e] = homography_entry(pose + b * pose_stride, intr + 9 * b,
                              intr_inv + 9 * b, depths[e / 9], e % 9 / 3,
                              e % 3);
  __syncthreads();

  const int j = blockIdx.x * TILE_X + threadIdx.x;
  const int i = blockIdx.y * TILE_Y + threadIdx.y;
  if (i >= H || j >= W) return;
  const long long hw = (long long)H * W;
  const int hwi = (int)hw;  // in-plane offsets are 32-bit
  const TV* fg = vol + (long long)b * C * hw;
  const TV* bg = fg + (long long)P * 3 * hw;
  const float* pr = pred + (long long)b * 2 * P * hw;
  const float xj = (float)j, yi = (float)i;
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);

  float r = 0.f, gr = 0.f, bl = 0.f, T = 1.f;
  for (int p = P - 1; p >= 0; --p) {
    const float* h = hom + 9 * p;
    const float xw = fmaf(h[1], yi, h[0] * xj) + h[2];
    const float yw = fmaf(h[4], yi, h[3] * xj) + h[5];
    float ww = fmaf(h[7], yi, h[6] * xj) + h[8];
    if (ww == 0.f) ww = 1e-8f;
    const float u = xw / ww, v = yw / ww;
    const float x0f = floorf(u), y0f = floorf(v);
    const float fx = u - x0f, fy = v - y0f;
    // taps x0 and x0 + 1 (y0, y0 + 1) inside, decided in float
    const bool vx0 = x0f >= 0.f && x0f <= xmax;
    const bool vx1 = x0f >= -1.f && x0f <= xmax - 1.f;
    const bool vy0 = y0f >= 0.f && y0f <= ymax;
    const bool vy1 = y0f >= -1.f && y0f <= ymax - 1.f;
    const int x0 = (vx0 || vx1) ? (int)x0f : 0;
    const int y0 = (vy0 || vy1) ? (int)y0f : 0;
    const bool in[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
    const float wt[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                         fy * (1.f - fx), fy * fx};
    const int off[4] = {y0 * W + x0, y0 * W + x0 + 1, (y0 + 1) * W + x0,
                        (y0 + 1) * W + x0 + 1};
    const TV* fgr = fg + (long long)p * 3 * hw;
    const TV* bgr = bg + (long long)p * 3 * hw;
    const TV *fgg = fgr + hwi, *fgb = fgg + hwi;
    const TV *bgg = bgr + hwi, *bgb = bgg + hwi;
    const float* bw = pr + (long long)p * hw;
    const float* aw = pr + (long long)(P + p) * hw;
    float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!in[t]) continue;
      const int o = off[t];
      sa += wt[t] * ((aw[o] + 1.f) * 0.5f);
      // w fg + (1 - w) bg, as bg + w (fg - bg)
      const float w = (bw[o] + 1.f) * 0.5f;
      const float br = matry::to_f32(bgr[o]), bgv = matry::to_f32(bgg[o]);
      const float bb = matry::to_f32(bgb[o]);
      sr += wt[t] * fmaf(w, matry::to_f32(fgr[o]) - br, br);
      sg += wt[t] * fmaf(w, matry::to_f32(fgg[o]) - bgv, bgv);
      sb += wt[t] * fmaf(w, matry::to_f32(fgb[o]) - bb, bb);
    }
    if (p > 0) {
      const float ta = T * sa;
      r += ta * sr;
      gr += ta * sg;
      bl += ta * sb;
      T *= 1.f - sa;
    } else {
      r += T * sr;
      gr += T * sg;
      bl += T * sb;
    }
  }
  float* o = out + ((long long)b * hw + (long long)i * W + j) * 3;
  o[0] = r;
  o[1] = gr;
  o[2] = bl;
}

}  // namespace

extern "C" int matry_mpi_render(const void* vol, const void* pred,
                                const void* pose, long long pose_stride,
                                const void* intr, const void* intr_inv,
                                const void* depths, void* out, int B, int C,
                                int P, int H, int W, int vol_bf16,
                                void* stream) {
  const dim3 grid((unsigned)((W + TILE_X - 1) / TILE_X),
                  (unsigned)((H + TILE_Y - 1) / TILE_Y), (unsigned)B);
  const dim3 block(TILE_X, TILE_Y);
  const size_t smem = sizeof(float) * 9 * (size_t)P;
  cudaStream_t s = (cudaStream_t)stream;
  if (vol_bf16)
    mpi_render_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        (const __nv_bfloat16*)vol, C, (const float*)pred,
        (const float*)pose, pose_stride, (const float*)intr,
        (const float*)intr_inv, (const float*)depths, (float*)out, P, H, W);
  else
    mpi_render_kernel<float><<<grid, block, smem, s>>>(
        (const float*)vol, C, (const float*)pred, (const float*)pose,
        pose_stride, (const float*)intr, (const float*)intr_inv,
        (const float*)depths, (float*)out, P, H, W);
  return (int)cudaGetLastError();
}
