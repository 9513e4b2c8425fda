// Blend-fused front-to-back MSI render of one ERP view, the whole frame,
// lookup coordinates included.
//
// Replaces matryodshka_tpu/ops/pallas_render.py:_render_kernel_ftbb (K3)
// together with the XLA pieces beside it on the TPU path: the per-shell uv
// fields (intersect.intersect_sphere_uv, geometry/render.py:341), the
// pole-cap gathers and cap assembly (geometry/render.py:_cap_over_band_uv,
// models/msi.py:assemble_caps_blend_psv) and the gather fallback for poses
// outside the ladder's bounds. A gather kernel has no residual bound, so
// one kernel covers every row and every pose, and one launch renders a
// batch.
//
// Per target pixel (i, j): its ray, rotated by the target pose, and the
// target centre are formed once (project.cuh:target_ray). For shells
// p = P-1 (nearest) down to 0 (farthest): intersect the ray with the
// shell and take its ERP pixel (u, v) (project.cuh:shell_uv); at each of
// the four bilinear taps (wrapping mod W and mod H) blend the source pixel,
//   w = (pred[p] + 1)/2,  rgb = w*fg + (1 - w)*bg,  a = (pred[P + p] + 1)/2,
// -- the blend happens at source pixels, as the reference assembles the
// layers before it samples them -- then bilinear-weight the four RGBA
// values and composite over, shell 0's alpha taken as 1, in f32. A ray
// stops once its transmittance T < eps (1e-6, K3's FTB_EPS): every farther
// shell could change the output by at most T, as |rgb| <= 1.
//
// DEPTH=true is K3's depth mode (render_mid_fused_blend(depth=True)): the
// colour is the constant p/P (shell 0 contributes 0), so only the alpha
// prediction is read; the value goes to all three output channels.
//
// Bound: memory -- per visited (pixel, shell) about one source pixel of
// taps (6 volume and 2 prediction values, 20 B), and 12 B out per pixel --
// with the projection's arithmetic (two atan2f, two sqrtf and ~20 other
// operations per visited sample) below it. Design: a block is a
// 32 x 4 pixel tile (tools/variants.py times 32 x 8), a warp one row of
// 32 pixels, so one shell's taps of a warp fall in about two source rows
// and a tile's in a compact window that L1 serves; the ray, the composite
// state and T stay in registers; no table is read.
//
// Inputs: vol [B, 2*P*3, H, W] (ops/sweep.py output: the ref eye's planes
// are fg, the src eye's bg), pred [B, 2P, H, W] f32 (the net head), pose
// [B, 4, 4] f32 (batch stride pose_stride floats, 0 for one pose shared),
// pos [B, 3] f32, radii [P] f32, lat [H] and lon [W] (lat_long_grid's
// vectors); output [B, H, W, 3] f32.
//
// matry_uv_project is an instrument: it writes the same per-shell (u, v)
// into [B, P, H, W] tables, so that the projection and the render can be
// checked apart.

#include "project.cuh"

namespace {

constexpr int TILE_X = 32, TILE_Y = 4;

template <typename TV, bool DEPTH>
__global__ void __launch_bounds__(TILE_X* TILE_Y)
    render_kernel(const TV* __restrict__ vol, const float* __restrict__ pred,
                  matry::Geo g, float* __restrict__ out, float eps) {
  const int j = blockIdx.x * TILE_X + threadIdx.x;
  const int i = blockIdx.y * TILE_Y + threadIdx.y;
  const int b = blockIdx.z;
  const int P = g.P, H = g.H, W = g.W;
  if (i >= H || j >= W) return;
  const long long hw = (long long)H * W;
  const matry::PixelAffine m = matry::pixel_affine(W, H);
  const matry::Ray q = matry::target_ray(g.pose + b * g.pose_stride,
                                         g.pos + b * g.pos_stride, g.lat[i],
                                         g.lon[j]);

  const TV* fg = vol + (long long)b * 2 * P * 3 * hw;
  const TV* bg = fg + (long long)P * 3 * hw;
  const float* pr = pred + (long long)b * 2 * P * hw;
  const float inv_p = 1.f / (float)P;
  const int hwi = (int)hw;               // in-plane offsets are 32-bit

  float r = 0.f, gr = 0.f, bl = 0.f, T = 1.f;
  for (int p = P - 1; p >= 0; --p) {
    float u, v;
    matry::shell_uv(q, g.radii[p], m, u, v);
    const float x0f = floorf(u), y0f = floorf(v);
    const float fx = u - x0f, fy = v - y0f;
    // u lies in [-0.5, W - 0.5] and v in [-0.5, H - 0.5] (the angles'
    // ranges), so one step wraps the taps
    int x0 = (int)x0f, y0 = (int)y0f;
    x0 += x0 < 0 ? W : 0;
    x0 -= x0 >= W ? W : 0;
    y0 += y0 < 0 ? H : 0;
    y0 -= y0 >= H ? H : 0;
    const int x1 = x0 + 1 == W ? 0 : x0 + 1;
    const int y1 = y0 + 1 == H ? 0 : y0 + 1;
    const float wt[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                         fy * (1.f - fx), fy * fx};
    const int off[4] = {y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1};
    const TV* fgr = fg + (long long)p * 3 * hw;
    const TV* bgr = bg + (long long)p * 3 * hw;
    const TV *fgg = fgr + hwi, *fgb = fgg + hwi;
    const TV *bgg = bgr + hwi, *bgb = bgg + hwi;
    const float* bw = pr + (long long)p * hw;
    const float* aw = pr + (long long)(P + p) * hw;
    float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = off[t];
      sa += wt[t] * ((aw[o] + 1.f) * 0.5f);
      if (DEPTH) continue;
      // w fg + (1 - w) bg, as bg + w (fg - bg)
      const float w = (bw[o] + 1.f) * 0.5f;
      const float br = matry::to_f32(bgr[o]), bgv = matry::to_f32(bgg[o]);
      const float bb = matry::to_f32(bgb[o]);
      sr += wt[t] * fmaf(w, matry::to_f32(fgr[o]) - br, br);
      sg += wt[t] * fmaf(w, matry::to_f32(fgg[o]) - bgv, bgv);
      sb += wt[t] * fmaf(w, matry::to_f32(fgb[o]) - bb, bb);
    }
    if (DEPTH) sr = sg = sb = (float)p * inv_p;
    if (p > 0) {
      const float ta = T * sa;
      r += ta * sr;
      gr += ta * sg;
      bl += ta * sb;
      T *= 1.f - sa;
      if (T < eps) break;
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

__global__ void __launch_bounds__(TILE_X* TILE_Y)
    uv_project_kernel(matry::Geo g, float* __restrict__ U,
                      float* __restrict__ V) {
  const int j = blockIdx.x * TILE_X + threadIdx.x;
  const int i = blockIdx.y * TILE_Y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= g.H || j >= g.W) return;
  const long long hw = (long long)g.H * g.W;
  const matry::PixelAffine m = matry::pixel_affine(g.W, g.H);
  const matry::Ray q = matry::target_ray(g.pose + b * g.pose_stride,
                                         g.pos + b * g.pos_stride, g.lat[i],
                                         g.lon[j]);
  const long long base = (long long)b * g.P * hw + (long long)i * g.W + j;
  for (int p = 0; p < g.P; ++p) {
    float u, v;
    matry::shell_uv(q, g.radii[p], m, u, v);
    U[base + p * hw] = u;
    V[base + p * hw] = v;
  }
}

dim3 tiles(const matry::Geo& g) {
  return dim3((unsigned)((g.W + TILE_X - 1) / TILE_X),
              (unsigned)((g.H + TILE_Y - 1) / TILE_Y), (unsigned)g.B);
}

template <typename TV>
void launch(const void* vol, const void* pred, const matry::Geo& g,
            void* out, int depth, float eps, cudaStream_t s) {
  const dim3 block(TILE_X, TILE_Y);
  if (depth)
    render_kernel<TV, true><<<tiles(g), block, 0, s>>>(
        (const TV*)vol, (const float*)pred, g, (float*)out, eps);
  else
    render_kernel<TV, false><<<tiles(g), block, 0, s>>>(
        (const TV*)vol, (const float*)pred, g, (float*)out, eps);
}

}  // namespace

extern "C" int matry_render(const void* vol, const void* pred,
                            const void* pose, long long pose_stride,
                            const void* pos, long long pos_stride,
                            const void* radii, const void* lat,
                            const void* lon, void* out, int B, int P, int H,
                            int W, int vol_bf16, int depth, float eps,
                            void* stream) {
  const matry::Geo g = matry::make_geo(pose, pose_stride, pos, pos_stride,
                                       radii, lat, lon, B, P, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  if (vol_bf16)
    launch<__nv_bfloat16>(vol, pred, g, out, depth, eps, s);
  else
    launch<float>(vol, pred, g, out, depth, eps, s);
  return (int)cudaGetLastError();
}

extern "C" int matry_uv_project(const void* pose, long long pose_stride,
                                const void* pos, long long pos_stride,
                                const void* radii, const void* lat,
                                const void* lon, void* U, void* V, int B,
                                int P, int H, int W, void* stream) {
  const matry::Geo g = matry::make_geo(pose, pose_stride, pos, pos_stride,
                                       radii, lat, lon, B, P, H, W);
  uv_project_kernel<<<tiles(g), dim3(TILE_X, TILE_Y), 0,
                      (cudaStream_t)stream>>>(g, (float*)U, (float*)V);
  return (int)cudaGetLastError();
}
