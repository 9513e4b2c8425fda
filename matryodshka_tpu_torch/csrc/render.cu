// Blend-fused front-to-back MSI render of one ERP view, the whole frame.
//
// Replaces matryodshka_tpu/ops/pallas_render.py:_render_kernel_ftbb (K3)
// together with the XLA pieces beside it on the TPU path: the pole-cap
// gathers and cap assembly (geometry/render.py:_cap_over_band_uv,
// models/msi.py:assemble_caps_blend_psv) and the gather fallback for poses
// outside the ladder's bounds. A gather kernel has no residual bound, so
// one kernel covers every row and every pose.
//
// Per target pixel (i, j), shells p = P-1 (nearest) down to 0 (farthest):
// read (u, v) = (U[p, i, j], V[p, i, j]); at each of the four bilinear
// taps (wrapping mod W and mod H) blend the source pixel,
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
// Bound: memory and latency of the gathers (per pixel and shell: two table
// reads, four taps of 3 volume + 2 prediction values; 1 in depth mode).
// Design: one thread per target pixel, consecutive threads on consecutive
// j so the u/v reads coalesce and the taps of a warp fall in a few source
// rows that L1/L2 serve; the composite state stays in registers.
//
// Inputs: vol [B, 2*P*3, H, W] (ops/sweep.py output: the ref eye's planes
// are fg, the src eye's bg), pred [B, 2P, H, W] f32 (the net head),
// U, V [B, P, H, W] f32; output [B, H, W, 3] f32.

#include "common.cuh"

namespace {

template <typename TV, bool DEPTH>
__global__ void render_kernel(const TV* __restrict__ vol,
                              const float* __restrict__ pred,
                              const float* __restrict__ U,
                              const float* __restrict__ V,
                              float* __restrict__ out, int B, int P, int H,
                              int W, float eps) {
  const long long hw = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * hw) return;
  const long long b = idx / hw;
  const long long pix = idx - b * hw;

  const TV* fg = vol + b * 2 * P * 3 * hw;
  const TV* bg = fg + (long long)P * 3 * hw;
  const float* pr = pred + b * 2 * P * hw;
  const float* ub = U + b * P * hw + pix;
  const float* vb = V + b * P * hw + pix;
  const float inv_p = 1.f / (float)P;

  float r = 0.f, g = 0.f, bl = 0.f, T = 1.f;
  for (int p = P - 1; p >= 0; --p) {
    const float u = ub[p * hw], v = vb[p * hw];
    const float x0f = floorf(u), y0f = floorf(v);
    const float fx = u - x0f, fy = v - y0f;
    const int x0 = matry::wrap((int)x0f, W), y0 = matry::wrap((int)y0f, H);
    const int x1 = x0 + 1 == W ? 0 : x0 + 1;
    const int y1 = y0 + 1 == H ? 0 : y0 + 1;
    const float wt[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                         fy * (1.f - fx), fy * fx};
    const int off[4] = {y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1};
    const TV* fgp = fg + (long long)p * 3 * hw;
    const TV* bgp = bg + (long long)p * 3 * hw;
    const float* bw = pr + (long long)p * hw;
    const float* aw = pr + (long long)(P + p) * hw;
    float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = off[t];
      sa += wt[t] * ((aw[o] + 1.f) * 0.5f);
      if (DEPTH) continue;
      const float w = (bw[o] + 1.f) * 0.5f;
      const float cr = w * matry::to_f32(fgp[o]) +
                       (1.f - w) * matry::to_f32(bgp[o]);
      const float cg = w * matry::to_f32(fgp[hw + o]) +
                       (1.f - w) * matry::to_f32(bgp[hw + o]);
      const float cb = w * matry::to_f32(fgp[2 * hw + o]) +
                       (1.f - w) * matry::to_f32(bgp[2 * hw + o]);
      sr += wt[t] * cr;
      sg += wt[t] * cg;
      sb += wt[t] * cb;
    }
    if (DEPTH) sr = sg = sb = (float)p * inv_p;
    if (p > 0) {
      const float ta = T * sa;
      r += ta * sr;
      g += ta * sg;
      bl += ta * sb;
      T *= 1.f - sa;
      if (T < eps) break;
    } else {
      r += T * sr;
      g += T * sg;
      bl += T * sb;
    }
  }
  float* o = out + idx * 3;
  o[0] = r;
  o[1] = g;
  o[2] = bl;
}

template <typename TV>
void launch(const void* vol, const void* pred, const void* U, const void* V,
            void* out, int B, int P, int H, int W, int depth, float eps,
            cudaStream_t s) {
  const long long total = (long long)B * H * W;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (depth)
    render_kernel<TV, true><<<blocks, threads, 0, s>>>(
        (const TV*)vol, (const float*)pred, (const float*)U, (const float*)V,
        (float*)out, B, P, H, W, eps);
  else
    render_kernel<TV, false><<<blocks, threads, 0, s>>>(
        (const TV*)vol, (const float*)pred, (const float*)U, (const float*)V,
        (float*)out, B, P, H, W, eps);
}

}  // namespace

extern "C" int matry_render(const void* vol, const void* pred, const void* U,
                            const void* V, void* out, int B, int P, int H,
                            int W, int vol_bf16, int depth, float eps,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vol_bf16)
    launch<__nv_bfloat16>(vol, pred, U, V, out, B, P, H, W, depth, eps, s);
  else
    launch<float>(vol, pred, U, V, out, B, P, H, W, depth, eps, s);
  return (int)cudaGetLastError();
}
