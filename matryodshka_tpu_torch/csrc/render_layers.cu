// MSI render of one ERP view from a prepared layer stack, the whole frame.
//
// Replaces three kernels of matryodshka_tpu/ops/pallas_render.py that
// compute one function:
//   K4 _render_kernel_tiled  back to front, 128-column tiles
//                            (render_mid_prepared_cf, the schemes other
//                            than blend_psv);
//   K5 _render_kernel        back to front, full-width blocks, and the
//                            row-chunked high-res render
//                            (_ladder_render_chunk / render_mid_chunked);
//   K6 _render_kernel_ftb    front to back with early ray termination
//                            (render_mid_prepared_cf(ftb=True)).
// K4 and K5 differ only in how they tile VMEM; a gather kernel has no VMEM
// bound, so both are the FTB=false mode here, at any resolution. The pole
// caps the TPU path renders with XLA gathers, and the gather fallback for
// poses outside the ladder's bounds, are covered too: one launch renders
// every row for any pose.
//
// Per target pixel (i, j) and shell p: read (u, v) = (U[p, i, j],
// V[p, i, j]), bilinear-sample the shell's four planes at the four taps
// (wrapping mod W and mod H), and over-composite, shell 0's alpha taken
// as 1, in f32:
//   FTB=false: p = 0 .. P-1,       out = rgb*a + out*(1 - a);
//   FTB=true:  p = P-1 .. 0,       out += T*a*rgb, T *= 1 - a, and the
//              ray stops once T < eps (1e-6, K6's FTB_EPS): every farther
//              shell could change the output by at most T, as |rgb| <= 1.
// DEPTH=true renders the depth proxy: rgb is the constant p/P (so shell 0
// contributes 0) and only the alpha plane is read; the value goes to all
// three output channels.
//
// Bound: memory and latency of the gathers (per pixel and shell: two table
// reads and four taps of 4 layer values, 1 in depth mode). Design, as in
// render.cu: one thread per target pixel, consecutive threads on
// consecutive j so the u/v reads coalesce and the taps of a warp fall in
// a few source rows that L1/L2 serve; the composite state stays in
// registers. Plane offsets are 64-bit: at 4096x2048x32 the stack holds
// 2^30 values.
//
// Inputs: layers [B, P, 4, H, W] (bf16 or f32; channels r, g, b, alpha),
// U, V [B, P, H, W] f32; output [B, H, W, 3] f32.

#include "common.cuh"

namespace {

template <typename TL, bool FTB, bool DEPTH>
__global__ void render_layers_kernel(const TL* __restrict__ layers,
                                     const float* __restrict__ U,
                                     const float* __restrict__ V,
                                     float* __restrict__ out, int B, int P,
                                     int H, int W, float eps) {
  const long long hw = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * hw) return;
  const long long b = idx / hw;
  const long long pix = idx - b * hw;
  const TL* lb = layers + b * P * 4 * hw;
  const float* ub = U + b * P * hw + pix;
  const float* vb = V + b * P * hw + pix;
  const float inv_p = 1.f / (float)P;

  float r = 0.f, g = 0.f, bl = 0.f, T = 1.f;
  for (int s = 0; s < P; ++s) {
    const int p = FTB ? P - 1 - s : s;
    const float u = ub[p * hw], v = vb[p * hw];
    const float x0f = floorf(u), y0f = floorf(v);
    const float fx = u - x0f, fy = v - y0f;
    const int x0 = matry::wrap((int)x0f, W), y0 = matry::wrap((int)y0f, H);
    const int x1 = x0 + 1 == W ? 0 : x0 + 1;
    const int y1 = y0 + 1 == H ? 0 : y0 + 1;
    const float wt[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                         fy * (1.f - fx), fy * fx};
    const int off[4] = {y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1};
    const TL* lp = lb + (long long)p * 4 * hw;
    float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = off[t];
      if (!DEPTH) {
        sr += wt[t] * matry::to_f32(lp[o]);
        sg += wt[t] * matry::to_f32(lp[hw + o]);
        sb += wt[t] * matry::to_f32(lp[2 * hw + o]);
      }
      if (p > 0) sa += wt[t] * matry::to_f32(lp[3 * hw + o]);
    }
    if (DEPTH) sr = sg = sb = (float)p * inv_p;
    if (p == 0) sa = 1.f;
    if (FTB) {
      const float ta = T * sa;
      r += ta * sr;
      g += ta * sg;
      bl += ta * sb;
      T *= 1.f - sa;
      if (T < eps) break;
    } else {
      r = sr * sa + r * (1.f - sa);
      g = sg * sa + g * (1.f - sa);
      bl = sb * sa + bl * (1.f - sa);
    }
  }
  float* o = out + idx * 3;
  o[0] = r;
  o[1] = g;
  o[2] = bl;
}

template <typename TL, bool FTB>
void launch(const void* layers, const void* U, const void* V, void* out,
            int B, int P, int H, int W, int depth, float eps,
            cudaStream_t s) {
  const long long total = (long long)B * H * W;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (depth)
    render_layers_kernel<TL, FTB, true><<<blocks, threads, 0, s>>>(
        (const TL*)layers, (const float*)U, (const float*)V, (float*)out, B,
        P, H, W, eps);
  else
    render_layers_kernel<TL, FTB, false><<<blocks, threads, 0, s>>>(
        (const TL*)layers, (const float*)U, (const float*)V, (float*)out, B,
        P, H, W, eps);
}

}  // namespace

extern "C" int matry_render_layers(const void* layers, const void* U,
                                   const void* V, void* out, int B, int P,
                                   int H, int W, int layers_bf16, int ftb,
                                   int depth, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layers_bf16) {
    if (ftb)
      launch<__nv_bfloat16, true>(layers, U, V, out, B, P, H, W, depth, eps,
                                  s);
    else
      launch<__nv_bfloat16, false>(layers, U, V, out, B, P, H, W, depth,
                                   eps, s);
  } else {
    if (ftb)
      launch<float, true>(layers, U, V, out, B, P, H, W, depth, eps, s);
    else
      launch<float, false>(layers, U, V, out, B, P, H, W, depth, eps, s);
  }
  return (int)cudaGetLastError();
}
