// MSI render of one ERP view from a prepared layer stack, the whole frame,
// lookup coordinates included.
//
// Replaces three kernels of matryodshka_tpu/ops/pallas_render.py that
// compute one function:
//   K4 _render_kernel_tiled (:295)  back to front, 128-column tiles
//                                   (render_mid_prepared_cf, the schemes
//                                   other than blend_psv);
//   K5 _render_kernel (:132)        back to front, full-width blocks, and
//                                   the row-chunked high-res render
//                                   (_ladder_render_chunk /
//                                   render_mid_chunked);
//   K6 _render_kernel_ftb (:694)    front to back with early ray
//                                   termination (render_mid_prepared_cf(
//                                   ftb=True)).
// K4 and K5 differ only in how they tile VMEM; a gather kernel has no VMEM
// bound, so both are the FTB=false mode here, at any resolution. With them
// go the per-shell uv fields the TPU path computes in XLA beside the
// kernels, the pole caps it renders with XLA gathers, and the gather
// fallback for poses outside the ladder's bounds: one launch renders every
// row for any pose.
//
// Per target pixel (i, j): its ray, rotated by the target pose, and the
// target centre are formed once (project.cuh:target_ray). Per shell p:
// intersect the ray with the shell and take its ERP pixel (u, v)
// (project.cuh:shell_uv, the bits the uv instrument matry_uv_project
// writes), bilinear-sample the shell's planes at the four taps (wrapping
// mod W and mod H) and over-composite, shell 0's alpha taken as 1, in f32:
//   FTB=false: p = 0 .. P-1,  out = c*a + out*(1 - a);
//   FTB=true:  p = P-1 .. 0,  out += T*a*c, T *= 1 - a, and the ray stops
//              once T < eps (1e-6, K6's FTB_EPS): every farther shell
//              could change the output by at most T, as |c| <= 1.
// The colour c is the shell's rgb; the depth proxy's c is the constant
// p/P (so shell 0 contributes 0), which reads only the alpha plane. RGB
// and DEPTH select the outputs: a launch that writes both composites the
// two with the same alphas in one pass over the shells, so a caller that
// wants image and depth pays the projection, the alpha taps and the loop
// once. The depth value goes to all three channels of its output.
//
// Bound: at 4096x2048x32 in bf16 the stack is 2.15 GB (0.64 ms at
// 3.35 TB/s), read about once (a source texel serves about one sample at
// the stack's own resolution), and no table is read. Per (pixel, shell)
// the projection is ~140 f32 operations (two atan2f, two sqrtf; ~130 SASS
// instructions) and the taps and composites ~45, so operations bound the
// kernel (~0.74 ms at 67 TFLOP/s). Design for this card:
// - the stack is interleaved, [B, P, H, W, 4] with the channels r, g, b,
//   alpha innermost, so a tap is one aligned vector load of its texel:
//   8 bytes in bf16, 16 in f32 (a colour sample makes 4 loads, where the
//   planar stack [B, P, 4, H, W] of the first design made 16 two-byte
//   gathers, each in its own 32-byte sector); the depth-only mode loads
//   the alpha alone;
// - a block is a 32 x 4 pixel tile, a warp one row of 32 pixels, so a
//   shell's taps of a warp fall in about two source rows that L1 serves;
//   the four taps' texel offsets and weights are computed once a shell;
// - two shells a step, sampled before either is composited, so one
//   shell's projection overlaps the other's loads; the ray's
//   shell-independent terms, the composites and T stay in registers.
// tools/variants.py times 32 x 8 and 64 x 2 tiles, one and four shells a
// step, and the taps and composite alone (the projection replaced by a
// fixed lookup). Shell offsets are 64-bit: at 4096x2048x32 the stack
// holds 2^30 values.
//
// Inputs: layers [B, P, H, W, 4] (bf16 or f32; channels r, g, b, alpha),
// pose [B, 4, 4] f32 (batch stride pose_stride floats, 0 for one pose
// shared), pos [B, 3] f32, radii [P] f32, lat [H] and lon [W]
// (lat_long_grid's vectors); outputs rgb and depth [B, H, W, 3] f32, a
// null pointer for an output not wanted.
//
// The partial mode (matry_render_layers_partial; PARTIAL=true, back to
// front, both outputs) renders one contiguous block of shells of a larger
// stack, for the shell-sharded high-res render
// (parallel/sharded_render.py): the stack's P shells are global shells
// p0 .. p0+P-1 of p_total, so the depth value is (p0 + p) / p_total and
// the alpha is taken as 1 only for global shell 0; beside the partial
// colour and depth it writes the block's transmittance T = prod(1 - a)
// [B, H, W]. combine_partials then composites the blocks' partials: the
// over operator's associativity (JAX parallel/sharded_render.py). With
// p0 = 0 and p_total = P the partial colour and depth are the full
// render's, bit for bit.

#include "project.cuh"

namespace {

constexpr int TILE_X = 32, TILE_Y = 4;
constexpr int SHELLS = 2;

// One texel's four channels (r, g, b, alpha) as one aligned vector load:
// 16 bytes of f32, 8 of bf16 (a bf16 value is the top half of its f32).
__device__ __forceinline__ float4 load_texel(const float* __restrict__ shell,
                                             unsigned o) {
  return __ldg(reinterpret_cast<const float4*>(shell) + o);
}
__device__ __forceinline__ float4 load_texel(
    const __nv_bfloat16* __restrict__ shell, unsigned o) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(shell) + o);
  return make_float4(__uint_as_float(t.x << 16),
                     __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16),
                     __uint_as_float(t.y & 0xffff0000u));
}

// One shell's bilinear sample at the pixel's ray: alpha (1 on shell 0)
// and, when RGB, the colour. lp: the shell's first texel. The four taps
// (y0 x0, y0 x1, y1 x0, y1 x1) are one vector load each (the alpha alone
// without RGB) and are weighted in that order.
struct Sample {
  float a, r, g, b;
};

template <typename TL, bool RGB>
__device__ __forceinline__ Sample sample_shell(const TL* __restrict__ lp,
                                               int p,
                                               const matry::Ray& q,
                                               float radius,
                                               const matry::PixelAffine& m,
                                               int W, int H) {
  float u, v;
  matry::shell_uv(q, radius, m, u, v);
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
  const unsigned oy0 = (unsigned)(y0 * W), oy1 = (unsigned)(y1 * W);
  const unsigned o[4] = {oy0 + x0, oy0 + x1, oy1 + x0, oy1 + x1};
  Sample s;
  s.a = s.r = s.g = s.b = 0.f;
  if (RGB) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 t = load_texel(lp, o[k]);
      s.r = fmaf(wt[k], t.x, s.r);
      s.g = fmaf(wt[k], t.y, s.g);
      s.b = fmaf(wt[k], t.z, s.b);
      s.a = fmaf(wt[k], t.w, s.a);
    }
  } else if (p > 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s.a = fmaf(wt[k], matry::to_f32(lp[4 * o[k] + 3]), s.a);
  }
  if (p == 0) s.a = 1.f;
  return s;
}

template <typename TL, bool FTB, bool RGB, bool DEPTH, bool PARTIAL>
__global__ void __launch_bounds__(TILE_X* TILE_Y)
    render_layers_kernel(const TL* __restrict__ layers, matry::Geo g,
                         float* __restrict__ rgb_out,
                         float* __restrict__ depth_out, float eps, int p0,
                         int p_total, float* __restrict__ t_out) {
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
  const TL* lb = layers + (long long)b * P * hw * 4;
  const float inv_p = 1.f / (float)p_total;

  // SHELLS shells a step: their samples are taken before any of them is
  // composited, so their projections and tap loads overlap (the front-to-
  // back stop is still tested after each shell). The composites' FMAs are
  // explicit, so every mode and variant rounds the same way.
  float r = 0.f, gr = 0.f, bl = 0.f, d = 0.f, T = 1.f;
  bool done = false;
  for (int s0 = 0; s0 < P && !done; s0 += SHELLS) {
    Sample sm[SHELLS];
#pragma unroll
    for (int k = 0; k < SHELLS; ++k) {
      const int s = min(s0 + k, P - 1);  // a ragged last step repeats
      const int p = FTB ? P - 1 - s : s;
      sm[k] = sample_shell<TL, RGB>(lb + p * hw * 4, p0 + p, q,
                                    g.radii[p], m, W, H);
    }
#pragma unroll
    for (int k = 0; k < SHELLS; ++k) {
      if (s0 + k >= P || done) break;
      const int p = FTB ? P - 1 - (s0 + k) : s0 + k;
      const float sa = sm[k].a, sd = (float)(p0 + p) * inv_p;
      if (FTB) {
        const float ta = __fmul_rn(T, sa);
        if (RGB) {
          r = fmaf(ta, sm[k].r, r);
          gr = fmaf(ta, sm[k].g, gr);
          bl = fmaf(ta, sm[k].b, bl);
        }
        if (DEPTH) d = fmaf(ta, sd, d);
        T = __fmul_rn(T, 1.f - sa);
        done = T < eps;
      } else {
        const float keep = 1.f - sa;
        if (RGB) {
          r = fmaf(sm[k].r, sa, __fmul_rn(r, keep));
          gr = fmaf(sm[k].g, sa, __fmul_rn(gr, keep));
          bl = fmaf(sm[k].b, sa, __fmul_rn(bl, keep));
        }
        if (DEPTH) d = fmaf(sd, sa, __fmul_rn(d, keep));
        if (PARTIAL) T = __fmul_rn(T, keep);
      }
    }
  }
  const long long o = ((long long)b * hw + (long long)i * W + j) * 3;
  if (RGB) {
    rgb_out[o] = r;
    rgb_out[o + 1] = gr;
    rgb_out[o + 2] = bl;
  }
  if (DEPTH) {
    depth_out[o] = d;
    depth_out[o + 1] = d;
    depth_out[o + 2] = d;
  }
  if (PARTIAL) t_out[(long long)b * hw + (long long)i * W + j] = T;
}

dim3 grid_of(const matry::Geo& g) {
  return dim3((unsigned)((g.W + TILE_X - 1) / TILE_X),
              (unsigned)((g.H + TILE_Y - 1) / TILE_Y), (unsigned)g.B);
}

template <typename TL, bool FTB>
void launch(const void* layers, const matry::Geo& g, void* rgb, void* depth,
            float eps, cudaStream_t s) {
  const dim3 grid = grid_of(g), block(TILE_X, TILE_Y);
  const TL* l = (const TL*)layers;
  float *c = (float*)rgb, *d = (float*)depth;
  if (c && d)
    render_layers_kernel<TL, FTB, true, true, false><<<grid, block, 0, s>>>(
        l, g, c, d, eps, 0, g.P, nullptr);
  else if (c)
    render_layers_kernel<TL, FTB, true, false, false><<<grid, block, 0, s>>>(
        l, g, c, d, eps, 0, g.P, nullptr);
  else
    render_layers_kernel<TL, FTB, false, true, false><<<grid, block, 0, s>>>(
        l, g, c, d, eps, 0, g.P, nullptr);
}

}  // namespace

extern "C" int matry_render_layers(const void* layers, const void* pose,
                                   long long pose_stride, const void* pos,
                                   long long pos_stride, const void* radii,
                                   const void* lat, const void* lon,
                                   void* rgb, void* depth, int B, int P,
                                   int H, int W, int layers_bf16, int ftb,
                                   float eps, void* stream) {
  if (!rgb && !depth) return (int)cudaErrorInvalidValue;
  const matry::Geo g = matry::make_geo(pose, pose_stride, pos, pos_stride,
                                       radii, lat, lon, B, P, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  if (layers_bf16) {
    if (ftb)
      launch<__nv_bfloat16, true>(layers, g, rgb, depth, eps, s);
    else
      launch<__nv_bfloat16, false>(layers, g, rgb, depth, eps, s);
  } else {
    if (ftb)
      launch<float, true>(layers, g, rgb, depth, eps, s);
    else
      launch<float, false>(layers, g, rgb, depth, eps, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int matry_render_layers_partial(
    const void* layers, const void* pose, long long pose_stride,
    const void* pos, long long pos_stride, const void* radii, const void* lat,
    const void* lon, void* rgb, void* depth, void* trans, int B, int P,
    int H, int W, int p0, int p_total, int layers_bf16, void* stream) {
  if (!rgb || !depth || !trans || p0 < 0 || p0 + P > p_total)
    return (int)cudaErrorInvalidValue;
  const matry::Geo g = matry::make_geo(pose, pose_stride, pos, pos_stride,
                                       radii, lat, lon, B, P, H, W);
  const dim3 grid = grid_of(g), block(TILE_X, TILE_Y);
  cudaStream_t s = (cudaStream_t)stream;
  float *c = (float*)rgb, *d = (float*)depth, *t = (float*)trans;
  if (layers_bf16)
    render_layers_kernel<__nv_bfloat16, false, true, true, true>
        <<<grid, block, 0, s>>>((const __nv_bfloat16*)layers, g, c, d, 0.f,
                                p0, p_total, t);
  else
    render_layers_kernel<float, false, true, true, true>
        <<<grid, block, 0, s>>>((const float*)layers, g, c, d, 0.f, p0,
                                p_total, t);
  return (int)cudaGetLastError();
}
