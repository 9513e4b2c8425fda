// The high-res layer stack straight from the image pair: the assembled
// mode of the identity-pose dual-eye ODS sweep (K1, sweep.cu).
//
// Replaces, on the high-res re-render (cli/test.py:build_hres_render_fn),
// matryodshka_tpu/ops/pallas_sweep.py:_sweep_kernel (K1) as
// ods_sweep_identity_chunked runs it at 4096x2048, together with the XLA
// work after it: the align-corners upsample of the low-res weights and
// alphas and the high-res assembly (models/msi.py:assemble_hres_prepared).
// One launch writes the interleaved layer stack [B, P', H, W, 4] (r, g, b,
// alpha innermost) that the layer-stack render (render_layers.cu) reads:
//
//   stack[b, p, y, x, :3] = rule(fg, bg, up(blend)[b, p0+p, y, x],
//                                up(bg_rgb)[b, :, y, x])
//   stack[b, p, y, x,  3] = up(alphas)[b, p0+p, y, x]
//
// fg and bg are the ref (order +1) and src (order -1) eyes' sweep samples
// at depths[p] (K1's semantics, row parameters and park), up the
// align-corners bilinear upsample of the low-res [B, h, w, P_low] (or
// [B, h, w, 3]) arrays with F.interpolate(align_corners=True)'s source
// positions (scale (n - 1) / (N - 1), the index the float's floor, the
// upper tap clamped), and rule, per RULE:
//   ALPHA_ONLY  fg;
//   BLEND_PSV   w fg + (1 - w) bg;
//   BLEND_BG    w fg + (1 - w) up(bg_rgb).
// The colour is blended in f32 and rounded once, to the stack's dtype, at
// the store. The upsample's vertical lerp comes first here and its
// horizontal one second (F.interpolate takes them the other way round),
// and the lerps are single FMAs: the values differ from the plain
// version's by a few f32 ulps.
//
// Bound: memory. At 4096x2048 with 32 shells in bf16 the stack is
// 2.15 GB written once; the images (0.20 GB) and the low-res arrays are
// read once from device memory; ~0.72 ms at 3.35 TB/s. It stands in for
// the sweep volume of both eyes (3.2 GB in bf16), the f32 upsample of the
// weights and alphas (2.1 GB), the f32 copies of both eyes and the blend
// (~25 GB of f32 passes) and the stack's own write.
//
// Design: K1's block and windows (sweep_window.cuh), with both eyes in
// one block:
// - a block owns one output row x PLANES planes of one batch element and
//   one tile of TILE_W output columns (the whole width up to TILE_W);
// - a prologue computes the row parameters of the block's planes for the
//   eyes the rule reads (one half-warp per (eye, plane)), and stages the
//   upsample's vertical lerp of the low-res rows that the tile's columns
//   read: per plane of the block the alpha (and blend weight) row, and
//   bg_rgb's three channels, [plane][column] in shared memory;
// - the items (planes) are taken in windows as K1 takes them, a window
//   now holding the taps of both eyes: each eye's rows are staged in a
//   ring of its own, and a window ends where either eye's would overflow;
// - a thread writes COLS consecutive columns of one plane: per channel
//   the COLS + 1 staged columns of each eye (the reversed ramp), then the
//   rule with the horizontal lerp of the staged weights, and the COLS
//   texels as 16-byte streaming stores: 32 bytes of interleaved bf16 or
//   64 of f32.
// Shared memory at 4096x2048 (TILE_W 512, 32 planes, blend_psv): two
// 3-row windows of 576 columns (51.8 KB) and the staged weights (21 KB),
// so three blocks fit an SM. tools/variants.py times 5- and 4-row
// windows, 8 columns a lane (both: two blocks an SM, 10-17% slower),
// 256-column tiles, 16 planes a block and plain stores against it.
//
// Inputs: ref and src [B, H, W, 3] f32 in [0, 1], depths [P'] (the
// block's shells), intrinsics [B, 3, 3], lat [H], lon [W]; alphas and
// blend [B, h, w, P_low] f32 (blend null for ALPHA_ONLY), read at planes
// p0 .. p0+P'-1; bg_rgb [B, h, w, 3] f32 (BLEND_BG only); h <= H and
// w <= W. Output [B, P', H, W, 4] bf16 or f32.

#include <algorithm>
#include <cmath>

#include "sweep_window.cuh"

namespace {

constexpr int PLANES = 32;             // planes per block
constexpr int THREADS = 256;
constexpr int TILE_W = 512;            // output columns per tile
constexpr int WIN_ROWS = 3;            // staged source rows per window
constexpr int HALO = 64;               // window columns beyond the tile
constexpr int COLS = 4;                // output columns per lane

enum Rule { ALPHA_ONLY = 0, BLEND_PSV = 1, BLEND_BG = 2 };

__host__ __device__ constexpr int padded(int cols) {
  return cols + cols / COLS;
}

struct Low {
  const float* alphas;   // [B, h, w, p_low]
  const float* blend;    // [B, h, w, p_low] or null
  const float* bg_rgb;   // [B, h, w, 3] or null
  int h, w, p_low, p0;
};

// F.interpolate(align_corners=True)'s source position of output index i
// at scale (n - 1) / (N - 1): the lower tap, the step to the upper one (0
// at the last source index) and the upper tap's weight.
struct Tap {
  int i0, step;
  float l1;
};

__device__ __forceinline__ Tap src_tap(float scale, int i, int n) {
  const float s = scale * (float)i;
  Tap t;
  t.i0 = (int)s;
  t.step = t.i0 < n - 1 ? 1 : 0;
  t.l1 = s - (float)t.i0;
  return t;
}

// COLS interleaved texels (channels r, g, b from rgb[c][t], alpha from
// a[t]) as 16-byte streaming stores.
__device__ __forceinline__ void store_texels(float* o,
                                             const float (&rgb)[3][COLS],
                                             const float (&a)[COLS]) {
#pragma unroll
  for (int t = 0; t < COLS; ++t)
    __stcs(reinterpret_cast<float4*>(o + 4 * t),
           make_float4(rgb[0][t], rgb[1][t], rgb[2][t], a[t]));
}
__device__ __forceinline__ void store_texels(__nv_bfloat16* o,
                                             const float (&rgb)[3][COLS],
                                             const float (&a)[COLS]) {
#pragma unroll
  for (int t = 0; t < COLS; t += 2) {
    uint4 w;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
    h[0] = __floats2bfloat162_rn(rgb[0][t], rgb[1][t]);
    h[1] = __floats2bfloat162_rn(rgb[2][t], a[t]);
    h[2] = __floats2bfloat162_rn(rgb[0][t + 1], rgb[1][t + 1]);
    h[3] = __floats2bfloat162_rn(rgb[2][t + 1], a[t + 1]);
    __stcs(reinterpret_cast<uint4*>(o + 4 * t), w);
  }
}

template <typename TO, int RULE>
__global__ void __launch_bounds__(THREADS)
    assembled_kernel(matry::SweepArgs g, Low lo, TO* __restrict__ out,
                     int tile_w, int ntiles, int win_cols, int ucols) {
  constexpr int NE = RULE == BLEND_PSV ? 2 : 1;   // eyes read
  constexpr bool BLEND = RULE != ALPHA_ONLY;
  constexpr bool BG = RULE == BLEND_BG;
  extern __shared__ float smem[];
  __shared__ matry::RowParam rp[NE][PLANES];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int i = blockIdx.x / ntiles;
  const int tile = blockIdx.x - i * ntiles;
  const int pb = blockIdx.y * PLANES;
  const int j0 = tile * tile_w;
  const int H = g.H, W = g.W;
  const int tw = min(tile_w, W - j0);
  const int stride = padded(win_cols);
  const float r = g.intr[b * 9];
  const long long hw = (long long)H * W;
  const float* img[2] = {g.ref + (long long)b * hw * 3,
                         g.src + (long long)b * hw * 3};
  float* win[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) win[e] = smem + e * WIN_ROWS * 3 * stride;
  float* up_a = smem + NE * WIN_ROWS * 3 * stride;   // [PLANES][ucols]
  float* up_w = up_a + PLANES * ucols;               // [PLANES][ucols]
  float* up_bg = up_w + (BLEND ? PLANES * ucols : 0);  // [3][ucols]

  // ---- prologue 1: the row parameters of the block's planes, per eye
  // (half-warp per (eye, plane); eye 0 = ref, order +1)
  const int warp = tid >> 5, lane = tid & 31;
  for (int it = warp * 2 + (lane >> 4); it < NE * PLANES;
       it += THREADS / 16) {
    const int e = it / PLANES, pl = it - e * PLANES;
    const int p = min(pb + pl, g.P - 1);
    const matry::RowParam q = matry::sweep_row_param(
        g.depths[p], i, r, e ? -1 : 1, g.lat, g.lon, H, W);
    if ((lane & 15) == 0) rp[e][pl] = q;
  }

  // ---- prologue 2: the vertical lerp of the low-res rows the tile reads
  const float sy = H > 1 ? (float)(lo.h - 1) / (float)(H - 1) : 0.f;
  const float sx = W > 1 ? (float)(lo.w - 1) / (float)(W - 1) : 0.f;
  const Tap ty = src_tap(sy, i, lo.h);
  const int c_lo = src_tap(sx, j0, lo.w).i0;
  const int ncols = min(ucols, lo.w - c_lo);
  const long long row0 = ((long long)b * lo.h + ty.i0) * lo.w;
  const long long row1 = row0 + (long long)ty.step * lo.w;
  const int npl = min(PLANES, g.P - pb);
  for (int idx = tid; idx < PLANES * ncols; idx += THREADS) {
    const int pl = idx % PLANES, c = idx / PLANES;
    const long long col = (long long)(c_lo + c) * lo.p_low + lo.p0 +
                          pb + min(pl, npl - 1);
    up_a[pl * ucols + c] = fmaf(ty.l1, lo.alphas[row1 * lo.p_low + col] -
                                           lo.alphas[row0 * lo.p_low + col],
                                lo.alphas[row0 * lo.p_low + col]);
    if (BLEND)
      up_w[pl * ucols + c] = fmaf(ty.l1, lo.blend[row1 * lo.p_low + col] -
                                             lo.blend[row0 * lo.p_low + col],
                                  lo.blend[row0 * lo.p_low + col]);
  }
  if (BG)
    for (int idx = tid; idx < 3 * ncols; idx += THREADS) {
      const int ch = idx % 3, c = idx / 3;
      const float v0 = lo.bg_rgb[(row0 + c_lo + c) * 3 + ch];
      const float v1 = lo.bg_rgb[(row1 + c_lo + c) * 3 + ch];
      up_bg[ch * ucols + c] = fmaf(ty.l1, v1 - v0, v0);
    }
  __syncthreads();

  const int ngroups = tw / COLS;
  int k = 0;
  while (k < npl) {
    // ---- the next window, both eyes: items k..k1-1
    int ys[NE], yn[NE], cs[NE], cn[NE], k1 = k;
#pragma unroll
    for (int e = 0; e < NE; ++e) ys[e] = yn[e] = cs[e] = cn[e] = 0;
    for (; k1 < npl; ++k1) {
      if (!rp[0][k1].valid) continue;   // validity is the same per eye
      int ys2[NE], yn2[NE], cs2[NE], cn2[NE];
      bool fits = true;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        ys2[e] = ys[e], yn2[e] = yn[e], cs2[e] = cs[e], cn2[e] = cn[e];
        const int clo = matry::wrap(rp[e][k1].x0 - j0 - tw + 1, W);
        fits = fits && matry::grow(ys2[e], yn2[e], rp[e][k1].y0, 2, H, WIN_ROWS) &&
               matry::grow(cs2[e], cn2[e], clo, tw + 1, W, win_cols);
      }
      if (!fits) break;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        ys[e] = ys2[e], yn[e] = yn2[e], cs[e] = cs2[e], cn[e] = cn2[e];
    }
    __syncthreads();                  // the previous window is consumed
#pragma unroll
    for (int e = 0; e < NE; ++e)
      matry::stage_window<COLS, THREADS>(img[e], win[e], ys[e], yn[e],
                                         cs[e], cn[e], stride, H, W);
    __syncthreads();

    // ---- the window's items, COLS columns a thread: task = item-major
    // (item kk, column group grp), walked without divisions
    int kk = k + tid / ngroups, grp = tid % ngroups;
    for (; kk < k1; grp += THREADS) {
      while (grp >= ngroups) {
        grp -= ngroups;
        ++kk;
      }
      if (kk >= k1) break;
      const int j = j0 + grp * COLS;
      // the upsampled weights of the COLS columns: the horizontal lerp
      float ua[COLS], uw[COLS], ubg[3][COLS];
#pragma unroll
      for (int t = 0; t < COLS; ++t) {
        const Tap tx = src_tap(sx, j + t, lo.w);
        const int c = tx.i0 - c_lo;
        const float* ra = up_a + kk * ucols + c;
        ua[t] = fmaf(tx.l1, ra[tx.step] - ra[0], ra[0]);
        if constexpr (BLEND) {
          const float* rw = up_w + kk * ucols + c;
          uw[t] = fmaf(tx.l1, rw[tx.step] - rw[0], rw[0]);
        }
        if constexpr (BG)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float* rb = up_bg + ch * ucols + c;
            ubg[ch][t] = fmaf(tx.l1, rb[tx.step] - rb[0], rb[0]);
          }
      }
      // the eyes' samples, per channel, and the rule
      float rgb[3][COLS];
      const bool valid = rp[0][kk].valid;
      int pos[NE][COLS + 1];
      const float* ra[NE];
      const float* rb2[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const matry::RowParam q = rp[e][kk];
        int sa = q.y0 - ys[e], sb = q.y1 - ys[e];
        sa += sa < 0 ? H : 0;
        sb += sb < 0 ? H : 0;
        ra[e] = win[e] + sa * 3 * stride;
        rb2[e] = win[e] + sb * 3 * stride;
        // window offset of column x0 - j + 1, the xb tap of column j;
        // column j + t samples top - t - 1 (xa) and top - t (xb)
        int top = q.x0 - j + 1 - cs[e];   // in (-2W, W]
        top += top < 0 ? W : 0;
        top += top < 0 ? W : 0;
        top -= top >= W ? W : 0;
#pragma unroll
        for (int t = 0; t <= COLS; ++t) {
          int off = top - t;
          off += off < 0 ? W : 0;
          pos[e][t] = off + off / COLS;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float s[NE][COLS];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          if (!valid) {
            const float park = matry::fsub(
                matry::fmul(img[e][(W + 1) * 3 + c], 2.f), 1.f);
#pragma unroll
            for (int t = 0; t < COLS; ++t) s[e][t] = park;
            continue;
          }
          const matry::RowParam& q = rp[e][kk];
          float col[COLS + 1];
#pragma unroll
          for (int t = 0; t <= COLS; ++t) {
            const float a = ra[e][c * stride + pos[e][t]];
            col[t] = fmaf(q.fy, rb2[e][c * stride + pos[e][t]] - a, a);
          }
#pragma unroll
          for (int t = 0; t < COLS; ++t)
            s[e][t] = fmaf(q.fx, col[t] - col[t + 1], col[t + 1]);
        }
#pragma unroll
        for (int t = 0; t < COLS; ++t) {
          if constexpr (RULE == ALPHA_ONLY)
            rgb[c][t] = s[0][t];
          else if constexpr (RULE == BLEND_PSV)
            rgb[c][t] = fmaf(uw[t], s[0][t], (1.f - uw[t]) * s[NE - 1][t]);
          else
            rgb[c][t] = fmaf(uw[t], s[0][t], (1.f - uw[t]) * ubg[c][t]);
        }
      }
      TO* o = out + ((((long long)b * g.P + pb + kk) * H + i) * W + j) * 4;
      store_texels(o, rgb, ua);
    }
    k = k1 > k ? k1 : k + 1;
  }
}

template <typename TO, int RULE>
int launch(const matry::SweepArgs& g, const Low& lo, void* out,
           cudaStream_t s) {
  constexpr int NE = RULE == BLEND_PSV ? 2 : 1;
  const bool full = g.W <= TILE_W;
  const int tile_w = full ? g.W : TILE_W;
  const int win_cols = full ? g.W : TILE_W + HALO;
  const int ntiles = (g.W + tile_w - 1) / tile_w;
  // the low-res columns a tile reads: the span of its source positions
  // and the upper tap, one more for the float rounding
  const double scale = g.W > 1 ? (double)(lo.w - 1) / (g.W - 1) : 0.0;
  const int ucols = std::min(lo.w, (int)std::ceil((tile_w - 1) * scale) + 3);
  const int planes_staged = RULE == ALPHA_ONLY ? 1 : 2;
  const size_t smem =
      sizeof(float) * ((size_t)NE * WIN_ROWS * 3 * padded(win_cols) +
                       (size_t)planes_staged * PLANES * ucols +
                       (RULE == BLEND_BG ? 3 * ucols : 0));
  cudaError_t e = cudaFuncSetAttribute(
      assembled_kernel<TO, RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(g.H * ntiles),
                  (unsigned)((g.P + PLANES - 1) / PLANES), (unsigned)g.B);
  assembled_kernel<TO, RULE><<<grid, THREADS, smem, s>>>(
      g, lo, (TO*)out, tile_w, ntiles, win_cols, ucols);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_rule(const matry::SweepArgs& g, const Low& lo, int rule,
                void* out, cudaStream_t s) {
  switch (rule) {
    case ALPHA_ONLY:
      return launch<TO, ALPHA_ONLY>(g, lo, out, s);
    case BLEND_PSV:
      return launch<TO, BLEND_PSV>(g, lo, out, s);
    case BLEND_BG:
      return launch<TO, BLEND_BG>(g, lo, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// rule: 0 alpha_only, 1 blend_psv, 2 blend_bg (ops/sweep.py:RULES).
// Shapes the wrapper checks: W % COLS == 0, h <= H, w <= W, p0 + P <= p_low;
// every input contiguous f32; out contiguous and 16-byte aligned.
extern "C" int matry_sweep_assembled(
    const void* ref, const void* src, const void* depths, const void* intr,
    const void* lat, const void* lon, const void* alphas, const void* blend,
    const void* bg_rgb, void* out, int B, int P, int H, int W, int h, int w,
    int p_low, int p0, int rule, int out_bf16, void* stream) {
  if ((rule != ALPHA_ONLY && !blend) || (rule == BLEND_BG && !bg_rgb) ||
      h > H || w > W || p0 < 0 || p0 + P > p_low || W % COLS)
    return (int)cudaErrorInvalidValue;
  const matry::SweepArgs g{(const float*)ref,   (const float*)src,
                           (const float*)depths, (const float*)intr,
                           (const float*)lat,    (const float*)lon,
                           B, P, H, W};
  const Low lo{(const float*)alphas, (const float*)blend,
               (const float*)bg_rgb, h, w, p_low, p0};
  cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? launch_rule<__nv_bfloat16>(g, lo, rule, out, s)
                  : launch_rule<float>(g, lo, rule, out, s);
}
