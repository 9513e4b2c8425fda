// Dual-eye identity-pose ODS sphere sweep, lookup parameters included.
//
// Replaces matryodshka_tpu/ops/pallas_sweep.py:_sweep_kernel (K1) together
// with the XLA work beside it on the TPU path: the row parameters
// (pallas_sweep._row_params) and the image preprocessing. With an identity
// sweep pose the ODS lookup field is row-separable: on (eye, plane, row)
// the source row pair y0/y1 and weight fy are constant, and the column is
// x0 - j (a unit-slope ramp that wraps mod W), so the horizontal weight fx
// is one per row too. Each block computes the parameters of the rows it
// owns (project.cuh:sweep_row_param, with the semantics of
// ops/sweep.py:row_params), so a sweep is one launch.
//
// Bound: memory. The kernel writes the whole net input, 2*P*3*H*W
// elements (79 MB in bf16 at 640x320x32), and reads the two source images
// (4.9 MB) once from device memory. Design:
// - a block owns ROWS output rows x PLANES planes of one (batch, eye),
//   and one tile of TILE_W output columns (the whole width up to
//   FULL_W): one row of 32 planes, as the planes of a row read nearly
//   the same source rows (tools/variants.py times 4 rows x 8 planes and
//   2 x 16 against it);
// - a prologue computes the block's ROWS * PLANES row parameters, one
//   half-warp per row (16 probe columns, a ballot picks the first that is
//   not parked), into shared memory;
// - the items are then taken in windows: a window is a circular range of
//   at most WIN_ROWS source rows and WIN_COLS source columns that holds
//   the taps of consecutive items. Every thread computes the same windows
//   from the shared parameters; each window's rows are staged once in
//   shared memory, preprocessed (2x - 1) and split into planar channels,
//   and the items it serves are written from there (sweep_window.cuh,
//   shared with the assembled mode, sweep_assembled.cu);
// - a thread writes COLS consecutive columns of one row: per channel,
//   COLS + 1 staged columns (the reversed ramp x0 - j, wrapping) and
//   16-byte vector stores. Staged rows are padded by one word per COLS
//   (pos(x) = x + x/COLS), so the lanes of a warp, COLS columns apart,
//   read different banks.
// The lerps are a + f (b - a) in one FMA each; the plain version's
// (1 - f) a + f b rounds three times, so the two differ by about an ulp.
//
// Inputs: ref and src images [B, H, W, 3] f32 in [0, 1] (the batch's, not
// preprocessed), depths [P], intrinsics [B, 3, 3] (r = [b, 0, 0]),
// lat [H] and lon [W] (grids.lat_long_grid's vectors). Output
// [B, 2*P*3, H, W], channel (eye*P + p)*3 + c -- the channels-first form
// of format_network_input's channel order, which the net reads as is and
// the render views as [B, 2, P, 3, H, W]; eye 0 is ref (order +1), eye 1
// src (order -1). Rows with no tangent ray (valid == 0) take
// image[eye, :, 1, 1], the reference's park at pixel (1, 1).
//
// matry_sweep_row_params is an instrument: it writes the same row
// parameters into [B, 2, P, H] tables, so that the projection and the
// sweep can be checked apart.

#include "sweep_window.cuh"

namespace {

constexpr int ROWS = 1;                // output rows per block
constexpr int PLANES = 32;             // planes per block
constexpr int ITEMS = ROWS * PLANES;   // (plane, row) items per block
constexpr int THREADS = 256;
constexpr int FULL_W = 1024;           // widths up to this: one tile
constexpr int TILE_W = 512;            // output columns per tile beyond
constexpr int WIN_ROWS = 5;            // staged source rows per window
constexpr int WIN_COLS_TILED = TILE_W + 64;
constexpr int COLS = 8;                // output columns per lane

// A staged row of `cols` words, padded by one word per COLS so that
// lanes COLS columns apart read different banks.
__host__ __device__ constexpr int padded(int cols) {
  return cols + cols / COLS;
}

using Args = matry::SweepArgs;
using matry::grow;

// COLS consecutive outputs as 16-byte streaming stores (st.global.cs:
// the volume is written once, larger than L2, and read by the next
// kernel from device memory either way).
__device__ __forceinline__ void store_cols(float* o, const float* v) {
#pragma unroll
  for (int t = 0; t < COLS; t += 4)
    __stcs(reinterpret_cast<float4*>(o + t),
           make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]));
}
__device__ __forceinline__ void store_cols(__nv_bfloat16* o, const float* v) {
#pragma unroll
  for (int t = 0; t < COLS; t += 8) {
    uint4 w;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      h[q] = __floats2bfloat162_rn(v[t + 2 * q], v[t + 2 * q + 1]);
    __stcs(reinterpret_cast<uint4*>(o + t), w);
  }
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
    sweep_kernel(Args g, TO* __restrict__ out, int tile_w, int ntiles,
                 int win_cols) {
  extern __shared__ float stage[];     // [WIN_ROWS][3][padded(win_cols)]
  __shared__ matry::RowParam rp[ITEMS];

  const int tid = threadIdx.x;
  const int be = blockIdx.z;           // b * 2 + eye
  const int b = be >> 1, eye = be & 1;
  const int band = blockIdx.x / ntiles;
  const int tile = blockIdx.x - band * ntiles;
  const int i0 = band * ROWS, p0 = blockIdx.y * PLANES;
  const int j0 = tile * tile_w;
  const int H = g.H, W = g.W;
  const int tw = min(tile_w, W - j0);
  const float r = g.intr[b * 9];
  const float* img = (eye ? g.src : g.ref) + (long long)b * H * W * 3;

  // ---- prologue: the row parameters of the block's items (half-warp
  // per item; item = plane-major index pl * ROWS + row)
  const int warp = tid >> 5, lane = tid & 31;
  for (int it = warp * 2 + (lane >> 4); it < ITEMS; it += THREADS / 16) {
    const int p = min(p0 + it / ROWS, g.P - 1);
    const int i = min(i0 + it % ROWS, H - 1);
    const matry::RowParam q = matry::sweep_row_param(
        g.depths[p], i, r, eye ? -1 : 1, g.lat, g.lon, H, W);
    if ((lane & 15) == 0) rp[it] = q;
  }
  __syncthreads();

  const int ngroups = tw / COLS;
  const int stride = padded(win_cols);
  const long long hw = (long long)H * W;
  int k = 0;
  while (k < ITEMS) {
    // ---- the next window: items k..k1-1
    int ys = 0, yn = 0, cs = 0, cn = 0, k1 = k;
    for (; k1 < ITEMS; ++k1) {
      const int p = p0 + k1 / ROWS, i = i0 + k1 % ROWS;
      if (p >= g.P || i >= H || !rp[k1].valid) continue;
      int ys2 = ys, yn2 = yn, cs2 = cs, cn2 = cn;
      const int c_lo = matry::wrap(rp[k1].x0 - j0 - tw + 1, W);
      if (!grow(ys2, yn2, rp[k1].y0, 2, H, WIN_ROWS) ||
          !grow(cs2, cn2, c_lo, tw + 1, W, win_cols))
        break;
      ys = ys2, yn = yn2, cs = cs2, cn = cn2;
    }
    __syncthreads();                  // the previous window is consumed
    matry::stage_window<COLS, THREADS>(img, stage, ys, yn, cs, cn, stride,
                                       H, W);
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
      const int p = p0 + kk / ROWS, i = i0 + kk % ROWS;
      if (p >= g.P || i >= H) continue;
      const matry::RowParam q = rp[kk];
      TO* o = out + (((long long)be * g.P + p) * 3) * hw + (long long)i * W +
              j0 + grp * COLS;
      float v[COLS];
      if (!q.valid) {
        for (int c = 0; c < 3; ++c) {
          const float park =
              matry::fsub(matry::fmul(img[(W + 1) * 3 + c], 2.f), 1.f);
          for (int t = 0; t < COLS; ++t) v[t] = park;
          store_cols(o + c * hw, v);
        }
        continue;
      }
      int sa = q.y0 - ys, sb = q.y1 - ys;
      sa += sa < 0 ? H : 0;
      sb += sb < 0 ? H : 0;
      const float* ra = stage + sa * 3 * stride;
      const float* rb = stage + sb * 3 * stride;
      // window offset of column x0 - j + 1 (j = j0 + COLS*grp), the xb tap
      // of column j; column j + t samples top - t - 1 (xa) and top - t
      // (xb), wrapping in full-width windows
      int top = q.x0 - j0 - grp * COLS + 1 - cs;   // in (-2W, W]
      top += top < 0 ? W : 0;
      top += top < 0 ? W : 0;
      top -= top >= W ? W : 0;
      int pos[COLS + 1];
#pragma unroll
      for (int t = 0; t <= COLS; ++t) {
        int off = top - t;
        off += off < 0 ? W : 0;
        pos[t] = off + off / COLS;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // (1 - f) a + f b as a + f (b - a): one rounding fewer than the
        // plain version's three, within its f32 gate
        float col[COLS + 1];
#pragma unroll
        for (int t = 0; t <= COLS; ++t) {
          const float a = ra[c * stride + pos[t]];
          col[t] = fmaf(q.fy, rb[c * stride + pos[t]] - a, a);
        }
#pragma unroll
        for (int t = 0; t < COLS; ++t)
          v[t] = fmaf(q.fx, col[t] - col[t + 1], col[t + 1]);
        store_cols(o + c * hw, v);
      }
    }
    k = k1 > k ? k1 : k + 1;
  }
}

__global__ void __launch_bounds__(THREADS)
    row_params_kernel(Args g, int* __restrict__ y0, int* __restrict__ y1,
                      float* __restrict__ fy, int* __restrict__ x0,
                      float* __restrict__ fx, int* __restrict__ valid) {
  // one half-warp per (b, eye, p, i) row of the [B, 2, P, H] tables
  const long long n = (long long)g.B * 2 * g.P * g.H;
  const long long row =
      ((long long)blockIdx.x * THREADS + threadIdx.x) / 16;
  const long long rr = row < n ? row : n - 1;
  const int i = (int)(rr % g.H);
  const int p = (int)(rr / g.H % g.P);
  const int be = (int)(rr / ((long long)g.H * g.P));
  const int b = be >> 1, eye = be & 1;
  const matry::RowParam q = matry::sweep_row_param(
      g.depths[p], i, g.intr[b * 9], eye ? -1 : 1, g.lat, g.lon, g.H, g.W);
  if (row < n && (threadIdx.x & 15) == 0) {
    y0[row] = q.y0;
    y1[row] = q.y1;
    fy[row] = q.fy;
    x0[row] = q.x0;
    fx[row] = q.fx;
    valid[row] = q.valid;
  }
}

Args make_args(const void* ref, const void* src, const void* depths,
               const void* intr, const void* lat, const void* lon, int B,
               int P, int H, int W) {
  return Args{(const float*)ref, (const float*)src, (const float*)depths,
              (const float*)intr, (const float*)lat, (const float*)lon,
              B, P, H, W};
}

template <typename TO>
int launch_sweep(const Args& g, void* out, cudaStream_t s) {
  const bool full = g.W <= FULL_W;
  const int tile_w = full ? g.W : TILE_W;
  const int win_cols = full ? g.W : WIN_COLS_TILED;
  const int ntiles = (g.W + tile_w - 1) / tile_w;
  const size_t smem = sizeof(float) * WIN_ROWS * 3 * padded(win_cols);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((g.H + ROWS - 1) / ROWS * ntiles),
                  (unsigned)((g.P + PLANES - 1) / PLANES),
                  (unsigned)(g.B * 2));
  sweep_kernel<TO><<<grid, THREADS, smem, s>>>(g, (TO*)out, tile_w, ntiles,
                                               win_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes the wrapper checks: W % 8 == 0; all pointers contiguous f32
// (out bf16 when out_bf16).
extern "C" int matry_sweep(const void* ref, const void* src,
                           const void* depths, const void* intr,
                           const void* lat, const void* lon, void* out,
                           int B, int P, int H, int W, int out_bf16,
                           void* stream) {
  const Args g = make_args(ref, src, depths, intr, lat, lon, B, P, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? launch_sweep<__nv_bfloat16>(g, out, s)
                  : launch_sweep<float>(g, out, s);
}

extern "C" int matry_sweep_row_params(const void* depths, const void* intr,
                                      const void* lat, const void* lon,
                                      void* y0, void* y1, void* fy,
                                      void* x0, void* fx, void* valid,
                                      int B, int P, int H, int W,
                                      void* stream) {
  const Args g = make_args(nullptr, nullptr, depths, intr, lat, lon, B, P,
                           H, W);
  const long long rows = (long long)B * 2 * P * H;
  const unsigned blocks = (unsigned)((rows * 16 + THREADS - 1) / THREADS);
  row_params_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, (int*)y0, (int*)y1, (float*)fy, (int*)x0, (float*)fx, (int*)valid);
  return (int)cudaGetLastError();
}
