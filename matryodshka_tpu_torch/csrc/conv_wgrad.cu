// Weight and bias gradient of the 3x3 wrap conv (K7's backward).
//
// The TPU kernels of matryodshka_tpu/ops/pallas_conv.py (K7) have no
// backward: the JAX trainer runs XLA's convs and takes XLA's gradient. The
// port's trainer runs K7 forward (csrc/conv.cu) and its input gradient is
// that same kernel on the adjoint weights (ops/wrap_conv.py); this file is
// the other half:
//
//   dW[co, ci, kh, kw] = sum_{b,y,x} g[b,co,y,x] * x[b,ci,y+kh-1,(x+kw-1) mod W]
//   db[co]             = sum_{b,y,x} g[b,co,y,x]
//
// with rows outside [0, H) reading zero (the forward's wrap in W, zeros in
// H). As a GEMM: M = Cout, N = 9*Cin, K = B*H*W (12,800 to 204,800 at
// 640x320). Column n = (ci, kh, kw) = (n / 9, n % 9 / 3, n % 3) is the
// parameter layout [Cout, Cin, 3, 3], so dW is written in place.
//
// Bound: operations (2*M*N*K; 151 GFLOP per step over the eight K7 layers
// at the flagship shape, 0.153 ms at 989 TFLOP/s in bf16). The operands, g
// and x read once, are 13-105 MB per layer (~0.08 ms per step at 3.35
// TB/s); the f32 split partials below add ~19 MB written and read per
// layer.
//
// bf16 operands (wgrad_tc_kernel) run on the tensor cores, with mma.cuh's
// building blocks (mma.sync.m16n8k16, bf16 in, f32 accumulate; ldmatrix;
// cp.async):
//   1. A block owns 64 output channels x 32 input channels and keeps all
//      nine taps' accumulators in registers: 8 warps, each 32 (Cout) x 8
//      (Cin) x 9 taps, 72 f32 a thread. A k-block is BK = 32 pixels of one
//      image row (b, y, x0..x0+31), taken in two 16-pixel halves; each A
//      (g) fragment, loaded once per half, feeds the nine taps.
//   2. Both operands are K-contiguous in NCHW (g[co][pixel], x[ci][pixel]),
//      so both tiles are [row][32 pixels] in shared memory and read with
//      plain ldmatrix; rows are padded to 80 bytes so ldmatrix's eight rows
//      fall in distinct banks.
//   3. g arrives by 16-byte cp.async along the image row (W % 8 == 0 at
//      every trainer shape; pixels past the row end read zero).
//   4. x arrives once per k-block as a halo tile: rows y-1, y, y+1 of the
//      block's channels, each 16-byte word of the row run plus its left
//      and right neighbour element (the wrap done on the column index when
//      loading; rows outside [0, H) zero). A horizontal tap shift of one
//      pixel would break ldmatrix's 16-byte row alignment, so each word is
//      stored three times, shifted by -1, 0 and +1 pixel (byte permutes of
//      the word and its neighbours), giving nine aligned [Cin][32] views,
//      one per tap; the vertical taps are the three rows. The loads of
//      k-block j+1 are issued before k-block j's mma and stored after it
//      (two stages, one __syncthreads per k-block).
//   5. db is the row sum of the g tiles already in shared memory, taken by
//      the blocks of the first Cin tile (one 16-byte word a thread a
//      k-block, then the four threads of a row in a fixed order).
//   6. The pixel sum is split over blockIdx.z in whole k-blocks, as many
//      splits as keep the grid within one wave (ops/wrap_conv.py
//      wgrad_tc_splits, fixed by the shape). Each block stages its 64 x 288
//      f32 tile in shared memory and writes it to its split's partial
//      [S, Cout, 9*Cin + 1] in coalesced rows (db in the last column).
// Shapes whose W is not a multiple of 8 (or unaligned operands) take the
// same kernel with scalar loads in place of the 16-byte copies.
//
// f32 operands (wgrad_f32_kernel) keep exact f32 FMA on the CUDA cores: a
// 64 (Cout) x 128 (column) tile per block, K in steps of 16 pixels staged
// in shared memory, a 4 x 8 register tile per thread; the bias is the
// all-ones column N = 9*Cin; K split over blockIdx.z into pixel chunks.
//
// Both write f32 partials; wgrad_reduce sums the S partials of each entry
// in order, in f64. No atomics: the result is the same on every run.

#include "common.cuh"
#include "mma.cuh"

namespace {

struct WArgs {
  int B, Cin, Cout, H, W;
  long long chunk;  // f32: pixels per split; bf16: k-blocks per split
};

// ---------------------------------------------------------------------------
// f32 operands: exact FMA on the CUDA cores.
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BM = 64;   // output channels per block
constexpr int BN = 128;  // (ci, kh, kw) columns per block
constexpr int BK = 16;   // pixels per reduction step
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int PAD = 4;

__global__ void __launch_bounds__(256)
    wgrad_f32_kernel(const float* __restrict__ g, const float* __restrict__ x,
                     float* __restrict__ partial, WArgs a) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int N = 9 * a.Cin + 1;
  const long long hw = (long long)a.H * a.W;
  const long long K = a.B * hw;
  const long long kbeg = blockIdx.z * a.chunk;
  const long long kend = kbeg + a.chunk < K ? kbeg + a.chunk : K;

  // Loaders: this thread's pixel row lk of the tile, 4 channels of A and
  // 8 columns of B.
  const int lk = tid & (BK - 1);
  const int grp = tid >> 4;
  long long coff[TN];  // ci * H * W, or -1 for the bias column, -2 past N
  int cdy[TN], cdx[TN];
#pragma unroll
  for (int q = 0; q < TN; ++q) {
    const int n = n0 + grp * TN + q;
    const int ci = n / 9;
    const int tap = n - ci * 9;
    coff[q] = n < N - 1 ? (long long)ci * hw : (n == N - 1 ? -1 : -2);
    cdy[q] = tap / 3 - 1;
    cdx[q] = tap % 3 - 1;
  }

  const int tx = tid & 15;  // column group: tx * TN
  const int ty = tid >> 4;  // channel group: ty * TM
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (long long k0 = kbeg; k0 < kend; k0 += BK) {
    const long long kk = k0 + lk;
    const bool kok = kk < kend;
    int b = 0, yy = 0, xx = 0;
    if (kok) {
      b = (int)(kk / hw);
      const long long r = kk - b * hw;
      yy = (int)(r / a.W);
      xx = (int)(r - (long long)yy * a.W);
    }
    const float* gp = g + (long long)b * a.Cout * hw + (long long)yy * a.W + xx;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int m = m0 + grp * TM + q;
      As[lk][grp * TM + q] = (kok && m < a.Cout) ? gp[(long long)m * hw] : 0.f;
    }
    const float* xb = x + (long long)b * a.Cin * hw;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      float v = 0.f;
      if (kok) {
        if (coff[q] >= 0) {
          const int iy = yy + cdy[q];
          if (iy >= 0 && iy < a.H)
            v = xb[coff[q] + (long long)iy * a.W + matry::wrap(xx + cdx[q], a.W)];
        } else if (coff[q] == -1) {
          v = 1.f;
        }
      }
      Bs[lk][grp * TN + q] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[k][tx * TN + 4]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* pz = partial + (long long)blockIdx.z * a.Cout * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= a.Cout) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) pz[(long long)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

using namespace matry::mma;

constexpr int BM = 64;   // output channels per block
constexpr int BC = 32;   // input channels per block (x 9 taps = 288 columns)
constexpr int BK = 32;   // pixels per k-block: a run of one image row
constexpr int NT = 256;  // 8 warps: 2 (32 Cout) x 4 (8 Cin), all 9 taps each
constexpr int ST = BK + 8;            // tile row stride (elements), 80 B
constexpr int kA = BM * ST;           // g tile [BM][ST]
constexpr int kX = 9 * BC * ST;       // x views [tap][BC][ST]
constexpr int kStage = kA + kX;       // elements per stage (two stages)
constexpr int CST = 9 * BC + 1;       // epilogue tile row stride (floats)
constexpr int kSmemRing = 2 * kStage * 2;
constexpr int kSmemOut = BM * CST * 4;
constexpr int kSmem = kSmemRing > kSmemOut ? kSmemRing : kSmemOut;  // bytes
constexpr int kItems = 3 * BC * (BK / 8);  // x words per k-block
constexpr int kPer = (kItems + NT - 1) / NT;
static_assert(BM * BK / 8 == NT, "one 16-byte g word per thread");

struct TArgs {
  int B, Cin, Cout, H, W;
  int kpr;    // k-blocks per image row, ceil(W / BK)
  int nkb;    // k-blocks in all, B * H * kpr
  int chunk;  // k-blocks per split
};

// 16 bytes of bf16 starting one element later: (hi half of a, lo of b).
__device__ __forceinline__ uint32_t shift1(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5432);
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
    wgrad_tc_kernel(const unsigned short* __restrict__ g,
                    const unsigned short* __restrict__ x,
                    float* __restrict__ partial, TArgs a) {
  extern __shared__ __align__(16) unsigned short smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * BC;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * a.chunk;
  const int kend = min(kbeg + a.chunk, a.nkb);
  const int nk = kend > kbeg ? kend - kbeg : 0;
  const bool bias_block = blockIdx.x == 0;

  // g loader (and the db sum): channel m0 + am, pixels 8*aq .. 8*aq + 7
  const int am = tid >> 2, aq = tid & 3;
  const bool am_ok = m0 + am < a.Cout;
  // warp tile: channels wm .. wm + 31 of g, wc .. wc + 7 of x
  const int wm = (warp & 1) * 32;
  const int wc = (warp >> 1) * 8;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = 0.f;
  float dsum = 0.f;

  // the k-block being staged: x words (and, scalar path, the g word)
  uint32_t xv[kPer][4], xlr[kPer], gv[4];

  auto decode = [&](int kb, int& b, int& y, int& x0) {
    const int row = kb / a.kpr;
    x0 = (kb - row * a.kpr) * BK;
    b = row / a.H;
    y = row - b * a.H;
  };

  auto load = [&](int stage, int kb) {
    int b, y, x0;
    decode(kb, b, y, x0);
    const int px = x0 + aq * 8;
    const unsigned short* gs =
        g + ((long long)(b * a.Cout + m0 + am) * a.H + y) * a.W + px;
    if (VEC) {
      const bool ok = am_ok && px < a.W;
      cp_async16(smem + stage * kStage + am * ST + aq * 8, ok ? gs : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = am_ok && px + 2 * e < a.W ? gs[2 * e] : 0u;
        const uint32_t hi = am_ok && px + 2 * e + 1 < a.W ? gs[2 * e + 1] : 0u;
        gv[e] = lo | (hi << 16);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int it = tid + k * NT;
      const int r = it / (BC * 4);
      const int rem = it - r * (BC * 4);
      const int ci = c0 + (rem >> 2), col = x0 + (rem & 3) * 8;
      const int yy = y + r - 1;
      uint32_t v[4] = {0u, 0u, 0u, 0u}, lr = 0u;
      if (it < kItems && ci < a.Cin && yy >= 0 && yy < a.H) {
        const unsigned short* row =
            x + ((long long)(b * a.Cin + ci) * a.H + yy) * a.W;
        if (VEC) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              row + matry::wrap(col, a.W));
          v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = (uint32_t)row[matry::wrap(col + 2 * e, a.W)] |
                   ((uint32_t)row[matry::wrap(col + 2 * e + 1, a.W)] << 16);
        }
        lr = (uint32_t)row[matry::wrap(col - 1, a.W)] |
             ((uint32_t)row[matry::wrap(col + 8, a.W)] << 16);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[k][e] = v[e];
      xlr[k] = lr;
    }
  };

  // the staged words into stage `stage`: each x word as the views of taps
  // (r, 0), (r, 1), (r, 2), i.e. shifted by -1, 0, +1 pixel
  auto store = [&](int stage) {
    unsigned short* base = smem + stage * kStage;
    if (!VEC)
      *reinterpret_cast<uint4*>(base + am * ST + aq * 8) =
          make_uint4(gv[0], gv[1], gv[2], gv[3]);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int it = tid + k * NT;
      if (it >= kItems) break;
      const int r = it / (BC * 4);
      const int rem = it - r * (BC * 4);
      const uint32_t v0 = xv[k][0], v1 = xv[k][1], v2 = xv[k][2],
                     v3 = xv[k][3];
      unsigned short* d =
          base + kA + ((3 * r) * BC + (rem >> 2)) * ST + (rem & 3) * 8;
      *reinterpret_cast<uint4*>(d) =
          make_uint4((xlr[k] & 0xffffu) | (v0 << 16), shift1(v0, v1),
                     shift1(v1, v2), shift1(v2, v3));
      *reinterpret_cast<uint4*>(d + BC * ST) = make_uint4(v0, v1, v2, v3);
      *reinterpret_cast<uint4*>(d + 2 * BC * ST) =
          make_uint4(shift1(v0, v1), shift1(v1, v2), shift1(v2, v3),
                     (v3 >> 16) | (xlr[k] & 0xffff0000u));
    }
  };

  auto compute = [&](int stage) {
    const unsigned short* as = smem + stage * kStage;
    const unsigned short* xs = as + kA;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {  // the k-block's two 16-pixel halves
      uint32_t af[2][4];  // [m16 tile]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], as + (wm + mt * 16 + (lane & 15)) * ST + kh * 16 +
                            (lane >> 4) * 8);
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        uint32_t bf[2];  // pixels 0-7, 8-15 of the half, channels wc + 0-7
        ldsm_x2(bf, xs + (t * BC + wc + (lane & 7)) * ST + kh * 16 +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[t][mt], af[mt], bf[0], bf[1]);
      }
    }
    if (bias_block) {
      const uint4 u = *reinterpret_cast<const uint4*>(as + am * ST + aq * 8);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsum += __uint_as_float(w[e] << 16) +
                __uint_as_float(w[e] & 0xffff0000u);
    }
  };

  if (nk > 0) {
    load(0, kbeg);
    store(0);
  }
  cp_async_commit();
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // k-block j visible; stage (j + 1) & 1 free
    const bool more = j + 1 < nk;
    if (more) load((j + 1) & 1, kbeg + j + 1);
    cp_async_commit();
    compute(j & 1);
    if (more) store((j + 1) & 1);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the 64 x 288 tile through shared memory, rows to the partial
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = (wc + (lane & 3) * 2 + (e & 1)) * 9 + t;
        cs[row * CST + col] = acc[t][mt][e];
      }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  __syncthreads();
  const int N1 = 9 * a.Cin + 1;
  const int ncol = 9 * min(BC, a.Cin - c0);
  float* pz = partial + (long long)blockIdx.z * a.Cout * N1;
  for (int i = tid; i < BM * 9 * BC; i += NT) {
    const int row = i / (9 * BC);
    const int col = i - row * (9 * BC);
    if (m0 + row < a.Cout && col < ncol)
      pz[(long long)(m0 + row) * N1 + 9 * c0 + col] = cs[row * CST + col];
  }
  if (bias_block && aq == 0 && am_ok)
    pz[(long long)(m0 + am) * N1 + N1 - 1] = dsum;
}

}  // namespace tc

// Entry (m, n) of dW / db: the S split partials summed in order, in f64.
__global__ void __launch_bounds__(256)
    wgrad_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                 float* __restrict__ db, int splits, int cout, int n1) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long total = (long long)cout * n1;
  if (e >= total) return;
  double s = 0.0;
  for (int z = 0; z < splits; ++z) s += partial[z * total + e];
  const int m = (int)(e / n1);
  const int n = (int)(e - (long long)m * n1);
  if (n < n1 - 1)
    dw[(long long)m * (n1 - 1) + n] = (float)s;
  else
    db[m] = (float)s;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

void launch_f32(const void* g, const void* x, void* partial, const WArgs& a,
                int splits, cudaStream_t s) {
  const int n1 = 9 * a.Cin + 1;
  dim3 grid(cdiv(n1, f32::BN), cdiv(a.Cout, f32::BM), splits);
  f32::wgrad_f32_kernel<<<grid, 256, 0, s>>>((const float*)g, (const float*)x,
                                             (float*)partial, a);
}

template <bool VEC>
cudaError_t launch_tc_vec(const void* g, const void* x, void* partial,
                          const tc::TArgs& ta, int splits, cudaStream_t s) {
  auto kern = tc::wgrad_tc_kernel<VEC>;
  static bool attr = false;  // once per instantiation
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  dim3 grid(cdiv(ta.Cin, tc::BC), cdiv(ta.Cout, tc::BM), splits);
  kern<<<grid, tc::NT, tc::kSmem, s>>>((const unsigned short*)g,
                                       (const unsigned short*)x,
                                       (float*)partial, ta);
  return cudaSuccess;
}

// k-blocks of the bf16 kernel's pixel sum for (B, H, W): B * H * ceil(W/32)
// (ops/wrap_conv.py wgrad_tc_kblocks).
int wgrad_kblocks(int B, int H, int W) { return B * H * cdiv(W, tc::BK); }

}  // namespace

// g [B, Cout, H, W] and x [B, Cin, H, W], both f32 (is_f32) or both bf16;
// partial: f32 scratch [splits, Cout, 9*Cin + 1]; dw [Cout, Cin, 3, 3] and
// db [Cout] f32. f32: split z covers pixels [z*chunk, (z+1)*chunk) of
// B*H*W. bf16: split z covers k-blocks [z*chunk, (z+1)*chunk) of
// wgrad_kblocks(B, H, W), k-block k being pixels
// 32*(k % ceil(W/32)) .. +31 of image row k / ceil(W/32) (row = b*H + y).
extern "C" int matry_conv_wgrad(const void* g, const void* x, void* partial,
                                void* dw, void* db, int B, int Cin, int Cout,
                                int H, int W, int splits, long long chunk,
                                int is_f32, void* stream) {
  const WArgs a{B, Cin, Cout, H, W, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  const long long need =
      is_f32 ? (long long)B * H * W : (long long)wgrad_kblocks(B, H, W);
  if (splits < 1 || chunk < 1 || (long long)splits * chunk < need ||
      (!is_f32 && chunk > need))
    return (int)cudaErrorInvalidValue;
  if (is_f32) {
    launch_f32(g, x, partial, a, splits, s);
  } else {
    const tc::TArgs ta{B, Cin, Cout, H, W, cdiv(W, tc::BK),
                       wgrad_kblocks(B, H, W), (int)chunk};
    const bool vec = W % 8 == 0 && ((uintptr_t)g & 15) == 0 &&
                     ((uintptr_t)x & 15) == 0;
    const cudaError_t err =
        vec ? launch_tc_vec<true>(g, x, partial, ta, splits, s)
            : launch_tc_vec<false>(g, x, partial, ta, splits, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int n1 = 9 * Cin + 1;
  const long long total = (long long)Cout * n1;
  wgrad_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const float*)partial, (float*)dw, (float*)db, splits, Cout, n1);
  return (int)cudaGetLastError();
}
