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
// H). As a GEMM: M = Cout, N = 9*Cin + 1, K = B*H*W (up to 204,800 at
// 640x320). Column n < 9*Cin is (ci, kh, kw) = (n / 9, n % 9 / 3, n % 3),
// the parameter layout [Cout, Cin, 3, 3], so dW is written in place; the
// last column reads 1 and gives db.
//
// Bound: compute (2*M*N*K; 151 GFLOP per step over the eight K7 layers at
// the flagship shape). Like conv.cu this first kernel runs on the CUDA
// cores in f32 FMA: a 64 (Cout) x 128 (column) tile per block, K in steps
// of 16 staged in shared memory (rows padded by 4 floats against bank
// conflicts in the transposing stores), a 4 x 8 register tile per thread.
// Each thread decodes its pixel once per K step and its 8 columns once.
// K is split over blockIdx.z into fixed chunks; each block writes its f32
// partial tile to [S, Cout, N], and wgrad_reduce sums the S partials of
// each entry in order, in f64. No atomics: the result is the same on every
// run.

#include "common.cuh"

namespace {

constexpr int BM = 64;   // output channels per block
constexpr int BN = 128;  // (ci, kh, kw) columns per block
constexpr int BK = 16;   // pixels per reduction step
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int PAD = 4;

struct WArgs {
  int B, Cin, Cout, H, W;
  long long chunk;  // pixels per split
};

template <typename T>
__global__ void __launch_bounds__(256)
    wgrad_kernel(const T* __restrict__ g, const T* __restrict__ x,
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
    const T* gp = g + (long long)b * a.Cout * hw + (long long)yy * a.W + xx;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int m = m0 + grp * TM + q;
      As[lk][grp * TM + q] =
          (kok && m < a.Cout) ? matry::to_f32(gp[(long long)m * hw]) : 0.f;
    }
    const T* xb = x + (long long)b * a.Cin * hw;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      float v = 0.f;
      if (kok) {
        if (coff[q] >= 0) {
          const int iy = yy + cdy[q];
          if (iy >= 0 && iy < a.H)
            v = matry::to_f32(
                xb[coff[q] + (long long)iy * a.W + matry::wrap(xx + cdx[q],
                                                               a.W)]);
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

template <typename T>
void launch(const void* g, const void* x, void* partial, void* dw, void* db,
            const WArgs& a, int splits, cudaStream_t s) {
  const int n1 = 9 * a.Cin + 1;
  dim3 grid((n1 + BN - 1) / BN, (a.Cout + BM - 1) / BM, splits);
  wgrad_kernel<T><<<grid, 256, 0, s>>>((const T*)g, (const T*)x,
                                       (float*)partial, a);
  const long long total = (long long)a.Cout * n1;
  wgrad_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const float*)partial, (float*)dw, (float*)db, splits, a.Cout, n1);
}

}  // namespace

// g [B, Cout, H, W] and x [B, Cin, H, W], both f32 (is_f32) or both bf16;
// partial: f32 scratch [splits, Cout, 9*Cin + 1]; dw [Cout, Cin, 3, 3] and
// db [Cout] f32. Split z covers pixels [z*chunk, (z+1)*chunk) of B*H*W.
extern "C" int matry_conv_wgrad(const void* g, const void* x, void* partial,
                                void* dw, void* db, int B, int Cin, int Cout,
                                int H, int W, int splits, long long chunk,
                                int is_f32, void* stream) {
  const WArgs a{B, Cin, Cout, H, W, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  if (splits < 1 || chunk < 1 || (long long)splits * chunk <
                                      (long long)B * H * W)
    return (int)cudaErrorInvalidValue;
  if (is_f32)
    launch<float>(g, x, partial, dw, db, a, splits, s);
  else
    launch<__nv_bfloat16>(g, x, partial, dw, db, a, splits, s);
  return (int)cudaGetLastError();
}
