// Spatial layer norm + ReLU over (C, H, W) per example.
//
// Replaces the LN+ReLU stage of matryodshka_tpu/ops/pallas_net.py
// :_build_kernel (K2), which normalizes each stored conv output with the
// slim.layer_norm semantics of models/unet.py:SpatialLayerNorm: per-example
// mean and variance over C*H*W, eps 1e-12, per-channel gamma/beta, then
// ReLU.
//
// Bound: memory (one read for the statistics, one read and one write for
// the normalization; at most 26 MB each way for a bf16 conv1_1 output).
// Design, two launches on one stream:
//   1. stats: grid (nblk, B); each block sums a contiguous chunk of the
//      example, per thread in f32 over a few dozen elements, then across
//      the block in f64, and writes its partial (s1, s2) in f64;
//   2. apply: grid (nblk, B); each block first folds the nblk partials of
//      its example (f64, so E[x^2] - E[x]^2 loses nothing that matters),
//      then normalizes its own chunk and stores the type of the output.
// Partials go to a [B, nblk, 2] f64 scratch the wrapper allocates; the
// fixed chunking makes the result independent of scheduling (no atomics).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ double block_sum(double v, double* sh) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? sh[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  const double r = sh[0];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln_stats(const T* __restrict__ x, double* __restrict__ partial,
             long long n, long long chunk, int nblk) {
  __shared__ double sh[THREADS / 32];
  const int b = blockIdx.y;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  const T* xb = x + (long long)b * n;
  float s1 = 0.f, s2 = 0.f;
  for (long long e = lo + threadIdx.x; e < hi; e += THREADS) {
    const float v = matry::to_f32(xb[e]);
    s1 += v;
    s2 += v * v;
  }
  const double t1 = block_sum((double)s1, sh);
  const double t2 = block_sum((double)s2, sh);
  if (threadIdx.x == 0) {
    double* pb = partial + ((long long)b * nblk + blockIdx.x) * 2;
    pb[0] = t1;
    pb[1] = t2;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln_apply(const T* __restrict__ x, const double* __restrict__ partial,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             T* __restrict__ out, long long n, long long hw, long long chunk,
             int nblk, float eps, int relu) {
  __shared__ double sh[THREADS / 32];
  const int b = blockIdx.y;
  const double* pb = partial + (long long)b * nblk * 2;
  double t1 = 0.0, t2 = 0.0;
  for (int i = threadIdx.x; i < nblk; i += THREADS) {
    t1 += pb[2 * i];
    t2 += pb[2 * i + 1];
  }
  t1 = block_sum(t1, sh);
  t2 = block_sum(t2, sh);
  const double mean_d = t1 / (double)n;
  double var_d = t2 / (double)n - mean_d * mean_d;
  if (var_d < 0.0) var_d = 0.0;
  const float mean = (float)mean_d;
  const float rstd = rsqrtf((float)var_d + eps);

  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  const T* xb = x + (long long)b * n;
  T* ob = out + (long long)b * n;
  for (long long e = lo + threadIdx.x; e < hi; e += THREADS) {
    const int c = (int)(e / hw);
    float y = (matry::to_f32(xb[e]) - mean) * rstd * gamma[c] + beta[c];
    if (relu && y < 0.f) y = 0.f;
    ob[e] = matry::from_f32<T>(y);
  }
}

template <typename T>
void launch(const void* x, void* partial, const void* gamma,
            const void* beta, void* out, int B, int C, long long hw,
            int nblk, float eps, int relu, cudaStream_t s) {
  const long long n = (long long)C * hw;
  const long long chunk = (n + nblk - 1) / nblk;
  dim3 grid(nblk, B);
  ln_stats<T><<<grid, THREADS, 0, s>>>((const T*)x, (double*)partial, n,
                                       chunk, nblk);
  ln_apply<T><<<grid, THREADS, 0, s>>>(
      (const T*)x, (const double*)partial, (const float*)gamma,
      (const float*)beta, (T*)out, n, hw, chunk, nblk, eps, relu);
}

}  // namespace

extern "C" int matry_layernorm(const void* x, void* partial,
                               const void* gamma, const void* beta,
                               void* out, int B, int C, long long hw,
                               int nblk, float eps, int relu, int is_f32,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32)
    launch<float>(x, partial, gamma, beta, out, B, C, hw, nblk, eps, relu,
                  s);
  else
    launch<__nv_bfloat16>(x, partial, gamma, beta, out, B, C, hw, nblk, eps,
                          relu, s);
  return (int)cudaGetLastError();
}
