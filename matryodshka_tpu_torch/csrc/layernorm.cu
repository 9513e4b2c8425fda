// Spatial layer norm + ReLU over (C, H, W) per example.
//
// Replaces the LN+ReLU stage of matryodshka_tpu/ops/pallas_net.py
// :_build_kernel (K2), which normalizes each stored conv output with the
// slim.layer_norm semantics of models/unet.py:SpatialLayerNorm: per-example
// mean and variance over C*H*W, eps 1e-12, per-channel gamma/beta, then
// ReLU, rounded once to x's dtype.
//
// Bound: memory. The least traffic is one read of x and one write of the
// output (2 x 26.2 MB for a bf16 conv1_1 output, 2 x 183.8 MB over the 17
// layers of a frame, 0.110 ms at 3.35 TB/s); the statistics need every
// element before the first can be written, so a kernel that streams x from
// device memory twice moves 1.5x that.
//
// The on-chip form (ln_onchip), for one example whose share per block fits
// in shared memory (every layer of the flagship net at batch 1, bf16: at
// most 198.6 KB of the 227 KB a block may hold), keeps x on chip:
//   1. one persistent grid of one 1024-thread block per SM, launched
//      cooperatively so that every block is resident;
//   2. each block copies its contiguous share of the example into shared
//      memory with 16-byte loads (four in flight a thread) and sums it in
//      f32 per thread, then in f64 over the block, one (s1, s2) partial a
//      block;
//   3. one grid-wide barrier (cooperative_groups' grid sync); then every
//      block folds all partials in the same fixed order in f64 (so
//      E[x^2] - E[x]^2 loses nothing that matters), normalizes its share
//      from shared memory and writes it with 16-byte stores.
// Each byte moves once in and once out, in one launch a layer.
//
// The two-pass form, for a batch above 1 or a share that does not fit:
// grid (blocks, B); ln_stats sums each block's chunk into its partial with
// the same vector loads, ln_apply folds its example's partials in the same
// fixed order and normalizes its chunk read again from device memory.
//
// The shape chooses the form (ops/layernorm.py ln_plan); neither form
// stands in for the other. Both find a vector's channel once (one 32-bit
// division a 16-byte vector, then a running count), and both fall back to
// scalar accesses where the example is not a whole number of 16-byte
// vectors or an operand is unaligned. No atomics: the result is the same
// on every run.

#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNTChip = 1024;  // threads of the on-chip form's blocks
constexpr int kNTTwo = 256;    // threads of the two-pass form's blocks
constexpr int kUnroll = 4;     // 16-byte loads in flight a thread

// elements of T in a 16-byte vector
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))
            << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Sum over the block in a fixed order: butterfly within each warp, then the
// warp sums by warp 0. sh holds NT / 32 doubles.
template <int NT>
__device__ double block_sum(double v, double* sh) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NT / 32 ? sh[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  const double r = sh[0];
  __syncthreads();
  return r;
}

// f32 sums of x[0, cnt) by this thread (s1 += v, s2 += v*v); with KEEP,
// also a copy into xs[0, cnt). VEC: cnt is a multiple of the vector length
// and x, xs are 16-byte aligned.
template <typename T, bool VEC, int NT, bool KEEP>
__device__ __forceinline__ void sum_range(const T* __restrict__ x, int cnt,
                                          T* xs, float& s1, float& s2) {
  if constexpr (VEC) {
    constexpr int V = kVec<T>;
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    const int nv = cnt / V;
    for (int i0 = threadIdx.x; i0 < nv; i0 += NT * kUnroll) {
      uint4 u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (i0 + k * NT < nv) u[k] = src[i0 + k * NT];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (i0 + k * NT >= nv) break;
        if (KEEP) dst[i0 + k * NT] = u[k];
        float f[V];
        unpack<T>(u[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s1 += f[e];
          s2 += f[e] * f[e];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < cnt; i += NT) {
      const T v = x[i];
      if (KEEP) xs[i] = v;
      const float f = matry::to_f32(v);
      s1 += f;
      s2 += f * f;
    }
  }
}

// out[i] = relu((src[i] - mean) * rstd * gamma[c] + beta[c]) for i in
// [0, cnt), element lo + i of the example being in channel c =
// (lo + i) / hw. src is global or shared memory.
template <typename T, bool VEC, int NT>
__device__ __forceinline__ void apply_range(
    const T* src, T* __restrict__ out, int lo, int cnt, int hw, float mean,
    float rstd, const float* __restrict__ gamma,
    const float* __restrict__ beta, int relu) {
  constexpr int V = VEC ? kVec<T> : 1;
  for (int i = threadIdx.x; i < cnt / V; i += NT) {
    const int e0 = lo + i * V;
    int c = e0 / hw;
    int r = e0 - c * hw;
    float f[V];
    if constexpr (VEC)
      unpack<T>(reinterpret_cast<const uint4*>(src)[i], f);
    else
      f[0] = matry::to_f32(src[i]);
    float gc = gamma[c], bc = beta[c];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float y = (f[k] - mean) * rstd * gc + bc;
      if (relu && y < 0.f) y = 0.f;
      f[k] = y;
      if (k + 1 < V && ++r == hw) {
        r = 0;
        ++c;
        gc = gamma[c];
        bc = beta[c];
      }
    }
    if constexpr (VEC)
      reinterpret_cast<uint4*>(out)[i] = pack<T>(f);
    else
      out[i] = matry::from_f32<T>(f[0]);
  }
}

// (mean, rstd) from the f64 (s1, s2) partials p[0 .. 2*nblk), folded in
// the same fixed order by every block.
template <int NT>
__device__ __forceinline__ void fold(const double* p, int nblk, long long n,
                                     float eps, double* sh, float& mean,
                                     float& rstd) {
  double t1 = 0.0, t2 = 0.0;
  for (int i = threadIdx.x; i < nblk; i += NT) {
    t1 += __ldcg(p + 2 * i);
    t2 += __ldcg(p + 2 * i + 1);
  }
  t1 = block_sum<NT>(t1, sh);
  t2 = block_sum<NT>(t2, sh);
  const double mean_d = t1 / (double)n;
  double var_d = t2 / (double)n - mean_d * mean_d;
  if (var_d < 0.0) var_d = 0.0;
  mean = (float)mean_d;
  rstd = rsqrtf((float)var_d + eps);
}

// One example (B = 1); block k takes elements [k*share, (k+1)*share).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kNTChip)
    ln_onchip(const T* __restrict__ x, double* __restrict__ partial,
              const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ out, int n,
              int hw, int share, float eps, int relu) {
  extern __shared__ __align__(16) unsigned char ln_smem[];
  T* xs = reinterpret_cast<T*>(ln_smem);
  __shared__ double sh[kNTChip / 32];
  const int lo = blockIdx.x * share;
  const int cnt = lo < n ? min(share, n - lo) : 0;
  float s1 = 0.f, s2 = 0.f;
  sum_range<T, VEC, kNTChip, true>(x + lo, cnt, xs, s1, s2);
  const double t1 = block_sum<kNTChip>((double)s1, sh);
  const double t2 = block_sum<kNTChip>((double)s2, sh);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = t1;
    partial[2 * blockIdx.x + 1] = t2;
  }
  cg::this_grid().sync();
  float mean, rstd;
  fold<kNTChip>(partial, gridDim.x, n, eps, sh, mean, rstd);
  apply_range<T, VEC, kNTChip>(xs, out + lo, lo, cnt, hw, mean, rstd, gamma,
                               beta, relu);
}

// grid (nblk, B): block k of example b sums elements [k*chunk, (k+1)*chunk).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kNTTwo)
    ln_stats(const T* __restrict__ x, double* __restrict__ partial, int n,
             int chunk) {
  __shared__ double sh[kNTTwo / 32];
  const int b = blockIdx.y;
  const int lo = blockIdx.x * chunk;
  const int cnt = lo < n ? min(chunk, n - lo) : 0;
  float s1 = 0.f, s2 = 0.f;
  sum_range<T, VEC, kNTTwo, false>(x + (long long)b * n + lo, cnt, nullptr,
                                   s1, s2);
  const double t1 = block_sum<kNTTwo>((double)s1, sh);
  const double t2 = block_sum<kNTTwo>((double)s2, sh);
  if (threadIdx.x == 0) {
    double* pb = partial + ((long long)b * gridDim.x + blockIdx.x) * 2;
    pb[0] = t1;
    pb[1] = t2;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kNTTwo)
    ln_apply(const T* __restrict__ x, const double* __restrict__ partial,
             const float* __restrict__ gamma,
             const float* __restrict__ beta, T* __restrict__ out, int n,
             int hw, int chunk, float eps, int relu) {
  __shared__ double sh[kNTTwo / 32];
  const int b = blockIdx.y;
  float mean, rstd;
  fold<kNTTwo>(partial + (long long)b * gridDim.x * 2, gridDim.x, n, eps, sh,
               mean, rstd);
  const int lo = blockIdx.x * chunk;
  const int cnt = lo < n ? min(chunk, n - lo) : 0;
  const long long off = (long long)b * n + lo;
  apply_range<T, VEC, kNTTwo>(x + off, out + off, lo, cnt, hw, mean, rstd,
                              gamma, beta, relu);
}

template <typename T, bool VEC>
cudaError_t launch_onchip(const void* x, void* partial, const void* gamma,
                          const void* beta, void* out, int n, int hw,
                          int nblk, int share, float eps, int relu,
                          cudaStream_t s) {
  auto kern = ln_onchip<T, VEC>;
  static int max_dyn = -1;  // once per instantiation
  if (max_dyn < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    max_dyn = optin - (int)fa.sharedSizeBytes;
  }
  const size_t smem = (size_t)share * sizeof(T);
  if (smem > (size_t)max_dyn) return cudaErrorInvalidValue;
  const T* xp = (const T*)x;
  double* pp = (double*)partial;
  const float* gp = (const float*)gamma;
  const float* bp = (const float*)beta;
  T* op = (T*)out;
  void* args[] = {&xp, &pp, &gp, &bp, &op, &n, &hw, &share, &eps, &relu};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(nblk),
                                     dim3(kNTChip), args, smem, s);
}

template <typename T, bool VEC>
cudaError_t launch_two_pass(const void* x, void* partial, const void* gamma,
                            const void* beta, void* out, int B, int n,
                            int hw, int nblk, int chunk, float eps, int relu,
                            cudaStream_t s) {
  const dim3 grid(nblk, B);
  ln_stats<T, VEC><<<grid, kNTTwo, 0, s>>>((const T*)x, (double*)partial, n,
                                           chunk);
  ln_apply<T, VEC><<<grid, kNTTwo, 0, s>>>(
      (const T*)x, (const double*)partial, (const float*)gamma,
      (const float*)beta, (T*)out, n, hw, chunk, eps, relu);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, void* partial, const void* gamma,
                   const void* beta, void* out, int B, int n, int hw,
                   int nblk, int share, float eps, int relu, int onchip,
                   cudaStream_t s) {
  constexpr int V = kVec<T>;
  const bool vec = n % V == 0 && share % V == 0 &&
                   ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0;
  if (onchip)
    return vec ? launch_onchip<T, true>(x, partial, gamma, beta, out, n, hw,
                                        nblk, share, eps, relu, s)
               : launch_onchip<T, false>(x, partial, gamma, beta, out, n, hw,
                                         nblk, share, eps, relu, s);
  return vec ? launch_two_pass<T, true>(x, partial, gamma, beta, out, B, n,
                                        hw, nblk, share, eps, relu, s)
             : launch_two_pass<T, false>(x, partial, gamma, beta, out, B, n,
                                         hw, nblk, share, eps, relu, s);
}

}  // namespace

// x, out [B, C, hw] (f32 if is_f32, else bf16); gamma, beta f32 [C];
// partial f64 scratch [B, nblk, 2]. onchip: the on-chip form (B == 1; nblk
// co-resident blocks of `share` elements each); else the two-pass form
// (grid (nblk, B), chunks of `share` elements). nblk * share must cover
// C * hw and be below 2^31.
extern "C" int matry_layernorm(const void* x, void* partial,
                               const void* gamma, const void* beta,
                               void* out, int B, int C, int hw, int nblk,
                               int share, float eps, int relu, int is_f32,
                               int onchip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)C * hw;
  if (B < 1 || n < 1 || nblk < 1 || share < 1 ||
      (long long)nblk * share < n || (long long)nblk * share >= (1LL << 31) ||
      (onchip && B != 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_f32 ? launch<float>(x, partial, gamma, beta, out, B, (int)n, hw,
                             nblk, share, eps, relu, onchip, s)
             : launch<__nv_bfloat16>(x, partial, gamma, beta, out, B, (int)n,
                                     hw, nblk, share, eps, relu, onchip, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
