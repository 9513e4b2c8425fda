// Lowering probes: the card's answers to four questions the JAX package
// put to the TPU's kernel compiler. No path of the system runs them; the
// probe tool (matryodshka_tpu_torch/tools/probes.py) does.
//
// Replaces:
//   K8a tools/r3_hw_session.py:61 mosaic_trig_probe (pallas_call :79):
//       atan2(x, sqrt(x*x + 1)) inside a kernel, [8, 128] f32. It gated
//       moving intersect_sphere's uv projection into the render kernel.
//   K8b tools/r4_hw_session.py:534 bf16_roll_probe (pallas_call :549):
//       pltpu.roll by +1 along the last axis of [8, 256] rows, f32 and
//       bf16.
//   K8c tools/exp_dynroll.py:17 main (pallas_call :33): the same roll of
//       [8, 640] f32 rows by a shift read at run time (an SMEM scalar),
//       s = 5 and 123.
//   K9  tests/test_pallas_sweep.py:70 test_aligned_shift_bit_exact, inner
//       kern (pallas_call :93): a circular LEFT shift of [3, 1, 256] f32
//       rows by s, through the row doubled in VMEM scratch, a 128-aligned
//       window and _circ_shift_left's barrel of lane rotates
//       (matryodshka_tpu/ops/pallas_sweep.py:155).
//
// matry_probe_trig: one thread per element, atan2f(x, sqrtf(fmaf(x, x, 1))).
// The build (ops/_build.py NVCC_FLAGS) has no --use_fast_math, so atan2f is
// CUDA's precise one (2 ulp at most) and sqrtf is correctly rounded; keep it
// so, or the probe measures the approximate intrinsics instead.
//
// matry_probe_roll: out[r, j] = x[r, (j - s) mod W] (jnp.roll along the
// last axis), one thread per element, for f32 and bf16 rows; s is a kernel
// argument, normalised to [0, W) as ((s % W) + W) % W, so a negative shift
// or one of W or more is defined. One kernel answers K8b and K8c.
//
// matry_probe_window_shift: out[r, j] = x[r, (j + s) mod W], one block per
// row: the block stages the row twice into shared memory, as K9's doubled
// scratch row, and reads W values from offset s (normalised as above). The
// 128-aligned window and the barrel of rotates are Mosaic workarounds (its
// lane-dim dynamic slices start only at multiples of 128); shared memory
// takes any offset, so what carries over is the question: a circular row
// shift through on-chip memory, by a shift given at run time. Bit-exact by
// construction: no arithmetic touches a value.
//
// Bound: the bytes, each input read once and each output written once
// (8 KiB for K8a, 16 KiB for K8b f32, 40 KiB for K8c, 6 KiB for K9): a few
// nanoseconds at 3.35 TB/s, so every launch takes the launch latency. The
// design is the simplest correct one; no tiling would show at these sizes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void trig_kernel(const float* __restrict__ x,
                            float* __restrict__ out, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float v = x[idx];
  out[idx] = atan2f(v, sqrtf(fmaf(v, v, 1.f)));
}

template <typename T>
__global__ void roll_kernel(const T* __restrict__ x, T* __restrict__ out,
                            long long n, int W, int s) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long row = idx / W;
  const int j = (int)(idx - row * W);
  out[idx] = x[row * W + (j >= s ? j - s : j - s + W)];
}

__global__ void window_shift_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int W, int s) {
  extern __shared__ float row2[];  // the row, twice: [0, 2W)
  const long long base = (long long)blockIdx.x * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const float v = x[base + j];
    row2[j] = v;
    row2[W + j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) out[base + j] = row2[j + s];
}

int normalise(int shift, int W) { return ((shift % W) + W) % W; }

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int matry_probe_trig(const void* x, void* out, long long n,
                                void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  trig_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int matry_probe_roll(const void* x, void* out, long long rows,
                                int width, int shift, int bf16,
                                void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  const long long n = rows * width;
  const int s = normalise(shift, width);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    roll_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, n, width, s);
  else
    roll_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
        (const float*)x, (float*)out, n, width, s);
  return (int)cudaGetLastError();
}

extern "C" int matry_probe_window_shift(const void* x, void* out, int rows,
                                        int width, int shift, void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)width * sizeof(float);
  if (smem > 48 * 1024) {
    // above the default 48 KB a block asks for its shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        window_shift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = width < kThreads ? (width + 31) / 32 * 32 : kThreads;
  window_shift_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, width, normalise(shift, width));
  return (int)cudaGetLastError();
}
