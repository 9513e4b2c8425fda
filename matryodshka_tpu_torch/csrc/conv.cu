// Implicit-GEMM convolution for every conv stage of the MSI U-Net.
//
// Replaces the conv block of matryodshka_tpu/ops/pallas_net.py:_build_kernel
// (K2, both variants: the 3x3 convs, stride-2 downs, rate-2 dilated convs,
// the three 4x4 stride-2 transposed convs and the 1x1 tanh head); the
// layer norm is layernorm.cu. One launch is one layer: M = Cout,
// N = output pixels, K = KH*KW*Cin', with the input patch gathered on the
// fly.
//
// Input taps: input row iy = oy*stride + kh*dil - pad_h is zero outside
// [0, Hi) (vertical zero padding; the high side needs no argument, so a
// stride-2 SAME down runs with pad_h = 0) and input column
// ix = ox*stride + kw*dil - pad_w
//   * wraps mod Wi in kWrap mode (the wrap net's horizontal ERP wrap);
//   * reads zero outside [0, Wi) in kZero and kCoord mode (the coord net's
//     SAME padding).
// kCoord adds the coord net's |sin(lat)| channel as input channel Cin
// (Cin' = Cin + 1, its weights last in each tap): the patch loader reads
// coord[iy], an f32 value per input row, where it would read channel Cin
// of x, and zero where (iy, ix) falls in the padding, as the zero-padded
// concatenated input would hold. No Cin+1-channel copy of x is made.
// npar == 4 is the transposed 4x4/2 conv in its subpixel form
// (models/unet.py FusedDeconvCrop; the coord net's SAME ConvTranspose has
// the same index map, with zero padding): blockIdx.z carries the output
// parity (da, db), each parity is a 2x2 conv with pads (pad_h - da,
// pad_w - db), and the epilogue writes output pixel (2*oy + da, 2*ox + db),
// so the interleave costs nothing.
//
// Bound: compute (301.2 GFLOP per 640x320 frame for the wrap net, 302.4
// for the coord net). This first kernel runs on the CUDA cores in f32 FMA:
// a 64 (Cout) x 128 (pixel) tile per block, K in steps of 16 staged in
// shared memory, and a 4 x 8 register tile per thread, so each
// shared-memory operand is reused 4-8 times. Operands are bf16 (or f32) in
// device memory and f32 in shared memory; accumulation is f32; bias (and
// tanh for the head) are applied in the epilogue before the single
// rounding to the output type. The tensor cores (mma/wgmma) are the next
// step for this kernel.
//
// Weights are packed [npar, K, Cout] with k = (kh*KW + kw)*Cin' + c
// (ops/conv.py:pack_conv / pack_deconv).
//
// The same kernel is the per-layer 3x3 wrap conv of
// matryodshka_tpu/ops/pallas_conv.py (K7: _conv_kernel, _conv_kernel_dma,
// _conv_ln_kernel; ops/wrap_conv.py) in kWrap mode, stride 1, npar 1.
// K7c's layer-norm statistics are the STATS epilogue: after the bias and
// the rounding to the output type, each block sums y and y^2 of its
// ROUNDED outputs in f32 (as _conv_ln_kernel:368-370 does) and writes one
// (s1, s2) partial per (sample, block); stats_fold then sums each sample's
// partials in a fixed order in f64. No atomics, so the sums are the same
// on every run, and f64 keeps the layer norm's var = s2/n - mean^2 from
// cancelling when mean^2 >> var.

#include "common.cuh"

namespace {

constexpr int BM = 64;   // output channels per block
constexpr int BN = 128;  // output pixels per block
constexpr int BK = 16;   // reduction step
constexpr int TM = 4;    // channels per thread
constexpr int TN = 8;    // pixels per thread

// Horizontal padding and input channels (see the note above).
constexpr int kWrap = 0;   // columns wrap mod Wi
constexpr int kZero = 1;   // columns outside [0, Wi) read zero
constexpr int kCoord = 2;  // kZero plus the coord channel as channel Cin

struct ConvArgs {
  int B, Cin, Hi, Wi, Cout, Ho, Wo, KH, KW, stride, dil, pad_h, pad_w, npar,
      out_h, out_w, act;
};

template <typename TI, typename TO, int MODE, bool STATS>
__global__ void __launch_bounds__(256)
    conv_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ coord, TO* __restrict__ out,
                float* __restrict__ partial, ConvArgs a) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[2][256 / 32];

  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int b = z / a.npar;
  const int par = z - b * a.npar;
  const int da = par >> 1, db = par & 1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int Ck = a.Cin + (MODE == kCoord);  // channels per tap in K
  const int K = a.KH * a.KW * Ck;
  const int npix = a.Ho * a.Wo;

  // B (input patch) loader: one pixel column, 8 consecutive k rows.
  const int bn = tid & (BN - 1);
  const int bk = (tid >> 7) * 8;
  const int pix = n0 + bn;
  const bool pix_ok = pix < npix;
  const int oy = pix_ok ? pix / a.Wo : 0;
  const int ox = pix_ok ? pix - oy * a.Wo : 0;
  const int iy0 = oy * a.stride - (a.pad_h - da);
  const int ix0 = ox * a.stride - (a.pad_w - db);
  const TI* xb = x + (long long)b * a.Cin * a.Hi * a.Wi;

  // A (weight) loader: one output channel, 4 consecutive k rows.
  const int am = tid & (BM - 1);
  const int ak = (tid >> 6) * 4;
  const TI* wp = w + (long long)par * K * a.Cout;

  const int tx = tid & 15;  // pixel group: tx * TN
  const int ty = tid >> 4;  // channel group: ty * TM
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ak + q;
      const int m = m0 + am;
      As[ak + q][am] = (k < K && m < a.Cout)
                           ? matry::to_f32(wp[(long long)k * a.Cout + m])
                           : 0.f;
    }
    int k = k0 + bk;
    int tap = k / Ck;
    int c = k - tap * Ck;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v = 0.f;
      if (k < K && pix_ok) {
        const int kh = tap / a.KW;
        const int kw = tap - kh * a.KW;
        const int iy = iy0 + kh * a.dil;
        if (iy >= 0 && iy < a.Hi) {
          if (MODE == kWrap) {
            const int ix = matry::wrap(ix0 + kw * a.dil, a.Wi);
            v = matry::to_f32(xb[((long long)c * a.Hi + iy) * a.Wi + ix]);
          } else {
            const int ix = ix0 + kw * a.dil;
            if (ix >= 0 && ix < a.Wi)
              v = (MODE == kCoord && c == a.Cin)
                      ? coord[iy]
                      : matry::to_f32(
                            xb[((long long)c * a.Hi + iy) * a.Wi + ix]);
          }
        }
      }
      Bs[bk + q][bn] = v;
      ++k;
      if (++c == Ck) {
        c = 0;
        ++tap;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int ostr = a.npar == 4 ? 2 : 1;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= a.Cout) continue;
    const float bv = bias[m];
    TO* om = out + ((long long)b * a.Cout + m) * a.out_h * a.out_w;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int p = n0 + tx * TN + j;
      if (p >= npix) continue;
      const int py = p / a.Wo;
      const int px = p - py * a.Wo;
      float v = acc[i][j] + bv;
      if (a.act == 1) v = tanhf(v);
      const TO q = matry::from_f32<TO>(v);
      om[(long long)(py * ostr + da) * a.out_w + px * ostr + db] = q;
      if (STATS) {
        const float r = matry::to_f32(q);
        s1 += r;
        s2 += r * r;
      }
    }
  }
  if (STATS) {
    // Block sum in a fixed order: butterfly within each warp, then the
    // eight warp sums in order by thread 0.
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    if (tid == 0) {
      float t1 = 0.f, t2 = 0.f;
      for (int i = 0; i < 256 / 32; ++i) {
        t1 += red[0][i];
        t2 += red[1][i];
      }
      float* pb = partial +
                  (((long long)b * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x) * 2;
      pb[0] = t1;
      pb[1] = t2;
    }
  }
}

// One block per sample: each thread sums a strided set of the sample's
// nblk partials in f64, in order, then a fixed tree over the block.
__global__ void __launch_bounds__(256)
    stats_fold(const float* __restrict__ partial, double* __restrict__ stats,
               int nblk) {
  __shared__ double sh[2][256];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* pb = partial + (long long)b * nblk * 2;
  double t1 = 0.0, t2 = 0.0;
  for (int i = tid; i < nblk; i += 256) {
    t1 += pb[2 * i];
    t2 += pb[2 * i + 1];
  }
  sh[0][tid] = t1;
  sh[1][tid] = t2;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (tid < s) {
      sh[0][tid] += sh[0][tid + s];
      sh[1][tid] += sh[1][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    stats[2 * b] = sh[0][0];
    stats[2 * b + 1] = sh[1][0];
  }
}

dim3 grid_of(const ConvArgs& a) {
  return dim3((a.Ho * a.Wo + BN - 1) / BN, (a.Cout + BM - 1) / BM,
              a.B * a.npar);
}

template <typename TI, typename TO, int MODE, bool STATS>
void launch(const void* x, const void* w, const void* bias,
            const void* coord, void* out, void* partial, void* stats,
            const ConvArgs& a, cudaStream_t s) {
  const dim3 grid = grid_of(a);
  conv_kernel<TI, TO, MODE, STATS><<<grid, 256, 0, s>>>(
      (const TI*)x, (const TI*)w, (const float*)bias, (const float*)coord,
      (TO*)out, (float*)partial, a);
  if (STATS)
    stats_fold<<<a.B, 256, 0, s>>>((const float*)partial, (double*)stats,
                                   grid.x * grid.y);
}

template <typename TI, typename TO>
void launch_mode(const void* x, const void* w, const void* bias,
                 const void* coord, void* out, void* partial, void* stats,
                 const ConvArgs& a, int mode, cudaStream_t s) {
  if (partial)
    launch<TI, TO, kWrap, true>(x, w, bias, coord, out, partial, stats, a,
                                s);
  else if (mode == kCoord)
    launch<TI, TO, kCoord, false>(x, w, bias, coord, out, partial, stats, a,
                                  s);
  else if (mode == kZero)
    launch<TI, TO, kZero, false>(x, w, bias, coord, out, partial, stats, a,
                                 s);
  else
    launch<TI, TO, kWrap, false>(x, w, bias, coord, out, partial, stats, a,
                                 s);
}

}  // namespace

// Blocks per sample of a stats launch (ho_wo output pixels, cout
// channels): the length of each sample's row of partials.
extern "C" int matry_conv_stats_blocks(int ho_wo, int cout) {
  const dim3 g = grid_of(ConvArgs{1, 0, 0, 0, cout, ho_wo, 1, 0, 0, 0, 0, 0,
                                  0, 1, 0, 0, 0});
  return (int)(g.x * g.y);
}

// coord: null, or the coord channel's f32 value per input row [Hi] (then
// zero_w must be set); zero_w: zero horizontal padding, else wrap.
// partial/stats: null, or (wrap mode, npar 1 only) the STATS epilogue's
// f32 scratch [B, matry_conv_stats_blocks(Ho*Wo, Cout), 2] and its f64
// result [B, 2] = (sum y, sum y^2) per sample.
extern "C" int matry_conv(const void* x, const void* w, const void* bias,
                          const void* coord, void* out, int B, int Cin,
                          int Hi, int Wi, int Cout, int Ho, int Wo, int KH,
                          int KW, int stride, int dil, int pad_h, int pad_w,
                          int npar, int out_h, int out_w, int act,
                          int in_f32, int out_f32, int zero_w, void* partial,
                          void* stats, void* stream) {
  const ConvArgs a{B,  Cin,    Hi,  Wi,    Cout,  Ho,    Wo,
                   KH, KW,     stride, dil, pad_h, pad_w, npar,
                   out_h, out_w, act};
  cudaStream_t s = (cudaStream_t)stream;
  if (coord && !zero_w) return (int)cudaErrorInvalidValue;
  if ((partial != nullptr) != (stats != nullptr) ||
      (partial && (zero_w || npar != 1)))
    return (int)cudaErrorInvalidValue;
  const int mode = coord ? kCoord : (zero_w ? kZero : kWrap);
  if (in_f32) {
    if (out_f32)
      launch_mode<float, float>(x, w, bias, coord, out, partial, stats, a,
                                mode, s);
    else
      launch_mode<float, __nv_bfloat16>(x, w, bias, coord, out, partial,
                                        stats, a, mode, s);
  } else {
    if (out_f32)
      launch_mode<__nv_bfloat16, float>(x, w, bias, coord, out, partial,
                                        stats, a, mode, s);
    else
      launch_mode<__nv_bfloat16, __nv_bfloat16>(x, w, bias, coord, out,
                                                partial, stats, a, mode, s);
  }
  return (int)cudaGetLastError();
}
