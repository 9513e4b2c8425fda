// Implicit-GEMM convolution for every conv stage of the MSI U-Net.
//
// Replaces the conv block of matryodshka_tpu/ops/pallas_net.py:_build_kernel
// (K2: the 3x3 wrap convs, stride-2 downs, rate-2 dilated convs, the three
// subpixel deconvs and the 1x1 tanh head); the layer norm is
// layernorm.cu. One launch is one layer: M = Cout, N = output pixels,
// K = KH*KW*Cin, with the input patch gathered on the fly.
//
// Input taps: input row iy = oy*stride + kh*dil - pad_h is zero outside
// [0, Hi) (the vertical zero padding of wrap_pad) and input column
// ix = ox*stride + kw*dil - pad_w wraps mod Wi (the horizontal ERP wrap).
// npar == 4 is the transposed 4x4/2 conv in its subpixel form
// (models/unet.py FusedDeconvCrop): blockIdx.z carries the output parity
// (da, db), each parity is a 2x2 conv with pads (pad_h - da, pad_w - db),
// and the epilogue writes output pixel (2*oy + da, 2*ox + db), so the
// interleave costs nothing.
//
// Bound: compute (about 293 GFLOP per 640x320 frame). This first kernel
// runs on the CUDA cores in f32 FMA: a 64 (Cout) x 128 (pixel) tile per
// block, K in steps of 16 staged in shared memory, and a 4 x 8 register
// tile per thread, so each shared-memory operand is reused 4-8 times.
// Operands are bf16 (or f32) in device memory and f32 in shared memory;
// accumulation is f32; bias (and tanh for the head) are applied in the
// epilogue before the single rounding to the output type. The tensor
// cores (mma/wgmma) are the next step for this kernel.
//
// Weights are packed [npar, K, Cout] with k = (kh*KW + kw)*Cin + c
// (ops/conv.py:pack_conv / pack_deconv).

#include "common.cuh"

namespace {

constexpr int BM = 64;   // output channels per block
constexpr int BN = 128;  // output pixels per block
constexpr int BK = 16;   // reduction step
constexpr int TM = 4;    // channels per thread
constexpr int TN = 8;    // pixels per thread

struct ConvArgs {
  int B, Cin, Hi, Wi, Cout, Ho, Wo, KH, KW, stride, dil, pad_h, pad_w, npar,
      out_h, out_w, act;
};

template <typename TI, typename TO>
__global__ void __launch_bounds__(256)
    conv_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                const float* __restrict__ bias, TO* __restrict__ out,
                ConvArgs a) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int b = z / a.npar;
  const int par = z - b * a.npar;
  const int da = par >> 1, db = par & 1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int K = a.KH * a.KW * a.Cin;
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
    int tap = k / a.Cin;
    int c = k - tap * a.Cin;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v = 0.f;
      if (k < K && pix_ok) {
        const int kh = tap / a.KW;
        const int kw = tap - kh * a.KW;
        const int iy = iy0 + kh * a.dil;
        if (iy >= 0 && iy < a.Hi) {
          const int ix = matry::wrap(ix0 + kw * a.dil, a.Wi);
          v = matry::to_f32(xb[((long long)c * a.Hi + iy) * a.Wi + ix]);
        }
      }
      Bs[bk + q][bn] = v;
      ++k;
      if (++c == a.Cin) {
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
      om[(long long)(py * ostr + da) * a.out_w + px * ostr + db] =
          matry::from_f32<TO>(v);
    }
  }
}

template <typename TI, typename TO>
void launch(const void* x, const void* w, const void* bias, void* out,
            const ConvArgs& a, cudaStream_t s) {
  dim3 grid((a.Ho * a.Wo + BN - 1) / BN, (a.Cout + BM - 1) / BM,
            a.B * a.npar);
  conv_kernel<TI, TO><<<grid, 256, 0, s>>>(
      (const TI*)x, (const TI*)w, (const float*)bias, (TO*)out, a);
}

}  // namespace

extern "C" int matry_conv(const void* x, const void* w, const void* bias,
                          void* out, int B, int Cin, int Hi, int Wi,
                          int Cout, int Ho, int Wo, int KH, int KW,
                          int stride, int dil, int pad_h, int pad_w,
                          int npar, int out_h, int out_w, int act,
                          int in_f32, int out_f32, void* stream) {
  const ConvArgs a{B,  Cin,    Hi,  Wi,    Cout,  Ho,    Wo,
                   KH, KW,     stride, dil, pad_h, pad_w, npar,
                   out_h, out_w, act};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_f32) {
    if (out_f32)
      launch<float, float>(x, w, bias, out, a, s);
    else
      launch<float, __nv_bfloat16>(x, w, bias, out, a, s);
  } else {
    if (out_f32)
      launch<__nv_bfloat16, float>(x, w, bias, out, a, s);
    else
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, out, a, s);
  }
  return (int)cudaGetLastError();
}
