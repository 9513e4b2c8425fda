// Implicit-GEMM convolution for every conv stage of the MSI U-Net.
//
// Replaces the conv block of matryodshka_tpu/ops/pallas_net.py:_build_kernel
// (K2, both variants: the 3x3 convs, stride-2 downs, rate-2 dilated convs,
// the three 4x4 stride-2 transposed convs and the 1x1 tanh head) and the
// three kernels of matryodshka_tpu/ops/pallas_conv.py (K7: _conv_kernel,
// _conv_kernel_dma, _conv_ln_kernel; ops/wrap_conv.py), which are its wrap
// mode at stride 1. The layer norm is layernorm.cu. One launch is one
// layer: M = Cout, N = output pixels, K = KH*KW*Cin', with the input patch
// gathered on the fly.
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
// of x (rounded to bf16 on the bf16 path, as the bf16 net appends it), and
// zero where (iy, ix) falls in the padding. No Cin+1-channel copy of x is
// made. npar == 4 is the transposed 4x4/2 conv in its subpixel form
// (models/unet.py FusedDeconvCrop; the coord net's SAME ConvTranspose has
// the same index map, with zero padding): blockIdx.z carries the output
// parity (da, db), each parity is a 2x2 conv with pads (pad_h - da,
// pad_w - db), and the epilogue writes output pixel (2*oy + da, 2*ox + db).
// npar == 4 with KH == KW == 3 is the smoothed net's upsampling conv
// (nearest 2x, then a 4x4 conv padded (1, 2); JAX models/unet.py:306-322)
// folded onto the un-upsampled input: parity d of an axis reads input
// offsets -1..1 with the 4x4 taps summed as {t0}, {t1, t2}, {t3} (d = 0) or
// offsets 0..1 as {t0, t1}, {t2, t3} (d = 1), so parity (da, db) is a
// (3 - da) x (3 - db) conv with the same pads (pad_h - da, pad_w - db) and
// the same output map: 25 taps for the four parities where the upsampled
// form has 64 (par_taps; ops/conv.py:pack_smoothed folds the weights, each
// parity's block padded to 9 taps).
//
// Bound: operations. 301.2 GFLOP per 640x320 frame for the wrap net (302.4
// for the coord net), 0.3045 ms at the H100's 989 TFLOP/s in bf16; the
// bytes (weights, activations) are a few percent of that time. A smoothed
// net's folded upsampling stages run 125.8 GFLOP where the transposed
// ones run 80.5: 346.5 GFLOP a frame (347.7 coord).
//
// bf16 operands (conv_tc_kernel) run on the tensor cores:
//   1. mma.sync.m16n8k16 (bf16 in, f32 accumulate); each warp owns a
//      32 (Cout) x 32 (pixel) tile, fragments loaded with ldmatrix (the
//      cp.async / ldmatrix / mma helpers are mma.cuh's, shared with
//      conv_wgrad.cu).
//   2. Operands stay bf16 in shared memory: the weight slab [BK][BM]
//      (Cout contiguous, read with ldmatrix.trans) and the patch tile
//      [BN][BK] (channels contiguous per pixel, read with plain ldmatrix,
//      so each lane's row address is its own pixel's). Rows are padded by
//      16 bytes so ldmatrix's eight rows fall in distinct banks.
//   3. A ring of STAGES = 3 k-blocks in dynamic shared memory: the weight
//      slab arrives by 16-byte cp.async STAGES - 1 blocks ahead; the patch
//      of the block STAGES - 1 ahead is loaded into registers before the
//      current block's mma and stored after it, so global latency hides
//      behind the math. One __syncthreads per k-block.
//   4. The gather works per k-block, not per element: a k-block is BK = 32
//      channels of ONE tap (each tap's Cin' is cut into ceil(Cin'/32)
//      blocks; the rows past Cin' read zero weights and zero patch), so a
//      thread computes its pixel's (iy, ix), wrap and bounds once per
//      k-block and then loads 16 channels at a stride of Hi*Wi, lanes on
//      consecutive pixels, and stores them to shared memory as two 16-byte
//      words. The k-blocks run tap-inner (all KH*KW taps of a channel
//      chunk, then the next chunk), so the 9x re-read of a 3x3 conv's
//      input hits the chunk's few KB of input rows in L1, not L2. The coord channel and ragged Cin' (193, 65, ...) take the
//      checked form of the same loop; weights of a Cout that is not a
//      multiple of 8 (the 67- and 99-channel heads) a masked scalar load.
//   5. Two tiles, chosen per launch by shape (tc_bn): 64 x 128 (256
//      threads) where that gives at least two blocks per SM, else 64 x 64
//      (128 threads), which gives conv4_1-4_3 (512 -> 512 at 3,200 px) 400
//      blocks. BM = 64 matches the four Cout = 64 layers at 204,800 px.
// The epilogue adds the bias (and tanh for the head) in f32 and rounds
// once to the output type.
//
// f32 operands (conv_f32_kernel, compute_dtype="float32") keep exact f32
// FMA on the CUDA cores: a 64 x 128 tile per block, K in steps of 16
// staged in shared memory, a 4 x 8 register tile per thread.
//
// Weights are packed [npar, K, Cout] with k = (kh*KW + kw)*Cin' + c
// (ops/conv.py:pack_conv / pack_deconv / pack_smoothed).
//
// K7c's layer-norm statistics are the STATS epilogue (wrap mode, npar 1):
// after the bias and the rounding to the output type, each thread sums y
// and y^2 of its ROUNDED outputs in f32 in a fixed order (as
// _conv_ln_kernel:368-370 does), warps combine by butterfly and the warp
// sums are added in order into one (s1, s2) partial per (sample, block);
// stats_fold then sums each sample's partials in a fixed order in f64. No
// atomics, so the sums are the same on every run, and f64 keeps the layer
// norm's var = s2/n - mean^2 from cancelling when mean^2 >> var.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// Horizontal padding and input channels (see the note above).
constexpr int kWrap = 0;   // columns wrap mod Wi
constexpr int kZero = 1;   // columns outside [0, Wi) read zero
constexpr int kCoord = 2;  // kZero plus the coord channel as channel Cin

// Taps along one axis of parity d's conv (d = da or db) in npar == 4 mode:
// the transposed conv's 2 (k == 2), the smoothed deconv's folded 3 - d
// (k == 3); k otherwise.
__host__ __device__ __forceinline__ int par_taps(int k, int npar, int d) {
  return npar == 4 && k == 3 ? k - d : k;
}

struct ConvArgs {
  int B, Cin, Hi, Wi, Cout, Ho, Wo, KH, KW, stride, dil, pad_h, pad_w, npar,
      out_h, out_w, act;
};

// ---------------------------------------------------------------------------
// The STATS epilogue's block sum, shared by both kernels: butterfly within
// each warp, then the warp sums in order by thread 0, one partial per block.
// ---------------------------------------------------------------------------
template <int NT>
__device__ __forceinline__ void block_stats(float s1, float s2,
                                            float (*red)[NT / 32],
                                            float* partial, int b) {
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < NT / 32; ++i) {
      t1 += red[0][i];
      t2 += red[1][i];
    }
    float* pb = partial + (((long long)b * gridDim.y + blockIdx.y) *
                               gridDim.x + blockIdx.x) * 2;
    pb[0] = t1;
    pb[1] = t2;
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

using namespace matry::mma;

constexpr int BM = 64;        // output channels per block
constexpr int BK = 32;        // channels of one tap per k-block
constexpr int WM = 32;        // warp tile: channels
constexpr int WN = 32;        // warp tile: pixels
constexpr int STAGES = 3;     // k-blocks in the shared-memory ring
constexpr int AST = BM + 8;   // weight slab row stride (elements), 144 B
constexpr int BST = BK + 8;   // patch tile row stride (elements), 80 B

template <int BN>
struct Tile {
  static constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  static constexpr int kA = BK * AST;  // elements per stage
  static constexpr int kB = BN * BST;
  static constexpr int kSmem = STAGES * (kA + kB) * 2;  // bytes
  // Blocks a SM must hold: three of the 64 x 128 tile (at most 85
  // registers a thread). Left to itself the compiler gives some
  // instantiations 98 registers, which leaves two blocks a SM; which ones
  // shifts with unrelated edits of the kernel.
  static constexpr int kMinBlocks = BN == 128 ? 3 : 1;
  // the patch loader: one pixel and 16 channels per thread
  static_assert(kThreads == 2 * BN, "two 16-channel groups per pixel");
};

// avec: the weight rows may be copied as 16-byte words (Cout % 8 == 0 and
// w 16-byte aligned), else the masked scalar path.
template <typename TO, int MODE, bool STATS, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads, Tile<BN>::kMinBlocks)
    conv_tc_kernel(const unsigned short* __restrict__ x,
                   const unsigned short* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ coord, TO* __restrict__ out,
                   float* __restrict__ partial, ConvArgs a, int avec) {
  using T = Tile<BN>;
  constexpr int NT = T::kThreads;
  extern __shared__ __align__(16) unsigned short smem[];
  unsigned short* As = smem;                     // [STAGES][BK][AST]
  unsigned short* Bs = smem + STAGES * T::kA;    // [STAGES][BN][BST]
  __shared__ float red[2][NT / 32];

  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int b = z / a.npar;
  const int par = z - b * a.npar;
  const int da = par >> 1, db = par & 1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int Ck = a.Cin + (MODE == kCoord);  // channels per tap in K
  const int KH = par_taps(a.KH, a.npar, da), KW = par_taps(a.KW, a.npar, db);
  const int nchunk = (Ck + BK - 1) / BK;
  const int nkb = KH * KW * nchunk;
  const int npix = a.Ho * a.Wo;
  const int HW = a.Hi * a.Wi;

  // patch loader: pixel n0 + nl, channels cg*16 .. +16 of each k-block
  const int nl = tid % BN;
  const int cg = tid / BN;
  const int pix = n0 + nl;
  const bool pix_ok = pix < npix;
  const int oy = pix_ok ? pix / a.Wo : 0;
  const int ox = pix_ok ? pix - oy * a.Wo : 0;
  const int iy0 = oy * a.stride - (a.pad_h - da);
  const int ix0 = ox * a.stride - (a.pad_w - db);
  const unsigned short* xb = x + (long long)b * a.Cin * HW;
  const unsigned short* wp = w + (long long)par * a.KH * a.KW * Ck * a.Cout;

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp % (BM / WM)) * WM;
  const int wn = (warp / (BM / WM)) * WN;

  auto load_a = [&](int stage, int tap, int c0) {
    unsigned short* dst = As + stage * T::kA;
    for (int id = tid; id < BK * BM / 8; id += NT) {
      const int kr = id >> 3, mc = (id & 7) * 8;
      const int c = c0 + kr, m = m0 + mc;
      const unsigned short* src = wp + (long long)(tap * Ck + c) * a.Cout + m;
      if (avec) {
        const bool ok = c < Ck && m < a.Cout;
        cp_async16(dst + kr * AST + mc, ok ? src : w, ok);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok0 = c < Ck && m + 2 * e < a.Cout;
          const bool ok1 = c < Ck && m + 2 * e + 1 < a.Cout;
          v[e] = (ok0 ? (uint32_t)src[2 * e] : 0u) |
                 ((ok1 ? (uint32_t)src[2 * e + 1] : 0u) << 16);
        }
        *reinterpret_cast<uint4*>(dst + kr * AST + mc) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  // v: the 16 channels as loaded; packed only in store_b, after the
  // k-block's mma, so the loads stay in flight across the math
  auto gather_b = [&](unsigned short* v, int tap, int c0) {
    const int kh = tap / KW;
    const int kw = tap - kh * KW;
    const int iy = iy0 + kh * a.dil;
    int ix = ix0 + kw * a.dil;
    bool ok = pix_ok && iy >= 0 && iy < a.Hi;
    if (MODE == kWrap)
      ix = matry::wrap(ix, a.Wi);
    else
      ok = ok && ix >= 0 && ix < a.Wi;
    const int cb = c0 + cg * 16;
    if (ok && cb + 16 <= a.Cin) {
      const unsigned short* src = xb + (long long)cb * HW + iy * a.Wi + ix;
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = src[(long long)j * HW];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = cb + j;
        unsigned short q = 0;
        if (ok && c < a.Cin)
          q = xb[(long long)c * HW + iy * a.Wi + ix];
        else if (MODE == kCoord && ok && c == a.Cin)
          q = bf16_bits(coord[iy]);
        v[j] = q;
      }
    }
  };

  auto store_b = [&](int stage, const unsigned short* v) {
    uint32_t r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[j] = (uint32_t)v[2 * j] | ((uint32_t)v[2 * j + 1] << 16);
    uint4* dst = reinterpret_cast<uint4*>(Bs + stage * T::kB + nl * BST +
                                          cg * 16);
    dst[0] = make_uint4(r[0], r[1], r[2], r[3]);
    dst[1] = make_uint4(r[4], r[5], r[6], r[7]);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto compute = [&](int stage) {
    const unsigned short* as = As + stage * T::kA;
    const unsigned short* bs = Bs + stage * T::kB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
      const int q = lane >> 3, r = lane & 7;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_trans(af[mt], as + (kk + r + (q >> 1) * 8) * AST + wm +
                                  mt * 16 + (q & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t t[4];
        ldsm_x4(t, bs + (wn + nt * 16 + r + (q >> 1) * 8) * BST + kk +
                       (q & 1) * 8);
        bf[2 * nt][0] = t[0];
        bf[2 * nt][1] = t[1];
        bf[2 * nt + 1][0] = t[2];
        bf[2 * nt + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  };

  // the ring: k-block j in stage j % STAGES. (ltap, lc0) is the next
  // k-block to load; taps run inside channel chunks, so a chunk's input
  // rows stay in L1 across its KH*KW taps.
  const int taps = KH * KW;
  int ltap = 0, lc0 = 0;
  auto advance = [&]() {
    if (++ltap == taps) {
      ltap = 0;
      lc0 += BK;
    }
  };
  unsigned short breg[16];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkb) {
      load_a(s, ltap, lc0);
      gather_b(breg, ltap, lc0);
      store_b(s, breg);
      advance();
    }
    cp_async_commit();
  }
  for (int j = 0; j < nkb; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // block j visible; block j-1's stage free
    const int ls = (j + STAGES - 1) % STAGES;
    const bool more = j + STAGES - 1 < nkb;
    if (more) {
      load_a(ls, ltap, lc0);
      gather_b(breg, ltap, lc0);
    }
    cp_async_commit();
    compute(j % STAGES);
    if (more) {
      store_b(ls, breg);
      advance();
    }
  }
  cp_async_wait<0>();

  // epilogue: C fragment rows are channels, columns pixels
  const bool sub = a.npar == 4;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mt * 16 + (lane >> 2) + h * 8;
      if (m >= a.Cout) continue;
      const float bv = bias[m];
      TO* om = out + ((long long)b * a.Cout + m) * a.out_h * a.out_w;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = n0 + wn + nt * 8 + (lane & 3) * 2 + e;
          if (p >= npix) continue;
          float v = acc[mt][nt][2 * h + e] + bv;
          if (a.act == 1) v = tanhf(v);
          const TO q = matry::from_f32<TO>(v);
          long long o = p;
          if (sub) {
            const int py = p / a.Wo;
            const int px = p - py * a.Wo;
            o = (long long)(2 * py + da) * a.out_w + 2 * px + db;
          }
          om[o] = q;
          if (STATS) {
            const float rq = matry::to_f32(q);
            s1 += rq;
            s2 += rq * rq;
          }
        }
    }
  if (STATS) block_stats<NT>(s1, s2, red, partial, b);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 operands: exact f32 FMA on the CUDA cores.
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BM = 64;   // output channels per block
constexpr int BN = 128;  // output pixels per block
constexpr int BK = 16;   // reduction step
constexpr int TM = 4;    // channels per thread
constexpr int TN = 8;    // pixels per thread

template <typename TO, int MODE, bool STATS>
__global__ void __launch_bounds__(256)
    conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
  const int KW = par_taps(a.KW, a.npar, db);
  const int K = par_taps(a.KH, a.npar, da) * KW * Ck;
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
  const float* xb = x + (long long)b * a.Cin * a.Hi * a.Wi;

  // A (weight) loader: one output channel, 4 consecutive k rows.
  const int am = tid & (BM - 1);
  const int ak = (tid >> 6) * 4;
  const float* wp = w + (long long)par * a.KH * a.KW * Ck * a.Cout;

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
      As[ak + q][am] =
          (k < K && m < a.Cout) ? wp[(long long)k * a.Cout + m] : 0.f;
    }
    int k = k0 + bk;
    int tap = k / Ck;
    int c = k - tap * Ck;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v = 0.f;
      if (k < K && pix_ok) {
        const int kh = tap / KW;
        const int kw = tap - kh * KW;
        const int iy = iy0 + kh * a.dil;
        if (iy >= 0 && iy < a.Hi) {
          if (MODE == kWrap) {
            const int ix = matry::wrap(ix0 + kw * a.dil, a.Wi);
            v = xb[((long long)c * a.Hi + iy) * a.Wi + ix];
          } else {
            const int ix = ix0 + kw * a.dil;
            if (ix >= 0 && ix < a.Wi)
              v = (MODE == kCoord && c == a.Cin)
                      ? coord[iy]
                      : xb[((long long)c * a.Hi + iy) * a.Wi + ix];
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
  if (STATS) block_stats<256>(s1, s2, red, partial, b);
}

}  // namespace f32

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

int cdiv(int a, int b) { return (a + b - 1) / b; }

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// The tensor-core kernel's pixel tile: 128 where 64 x 128 tiles give at
// least two blocks per SM, else 64.
int tc_bn(int B, int npar, int npix, int Cout) {
  const long long blocks =
      (long long)cdiv(npix, 128) * cdiv(Cout, tc::BM) * B * npar;
  return blocks >= 2LL * num_sms() ? 128 : 64;
}

void finish_stats(const ConvArgs& a, dim3 grid, void* partial, void* stats,
                  cudaStream_t s) {
  stats_fold<<<a.B, 256, 0, s>>>((const float*)partial, (double*)stats,
                                 grid.x * grid.y);
}

template <typename TO, int MODE, bool STATS, int BN>
void launch_tc_tile(const void* x, const void* w, const void* bias,
                    const void* coord, void* out, void* partial, void* stats,
                    const ConvArgs& a, cudaStream_t s) {
  using T = tc::Tile<BN>;
  auto kern = tc::conv_tc_kernel<TO, MODE, STATS, BN>;
  static bool attr = false;  // once per instantiation
  if (!attr) {
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem) != cudaSuccess)
      return;  // the error stays for cudaGetLastError
    attr = true;
  }
  const dim3 grid(cdiv(a.Ho * a.Wo, BN), cdiv(a.Cout, tc::BM), a.B * a.npar);
  const int avec = a.Cout % 8 == 0 && ((uintptr_t)w & 15) == 0;
  kern<<<grid, T::kThreads, T::kSmem, s>>>(
      (const unsigned short*)x, (const unsigned short*)w, (const float*)bias,
      (const float*)coord, (TO*)out, (float*)partial, a, avec);
  if (STATS) finish_stats(a, grid, partial, stats, s);
}

template <typename TO, int MODE, bool STATS>
void launch_tc(const void* x, const void* w, const void* bias,
               const void* coord, void* out, void* partial, void* stats,
               const ConvArgs& a, cudaStream_t s) {
  if (tc_bn(a.B, a.npar, a.Ho * a.Wo, a.Cout) == 128)
    launch_tc_tile<TO, MODE, STATS, 128>(x, w, bias, coord, out, partial,
                                         stats, a, s);
  else
    launch_tc_tile<TO, MODE, STATS, 64>(x, w, bias, coord, out, partial,
                                        stats, a, s);
}

template <typename TO, int MODE, bool STATS>
void launch_f32(const void* x, const void* w, const void* bias,
                const void* coord, void* out, void* partial, void* stats,
                const ConvArgs& a, cudaStream_t s) {
  const dim3 grid(cdiv(a.Ho * a.Wo, f32::BN), cdiv(a.Cout, f32::BM),
                  a.B * a.npar);
  f32::conv_f32_kernel<TO, MODE, STATS><<<grid, 256, 0, s>>>(
      (const float*)x, (const float*)w, (const float*)bias,
      (const float*)coord, (TO*)out, (float*)partial, a);
  if (STATS) finish_stats(a, grid, partial, stats, s);
}

template <typename TO, int MODE, bool STATS>
void launch(bool in_f32, const void* x, const void* w, const void* bias,
            const void* coord, void* out, void* partial, void* stats,
            const ConvArgs& a, cudaStream_t s) {
  if (in_f32)
    launch_f32<TO, MODE, STATS>(x, w, bias, coord, out, partial, stats, a,
                                s);
  else
    launch_tc<TO, MODE, STATS>(x, w, bias, coord, out, partial, stats, a, s);
}

template <typename TO>
void launch_mode(bool in_f32, const void* x, const void* w, const void* bias,
                 const void* coord, void* out, void* partial, void* stats,
                 const ConvArgs& a, int mode, cudaStream_t s) {
  if (partial)
    launch<TO, kWrap, true>(in_f32, x, w, bias, coord, out, partial, stats,
                            a, s);
  else if (mode == kCoord)
    launch<TO, kCoord, false>(in_f32, x, w, bias, coord, out, partial,
                              stats, a, s);
  else if (mode == kZero)
    launch<TO, kZero, false>(in_f32, x, w, bias, coord, out, partial, stats,
                             a, s);
  else
    launch<TO, kWrap, false>(in_f32, x, w, bias, coord, out, partial, stats,
                             a, s);
}

}  // namespace

// Length of each sample's row of partials that a stats launch may write
// (ho_wo output pixels, cout channels): its block count under the smallest
// pixel tile, at least the count of whichever tile the launch takes.
extern "C" int matry_conv_stats_blocks(int ho_wo, int cout) {
  return cdiv(ho_wo, 64) * cdiv(cout, 64);
}

// The tile a bf16 launch takes, as BM * 1000 + BN (the f32 kernel has one
// tile, 64 x 128).
extern "C" int matry_conv_tile(int B, int npar, int ho_wo, int cout) {
  return tc::BM * 1000 + tc_bn(B, npar, ho_wo, cout);
}

// coord: null, or the coord channel's f32 value per input row [Hi] (then
// zero_w must be set); zero_w: zero horizontal padding, else wrap. in_f32:
// x and w are float32 (the f32 kernel), else bfloat16 (the tensor-core
// kernel). partial/stats: null, or (wrap mode, npar 1 only) the STATS
// epilogue's f32 scratch [B, matry_conv_stats_blocks(Ho*Wo, Cout), 2] and
// its f64 result [B, 2] = (sum y, sum y^2) per sample.
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
  if (out_f32)
    launch_mode<float>(in_f32, x, w, bias, coord, out, partial, stats, a,
                       mode, s);
  else
    launch_mode<__nv_bfloat16>(in_f32, x, w, bias, coord, out, partial,
                               stats, a, mode, s);
  return (int)cudaGetLastError();
}
