// Implicit-GEMM convolution for every conv stage of the MSI U-Net.
//
// Replaces the conv block of matryodshka_tpu/ops/pallas_net.py:_build_kernel
// (K2, both variants: the 3x3 convs, stride-2 downs, rate-2 dilated convs,
// the three 4x4 stride-2 transposed convs and the 1x1 tanh head) and the
// three kernels of matryodshka_tpu/ops/pallas_conv.py (K7: _conv_kernel,
// _conv_kernel_dma, _conv_ln_kernel; ops/wrap_conv.py), which are its wrap
// mode at stride 1, and the K2 stage's layer norm + ReLU (_build_kernel's
// norm_vectors and norm_row), fused as the TPU kernel fuses it: the
// producer sums its outputs, the consumer normalizes its input (see the
// last note). One launch is one layer, an implicit GEMM over K =
// KH*KW*Cin', the input patch read in place from x (no im2col copy), NCHW
// or channels-last (NHWC memory; see items 3 and 4).
//
// Input taps: input row iy = oy*stride + kh*dil - pad_h is zero outside
// [0, Hi) (vertical zero padding; the high side needs no argument, so a
// stride-2 SAME down runs with pad_h = 0) and input column
// ix = ox*stride + kw*dil - pad_w
//   * wraps mod Wi in kWrap mode (the wrap net's horizontal ERP wrap);
//   * reads zero outside [0, Wi) in kZero and kCoord mode (the coord net's
//     SAME padding).
// kCoord adds the coord net's |sin(lat)| channel as input channel Cin
// (Cin' = Cin + 1, its weights last in each tap), from coord[iy], an f32
// value per input row; no Cin+1-channel copy of x is made. npar == 4 is
// the transposed 4x4/2 conv in its subpixel form (models/unet.py
// FusedDeconvCrop; the coord net's SAME ConvTranspose has the same index
// map, with zero padding): blockIdx.z carries the output parity (da, db),
// each parity is a 2x2 conv with pads (pad_h - da, pad_w - db), and the
// epilogue writes output pixel (2*oy + da, 2*ox + db). npar == 4 with
// KH == KW == 3 is the smoothed net's upsampling conv (nearest 2x, then a
// 4x4 conv padded (1, 2); JAX models/unet.py:306-322) folded onto the
// un-upsampled input: parity d of an axis reads input offsets -1..1 with
// the 4x4 taps summed as {t0}, {t1, t2}, {t3} (d = 0) or offsets 0..1 as
// {t0, t1}, {t2, t3} (d = 1), so parity (da, db) is a (3 - da) x (3 - db)
// conv with the same pads (pad_h - da, pad_w - db) and the same output
// map: 25 taps for the four parities where the upsampled form has 64
// (par_taps; ops/conv.py:pack_smoothed folds the weights, each parity's
// block padded to 9 taps).
//
// Bound: operations. 301.2 GFLOP per 640x320 frame for the wrap net (302.4
// for the coord net), 0.3045 ms at the H100's 989 TFLOP/s in bf16; the
// bytes (weights, activations) are a few percent of that time. A smoothed
// net's folded upsampling stages run 125.8 GFLOP where the transposed
// ones run 80.5: 346.5 GFLOP a frame (347.7 coord).
//
// bf16 operands (conv_wgmma_kernel) run on Hopper's warpgroup tensor-core
// path; it replaces PR 6's mma.sync kernel (conv_tc_kernel: 32 x 32 warp
// tiles, the patch gathered through registers, a 3-deep cp.async ring).
//   1. GEMM orientation: M = output pixels (a tile is 128 pixels, rows x
//      cols of the output, cols = 64, 32 or 16, the widest dividing Wo so
//      no column of a 160- or 80-wide layer is wasted), N = Cout (128 or
//      64 a tile), K = the taps x Cin. Each of two consumer warpgroups
//      takes 64 pixels and all N, wgmma.mma_async.m64nNk16 (bf16 in, f32
//      accumulate in registers), A from registers, B from shared memory
//      through a matrix descriptor (MN-major, transpose bit set: the
//      packed weights are Cout-contiguous, so they are not repacked).
//      setmaxnreg gives the consumers 224 registers, the producer 56.
//   2. One producer thread keeps TMA loads (cp.async.bulk.tensor) in
//      flight into a ring of 2 stages (kStages) with full and empty
//      mbarriers. A stage is (channel chunk of 64, kernel row kh): the
//      weights of the row's taps through a 2-D tensor map over [npar*K,
//      Cout] ([64 k][64 Cout] boxes, 128-byte swizzle), and the patch
//      window of input rows oy0 * stride + kh*dil - pad_h + r * stride
//      (TMA's element stride takes every stride-th row, the downs): the
//      tile's cols * stride columns and the columns either side (item 3).
//      TMA's out-of-bounds fill gives the vertical padding, a ragged Cin
//      (195) and the rows past Cin of a chunk.
//   3. A fragments, by the layout of x. The tensor map's innermost start
//      must be 16-byte aligned (TMA traps otherwise: illegal instruction at
//      columns -1, 1, -3 of an NCHW row in a probe), and so must a wgmma
//      descriptor's or an ldmatrix row's; the consumers therefore hold A in
//      registers and load each tap kw's fragment from the stage's one
//      window at the tap's column shift (kw*dil - pad_w, at the stride), so
//      one window serves every tap of the row with no data moved in shared
//      memory.
//      * Channels-last x (the net's activations from conv1_2 on; CL): a
//        4-D map over x taken as (C, W, H, B), boxes {64 channels, columns,
//        rows, 1} with the 128-byte swizzle: a pixel's 64 channels of the
//        chunk are one 128-byte line, the 16-byte chunk k of line q at k ^
//        (q % 8). One box holds the window: the tile's columns and 2
//        (kHaloCL) either side, its start at any column (negative or past
//        W: the fill); a tile whose window crosses the wrap seam also loads
//        the 2 wrapped columns as a seam box (each box 1024-byte aligned),
//        whose lines those columns' taps read. Any column shift, stride or
//        dilation moves a whole line, so each tap's fragment (16 pixels x
//        16 channels a warp per k16) is one ldmatrix.x4 from the lines of
//        the warp's pixels at the tap's shift: 4 instructions a tap and
//        chunk, each 8-lane phase one 128-byte wavefront. The 8 rows of a
//        matrix are 8 consecutive pixels of one output row: 8 consecutive
//        lines at stride 1 (any dilation), so 8 distinct bank groups (but
//        where a seam box's line is among them); every second line at
//        stride 2, a 2-way conflict on the downs.
//      * NCHW x (the net's first conv, which reads the sweep's volume, and
//        K7): a map over x taken as (W, C, H, B), the main box {cols *
//        stride, 64, rows, 1} swizzled as wide as its rows and halo boxes
//        of 8 columns (kHalo), so that a 16-byte-aligned start holds the
//        column shift; the fragment comes by 16-bit shared loads at the
//        tap's shift, two a 32-bit register.
//        The halos hold the columns beyond the tile: the neighbours', or
//        in wrap mode across the seam the wrapped ones (the box at W - 8 or
//        0: the seam costs no extra step), or in zero mode a box at W,
//        wholly outside.
//   4. Shapes a tensor map cannot express (x's innermost line not a
//      multiple of 16 bytes: W % 8 != 0 in NCHW, Cin % 8 != 0 in
//      channels-last; in wrap mode a column tile that does not divide Wo,
//      whose right halo would not be the wrapped columns) take the
//      producer warpgroup's 128 threads, which gather the same window
//      (channels-last: the window's box, its columns wrapped in place)
//      element by element, wrapping or bounds-checking each column, and
//      arrive after fence.proxy.async;
//      Cout % 8 != 0 (the 67- and 99-channel heads) gathers the weights the
//      same way.
//   5. Persistent: one block per SM walks the tiles blockIdx.x + k *
//      gridDim.x, Cout tile fastest, so the producer loads the next tile's
//      stages while the consumers finish the last one.
//   6. The coord channel is not a K block of its own (at Cin 64 it would
//      add 50% of K): the epilogue adds sum over taps of bf16(w[tap, Cin,
//      m]) * bf16(coord[iy]) where (iy, ix) is inside the input, each
//      product exact in f32, summed in tap order in f32, to the
//      accumulator before the bias (as the bf16 net appends the channel in
//      bf16).
//   7. Epilogue: the bias (and tanh for the head) in f32, one rounding to
//      the output type, in the output's layout: NCHW, stores from the
//      accumulator fragments; channels-last bf16 (Cout % 8 == 0), the
//      fragments packed a channel pair a register, stored by stmatrix into
//      a tile buffer after the norm's vectors and copied out 16 bytes a
//      thread, a pixel's channels contiguous (store_tile_cl; stores
//      element by element in that layout made the net's convs 7% slower);
//      the parity modes write pixel (2*oy + da, 2*ox + db). The pixels of
//      a fragment row and the order of every sum are those of either
//      layout, so a channels-last launch gives the NCHW launch's bits.
//      The channels-last epilogue is a template choice (CLO), compiled
//      into the forms that write it (the channels-last forms, and the NCHW
//      form of the net's first conv, 64 Cout without the norm) and only
//      there: the NCHW forms that K7 and the f32-output callers run carry
//      neither it nor its tile. A channels-last output that is f32, has
//      Cout % 8 != 0 or leaves the ring fewer than 2 stages beside the
//      tile is refused.
//   8. The plan (make_plan, matry_conv_plan; mirrored by
//      ops/conv.conv_plan): 128-Cout tiles where Cout > 64, else 64. No
//      atomics: every output is the same from launch to launch.
//   9. Tensor maps are encoded through the runtime's driver entry point
//      into hopper.cuh's cache (shared with conv_wgrad.cu), keyed by their
//      arguments.
//
// f32 operands (conv_f32_kernel, compute_dtype="float32") keep exact f32
// FMA on the CUDA cores: a 64 x 128 tile per block, K in steps of 16
// staged in shared memory, a 4 x 8 register tile per thread.
//
// Weights are packed [npar, K, Cout] with k = (kh*KW + kw)*Cin' + c
// (ops/conv.py:pack_conv / pack_deconv / pack_smoothed).
//
// The layer norm + ReLU between two layers (slim.layer_norm over (C, H,
// W) per example, eps 1e-12, per-channel gamma and beta) has no launch of
// its own, as in the TPU kernel (pallas_net.py:42-46):
//   * statistics in the producer's epilogue (STATS, every mode and form):
//     after the coord term, the bias and the rounding to the output type,
//     each thread sums y and y^2 of its ROUNDED outputs in f32 in a fixed
//     order (the stored tensor is what the consumer normalizes), warps
//     combine by butterfly and the warp sums are added in order into one
//     (s1, s2) partial per (sample, tile), tiles of a sample numbered
//     parity, pixel tile, Cout tile; no atomics;
//   * the fold at the consumer's start (fold_norm): where a block's tile
//     changes sample, its 256 consumer threads sum each source's partials
//     of the sample in f64 in a fixed order (f64 keeps var = s2/n - mean^2
//     from cancelling when mean^2 >> var) into per-channel vectors a =
//     gamma * rsqrt(var + eps), b = beta - mean * a in shared memory after
//     the ring (norm_vectors), a channel pair's (a, a', b, b') a 16-byte
//     float4; every launch runs the same code in the same order, so a
//     source read by two consumers gives both the same bits; a skip concat
//     (x = cat of two raw sources) takes the two sources' vectors end to
//     end;
//   * normalize + ReLU on the A fragments (norm_frag), as each tap's shared
//     loads (16-bit loads or ldmatrix) produce them: relu(a[c] * y + b[c])
//     in f32, rounded once to bf16, a thread's 8 channel pairs' (a, b)
//     loaded once per channel chunk. A window element outside the input
//     (rows outside [0, Hi), columns outside [0, Wi) in zero and coord
//     mode, channels past Cin, the parity forms' padding) must stay zero,
//     as norm_row keeps pad rows zero: the launch's tensor maps fill them
//     with NaN (a gathered window too), and fmaxf(NaN, 0) is 0, so no
//     element needs a mask; wrap mode's halos and seam boxes are real
//     wrapped columns and are normalized. The coord channel is not in the
//     window, so it is never normalized. An element is normalized once
//     per tap that reads it (up to 9 times), in registers. Normalizing
//     each stage's window in place once timed slower in every placement
//     (tools/variants.py): for NCHW x by the consumers or by the producer
//     warpgroup one stage ahead; for channels-last x by the consumers one
//     stage ahead, or by the producer warpgroup's last three warps
//     between a stage's loads and its release to the consumers (the
//     fragments' transform takes 14% of the net's conv time; the
//     producer's pass took more: its three warps could not hide it).
//     conv_wgmma_kernel is instantiated with the layer norm and without
//     (NORM) for NCHW x, and with it for channels-last x (every such
//     input of the net is normed). The f32 kernel folds once per block
//     and applies the transform, with its masks, where it stages x in
//     shared memory.
// K7c (the trainer's net, ops/wrap_conv.py) takes the same partials and
// folds them in stats_fold, a second launch, into f64 (s1, s2) per sample.

#include <stdint.h>
#include <string.h>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

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

// The layer norm + ReLU a consumer applies to x (see the note above): x's
// channels [0, c0) are source 0's, [c0, Cin) source 1's (nsrc == 2, a skip
// concat; c0 == Cin for one source); each source has its producer's
// partials [B, nblk, 2] and its gamma, beta. nsrc == 0: x as it is.
struct Norm {
  const float* partial[2];
  const float* gamma[2];
  const float* beta[2];
  int nblk[2];
  int nsrc, c0;
};
constexpr double kEps = 1e-12;  // ops/layernorm.EPS

// The layer norm's vectors in shared memory, a channel pair (c, c + 1), c
// even, a float4 (a_c, a_c+1, b_c, b_c+1), Cin rounded up to a multiple of
// 64 channels (the pad channels' a = b = 0): one 16-byte load gives a
// thread both channels of a fragment register.
__host__ __device__ __forceinline__ int vec_bytes(int cin) {
  return (cin + 63) / 64 * 64 * 8;
}
__device__ __forceinline__ float vec_a(const float* v, int c) {
  return v[(c >> 1) * 4 + (c & 1)];
}
__device__ __forceinline__ float vec_b(const float* v, int c) {
  return v[(c >> 1) * 4 + 2 + (c & 1)];
}

// Sample b's vectors of every source into vec (norm_vectors) by NT
// threads: thread t sums the source's partials t, t + NT, ... in f64 in
// order, a butterfly sums each warp, and every thread adds the NT / 32
// warp sums in order; mean = s1 / n, var = max(s2 / n - mean^2, 0) over n
// = C * Hi * Wi, a = gamma * rsqrt(var + eps), b = beta - mean * a. sync
// is a barrier of the NT threads; vec is complete when it returns. Every
// launch of one kernel folds with the same NT, so a source read by two
// consumers gives both the same bits.
template <int NT, typename Sync>
__device__ __forceinline__ void fold_norm(const Norm& nm, int b,
                                          const ConvArgs& a, float* vec,
                                          double (*sh)[8], int tid,
                                          Sync sync) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = a.Cin + tid; c < (a.Cin + 63) / 64 * 64; c += NT) {
    vec[(c >> 1) * 4 + (c & 1)] = 0.f;
    vec[(c >> 1) * 4 + 2 + (c & 1)] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s == nm.nsrc) break;
    const int lo = s ? nm.c0 : 0, hi = s ? a.Cin : nm.c0;
    const float* pb = nm.partial[s] + (long long)b * nm.nblk[s] * 2;
    double t1 = 0.0, t2 = 0.0;
    for (int i = tid; i < nm.nblk[s]; i += NT) {
      t1 += (double)pb[2 * i];
      t2 += (double)pb[2 * i + 1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      t2 += __shfl_xor_sync(0xffffffffu, t2, off);
    }
    if (lane == 0) {
      sh[0][warp] = t1;
      sh[1][warp] = t2;
    }
    sync();
    double s1 = 0.0, s2 = 0.0;
    for (int i = 0; i < NT / 32; ++i) {
      s1 += sh[0][i];
      s2 += sh[1][i];
    }
    const double n = (double)(hi - lo) * a.Hi * a.Wi;
    const double mean = s1 / n;
    const double var = fmax(s2 / n - mean * mean, 0.0);
    const float r = (float)(1.0 / sqrt(var + kEps));
    const float m = (float)mean;
    for (int c = lo + tid; c < hi; c += NT) {
      const float ga = nm.gamma[s][c - lo] * r;
      vec[(c >> 1) * 4 + (c & 1)] = ga;
      vec[(c >> 1) * 4 + 2 + (c & 1)] = fmaf(-m, ga, nm.beta[s][c - lo]);
    }
    sync();  // sh is free, vec complete
  }
}

// relu(a * y + b) in f32.
__device__ __forceinline__ float norm_relu(float y, float ka, float kb) {
  return fmaxf(fmaf(ka, y, kb), 0.f);
}

// The STATS block sum of the f32 kernel: butterfly within each warp, then
// the warp sums in order by thread 0, into the partial at pb.
template <int NT>
__device__ __forceinline__ void block_stats(float s1, float s2,
                                            float (*red)[NT / 32],
                                            float* pb) {
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
    pb[0] = t1;
    pb[1] = t2;
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: wgmma fed by TMA (see the note above).
// ---------------------------------------------------------------------------
namespace wg {

using namespace matry::hop;

constexpr int BK = 64;              // channels of one k-step
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kBoxW = 64 * BK * 2;  // one [64 k][64 Cout] weight box, bytes
constexpr int kHalo = 8;            // window columns each side of the tile
constexpr int kHaloCL = 2;          // the same, channels-last x
// Ring depth: 2 stages. At the flagship stages 3 timed within the spread
// of two runs of 2 and 4 or as many as 220 KB hold slower, for NCHW x with
// 16-bit A loads; for channels-last x 2, 3 and 4 within 0.3%
// (tools/variants.py); mbarriers for up to kMaxStages.
constexpr int kStages = 2;
constexpr int kMaxStages = 8;
constexpr int kMaxKW = 3;           // taps along a row
constexpr int kTilePx = 128;        // output pixels of a tile
// Dynamic shared memory a block may take (the ring), bytes.
constexpr int kSmemBudget = 220 * 1024;

struct Params {
  ConvArgs a;
  Norm nm;          // the input's layer norm (nm.nsrc == 0: none)
  int mode, stats, out_f32;
  int cl_out;       // CLO forms: the output channels-last bf16, through
                    // the output tile (else NCHW)
  int stat_blocks;  // partials a sample: npar * ntx * nty * mtiles
  int ct_lg;        // log2 of the output columns of a tile
  int rows;         // output rows of a tile, kTilePx >> ct_lg
  int ntx, nty, mtiles;  // column and row tiles, Cout tiles
  int tma_x, tma_w; // patch windows / weights by TMA (else gathered)
  int halo;         // some tap is shifted: the window's halos are read
  int krows;        // rows of the packed weight, npar * KH * KW * Cin'
  int stages;       // ring depth
  int stage_bytes;  // weights (KW taps), main window, two halos
  int win_off, halo_off;  // offsets of the main window and the left halo
  int hb;           // offset of the right halo from the left one
  int vec_off;      // the norm's vectors (vec_bytes), after the ring
  int out_off;      // cl_out: the output tile (128 px x BN), after them
};

// Bytes of a window's main box (rows x 64 channels x cols * stride) and of
// one halo box (rows x 64 channels x 8 columns).
__host__ __device__ __forceinline__ int main_bytes(int rows, int ctw) {
  return rows * BK * ctw * 2;
}
__host__ __device__ __forceinline__ int halo_bytes(int rows) {
  return rows * BK * kHalo * 2;
}
// Channels-last x: the window's box (rows x ctw + 4 columns of 128-byte
// lines: the tile's columns and kHaloCL either side), a seam box's (rows x
// kHaloCL lines) and the region a seam box takes, rounded up to 1024 bytes
// so that every box starts where the 128-byte swizzle's pattern does (rows
// is even, so the window's box is a multiple of 1024 bytes too).
__host__ __device__ __forceinline__ int cl_main_bytes(int rows, int ctw) {
  return rows * (ctw + 2 * kHaloCL) * BK * 2;
}
__host__ __device__ __forceinline__ int cl_halo_bytes(int rows) {
  return rows * kHaloCL * BK * 2;
}
__host__ __device__ __forceinline__ int cl_halo_region(int rows) {
  return (cl_halo_bytes(rows) + 1023) / 1024 * 1024;
}

// Generic producer, any row pitch: the weights of one tap, rows arow ..
// arow + 63 of the packed [krows, Cout], 16-byte chunks of 8 Cout, into
// BN / 64 [64 k][64 Cout] boxes with the 128-byte swizzle.
template <int BN>
__device__ __forceinline__ void gather_w(unsigned char* Ws,
                                         const unsigned short* w,
                                         const Params& p, int m0, int arow,
                                         int tid) {
  constexpr int per = BN / 8;  // chunks per k row
  for (int q = tid; q < BK * per; q += 128) {
    const int mc = q % per;
    const int k = q / per;
    const int row = arow + k;
    const int m = m0 + 8 * mc;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row < p.krows) {
      const unsigned short* src = w + (long long)row * p.a.Cout + m;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (m + e < p.a.Cout) v[e >> 1] |= (uint32_t)src[e] << (16 * (e & 1));
    }
    const uint32_t off = (uint32_t)((k * 64 + (mc & 7) * 8) * 2);
    *reinterpret_cast<uint4*>(Ws + (mc >> 3) * kBoxW +
                              (off ^ (((off >> 7) & 7) << 4))) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Generic producer, any row pitch: one k-step's window, element by element
// in 16-byte chunks of 8 columns of one (row, channel): input rows iy0 + r
// * stride, columns ox0 * stride - 8 + wc for wc in [0, cols * stride +
// 16), each column wrapped or bounds-checked, stored as the TMA boxes lie
// (the main box swizzled, the halos plain), fill (a bf16 bit pattern)
// outside the input.
__device__ __forceinline__ void gather_window(unsigned char* win,
                                              const unsigned short* x,
                                              const Params& p, int b,
                                              int iy0, int ox0, int c0,
                                              int tid, uint32_t fill) {
  const ConvArgs& a = p.a;
  const int ctw = a.stride << p.ct_lg;  // window columns without halos
  const int cpl = ctw / 8 + 2;          // chunks of a (row, channel) line
  const uint32_t mask = (uint32_t)(ctw / 8) - 1;  // swizzle of 2 ctw bytes
  const int n = p.rows * BK * cpl;
  for (int q = tid; q < n; q += 128) {
    const int cc = q % cpl;
    const int line = q / cpl;
    const int ch = line & (BK - 1), r = line >> 6;
    const int c = c0 + ch;
    const int iy = iy0 + r * a.stride;
    const uint32_t f2 = fill | fill << 16;
    uint32_t v[4] = {f2, f2, f2, f2};
    if (c < a.Cin && iy >= 0 && iy < a.Hi) {
      const unsigned short* row =
          x + (((long long)b * a.Cin + c) * a.Hi + iy) * a.Wi;
      const int ixb = ox0 * a.stride - kHalo + 8 * cc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ix = ixb + j;
        uint32_t q16 = fill;
        if (p.mode == kWrap)
          q16 = row[matry::wrap(ix, a.Wi)];
        else if (ix >= 0 && ix < a.Wi)
          q16 = row[ix];
        v[j >> 1] = j & 1 ? (v[j >> 1] & 0xffffu) | q16 << 16
                          : (v[j >> 1] & 0xffff0000u) | q16;
      }
    }
    uint32_t off;
    if (cc == 0) {
      off = p.halo_off - p.win_off + (uint32_t)(line * 16);
    } else if (cc == cpl - 1) {
      off = p.halo_off - p.win_off + halo_bytes(p.rows) + (uint32_t)(line * 16);
    } else {
      const uint32_t o = (uint32_t)((line * ctw + 8 * (cc - 1)) * 2);
      off = o ^ (((o >> 7) & mask) << 4);
    }
    *reinterpret_cast<uint4*>(win + off) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Channels-last x: the byte offset (from the window) of the 128-byte line
// of window pixel (r, wc) of a tile whose window starts at input column x0
// - kHaloCL (wc counts from there, ncol = ctw + 4 columns): the window
// box's line r * ncol + wc, or, for a column across the wrap seam of a
// window TMA loads (whose box holds the fill there), the line of the seam
// box on that side. Boxes start 1024-byte aligned, so a line's swizzle
// key, its index in its box mod 8, is (offset >> 7) & 7.
__device__ __forceinline__ uint32_t cl_line(const Params& p, int r, int wc,
                                            int x0, int ncol) {
  const int col = x0 - kHaloCL + wc;
  if (p.mode == kWrap && p.tma_x) {
    if (col < 0)
      return p.halo_off - p.win_off + (r * kHaloCL + col + kHaloCL) * BK * 2;
    if (col >= p.a.Wi)
      return p.halo_off - p.win_off + p.hb +
             (r * kHaloCL + col - p.a.Wi) * BK * 2;
  }
  return (r * ncol + wc) * BK * 2;
}

// The layer norm + ReLU of one A fragment register (channels c, c + 1 of
// one pixel; ab: (a_c, a_c+1, b_c, b_c+1)): relu(a y + b) in f32, rounded
// once to bf16. An element outside the input holds TMA's NaN fill, and
// fmaxf(NaN, 0) is 0: the pads come out zero with no mask.
__device__ __forceinline__ uint32_t norm_frag(uint32_t u, float4 ab) {
  const float lo = norm_relu(__uint_as_float(u << 16), ab.x, ab.z);
  const float hi = norm_relu(__uint_as_float(u & 0xffff0000u), ab.y, ab.w);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

// Generic producer, channels-last x: one k-step's window, 16-byte chunks
// of 8 channels of one pixel, input rows iy0 + r * stride, columns ox0 *
// stride - 2 + wc for wc in [0, cols * stride + 4), each column wrapped or
// bounds-checked, fill (a bf16 bit pattern) outside the input and past
// Cin, stored as the window's TMA box lies (swizzled; no seam box).
__device__ __forceinline__ void gather_window_cl(unsigned char* win,
                                                 const unsigned short* x,
                                                 const Params& p, int b,
                                                 int iy0, int ox0, int c0,
                                                 int tid, uint32_t fill) {
  const ConvArgs& a = p.a;
  const int ctw = a.stride << p.ct_lg;
  const int ncol = ctw + 2 * kHaloCL;
  const int n = p.rows * ncol * (BK / 8);
  for (int q = tid; q < n; q += 128) {
    const int k = q & (BK / 8 - 1), rc = q / (BK / 8);
    const int wc = rc % ncol, r = rc / ncol;
    const int iy = iy0 + r * a.stride;
    int ix = ox0 * a.stride - kHaloCL + wc;
    if (p.mode == kWrap) ix = matry::wrap(ix, a.Wi);
    const uint32_t f2 = fill | fill << 16;
    uint32_t v[4] = {f2, f2, f2, f2};
    if (iy >= 0 && iy < a.Hi && ix >= 0 && ix < a.Wi) {
      const unsigned short* px =
          x + (((long long)b * a.Hi + iy) * a.Wi + ix) * a.Cin;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + 8 * k + j;
        const uint32_t q16 = c < a.Cin ? px[c] : fill;
        v[j >> 1] = j & 1 ? (v[j >> 1] & 0xffffu) | q16 << 16
                          : (v[j >> 1] & 0xffff0000u) | q16;
      }
    }
    const uint32_t off = (uint32_t)(rc * BK * 2);  // line r * ncol + wc
    *reinterpret_cast<uint4*>(win + off + (((k ^ (off >> 7)) & 7) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The coord channel's factors for output pixel (oy, ox), per tap kh * 3 +
// kw: bf16(coord[iy]) where (iy, ix) lies inside [0, Hi) x [0, Wi), else 0.
__device__ __forceinline__ void coord_factors(float* cf, const float* coord,
                                              const ConvArgs& a, int oy,
                                              int ox) {
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int iy = oy * a.stride + kh * a.dil - a.pad_h;
    const float cv = kh < a.KH && iy >= 0 && iy < a.Hi
                         ? __bfloat162float(__float2bfloat16(coord[iy]))
                         : 0.f;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int ix = ox * a.stride + kw * a.dil - a.pad_w;
      cf[kh * 3 + kw] = kw < a.KW && ix >= 0 && ix < a.Wi ? cv : 0.f;
    }
  }
}

// A tile of the launch: tiles run Cout tile fastest, then the pixel tiles
// of a row of tiles, rows, parities and samples.
struct Tile {
  int b, par, m0, oy0, ox0, local;  // local: the tile's index in its sample
};
__device__ __forceinline__ Tile tile_of(const Params& p, int t, int bn) {
  const int per = p.mtiles * p.ntx * p.nty;
  Tile u;
  const int z = t / per;
  u.local = t - z * per;
  u.b = z / p.a.npar;
  u.par = z - u.b * p.a.npar;
  const int mt = u.local % p.mtiles;
  const int pt = u.local / p.mtiles;
  u.m0 = mt * bn;
  u.oy0 = (pt / p.ntx) * p.rows;
  u.ox0 = (pt % p.ntx) << p.ct_lg;
  return u;
}

// A warpgroup's 64 output pixels x BN channels of a channels-last bf16
// output (Cout % 8 == 0), which its 4 warps have stored by stmatrix into
// [64 px][BN] at its half of the tile buffer, each pixel's 16-byte chunk k
// at k ^ (px % 8) (the 8 rows of a matrix in 8 bank groups): after the
// warpgroup's barrier its 128 threads copy them out a 16-byte chunk each,
// consecutive threads a pixel's consecutive chunks, the pixels inside the
// output only (the parity forms' pixel (2 oy + da, 2 ox + db)); a second
// barrier frees the buffer for the next tile.
template <int BN>
__device__ __forceinline__ void store_tile_cl(const Params& p,
                                              unsigned char* tile, void* out,
                                              int b, int da, int db, int m0,
                                              int oy0, int ox0, int cw,
                                              int t) {
  constexpr int C8 = BN / 8;  // 16-byte chunks of a pixel
  const ConvArgs& a = p.a;
  named_sync(2 + cw, 128);
  const int ct = 1 << p.ct_lg;
  for (int q = t; q < 64 * C8; q += 128) {
    const int k = q % C8, px = q / C8;
    const int m = 64 * cw + px;
    const int oy = oy0 + (m >> p.ct_lg), ox = ox0 + (m & (ct - 1));
    if (oy >= a.Ho || ox >= a.Wo || m0 + 8 * k >= a.Cout) continue;
    const long long pix = a.npar == 4
                              ? (long long)(2 * oy + da) * a.out_w + 2 * ox + db
                              : (long long)oy * a.out_w + ox;
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + (cw * 64 + px) * BN * 2 + ((k ^ (px & 7)) << 4));
    *reinterpret_cast<uint4*>(
        static_cast<__nv_bfloat16*>(out) +
        ((long long)b * a.out_h * a.out_w + pix) * a.Cout + m0 + 8 * k) = v;
  }
  named_sync(2 + cw, 128);
}

// NORM: the input layer-normed; CL: x channels-last (NCHW otherwise); CLO:
// the form has the channels-last epilogue, which p.cl_out selects (conv1_1's
// form and the channels-last forms; the NCHW forms compile without it).
template <int BN, bool NORM, bool CL, bool CLO>
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmh,
                      const __grid_constant__ CUtensorMap tmw,
                      const unsigned short* __restrict__ x,
                      const unsigned short* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ coord,
                      void* __restrict__ out, float* __restrict__ partial,
                      const Params p) {
  constexpr int kWB = BN / 64;           // weight boxes of a tap
  constexpr int kTapW = kWB * kBoxW;     // a tap's weights, bytes
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ float red[2][8];
  __shared__ float wcs[9][128];  // coord weights (kCoord)
  __shared__ double fsh[2][8];   // the norm's fold
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const ConvArgs& a = p.a;
  const int Ck = a.Cin + (p.mode == kCoord);
  const int ctw = a.stride << p.ct_lg;  // window columns without halos
  const int ntiles = p.mtiles * p.ntx * p.nty * a.B * a.npar;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // one arrival (with the TMA bytes) by the issuing thread, then one
      // by each producer thread after its gathers (if any) and the fence
      mbar_init(&full[s], 129);
      mbar_init(&empty[s], 8);  // each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: a stage is (channel chunk c0, kernel row kh):
    // the KWp taps' weights and the window of input rows iy0 + r * stride,
    // columns [ox0 * stride - 8, ox0 * stride + ctw + 8) (CL: - 2 to + 2)
    // -----------------------------------------------------------------------
    reg_dealloc<56>();
    const int tid = threadIdx.x;
    if (tid == 0) {
      if (p.tma_x) prefetch_tmap(&tmx);
      if (p.tma_x && p.halo) prefetch_tmap(&tmh);
      if (p.tma_w) prefetch_tmap(&tmw);
    }
    // the gathered windows' fill outside the input: as the tensor maps'
    // (NaN with the layer norm, else zero)
    const uint32_t fill = NORM ? 0x7fc0u : 0u;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile u = tile_of(p, t, BN);
      const int b = u.b, par = u.par, m0 = u.m0, oy0 = u.oy0, ox0 = u.ox0;
      const int da = par >> 1, db = par & 1;
      const int KHp = par_taps(a.KH, a.npar, da);
      const int KWp = par_taps(a.KW, a.npar, db);
      const int ph = a.pad_h - da;
      const int wrow0 = par * a.KH * a.KW * Ck;
      // the halo boxes' columns: the neighbours', wrapped across the seam, or
      // (zero mode, outside) at Wi, a box wholly outside the input; CL: the
      // seam boxes of a tile whose window crosses the wrap seam
      int lcol = ox0 * a.stride - (CL ? kHaloCL : kHalo);
      int rcol = ox0 * a.stride + ctw;
      const bool seam_l = CL && p.mode == kWrap && p.halo && lcol < 0;
      const bool seam_r =
          CL && p.mode == kWrap && p.halo && rcol + kHaloCL > a.Wi;
      if (p.mode == kWrap) {
        lcol += lcol < 0 ? a.Wi : 0;
        rcol -= rcol >= a.Wi ? a.Wi : 0;
      } else {
        lcol = lcol < 0 ? a.Wi : lcol;
      }
      const uint32_t wbytes = p.tma_w ? KWp * kTapW : 0;
      const uint32_t xbytes =
          !p.tma_x ? 0
          : CL     ? cl_main_bytes(p.rows, ctw) +
                     (seam_l + seam_r) * cl_halo_bytes(p.rows)
                   : main_bytes(p.rows, ctw) +
                     (p.halo ? 2 * halo_bytes(p.rows) : 0);
      for (int c0 = 0; c0 < a.Cin; c0 += BK)
        for (int kh = 0; kh < KHp; ++kh) {
          const int iy0 = oy0 * a.stride + kh * a.dil - ph;
          mbar_wait(&empty[s], phase ^ 1u);
          unsigned char* st = smem + s * p.stage_bytes;
          if (tid == 0) {
            if (wbytes + xbytes)
              mbar_arrive_tx(&full[s], wbytes + xbytes);
            else
              mbar_arrive(&full[s]);
            if (p.tma_w)
              for (int kw = 0; kw < KWp; ++kw)
#pragma unroll
                for (int i = 0; i < kWB; ++i)
                  tma_load_2d(st + kw * kTapW + i * kBoxW, &tmw, &full[s],
                              m0 + 64 * i,
                              wrow0 + (kh * KWp + kw) * Ck + c0);
            if (p.tma_x && CL) {
              tma_load_4d(st + p.win_off, &tmx, &full[s], c0,
                          ox0 * a.stride - kHaloCL, iy0, b);
              if (seam_l)
                tma_load_4d(st + p.halo_off, &tmh, &full[s], c0,
                            a.Wi - kHaloCL, iy0, b);
              if (seam_r)
                tma_load_4d(st + p.halo_off + p.hb, &tmh, &full[s], c0, 0,
                            iy0, b);
            } else if (p.tma_x) {
              tma_load_4d(st + p.win_off, &tmx, &full[s], ox0 * a.stride, c0,
                          iy0, b);
              if (p.halo) {
                tma_load_4d(st + p.halo_off, &tmh, &full[s], lcol, c0, iy0, b);
                tma_load_4d(st + p.halo_off + halo_bytes(p.rows), &tmh,
                            &full[s], rcol, c0, iy0, b);
              }
            }
          }
          if (!p.tma_w)
            for (int kw = 0; kw < KWp; ++kw)
              gather_w<BN>(st + kw * kTapW, w, p, m0,
                           wrow0 + (kh * KWp + kw) * Ck + c0, tid);
          if (!p.tma_x && CL)
            gather_window_cl(st + p.win_off, x, p, b, iy0, ox0, c0, tid, fill);
          else if (!p.tma_x)
            gather_window(st + p.win_off, x, p, b, iy0, ox0, c0, tid, fill);
          fence_proxy_async();
          mbar_arrive(&full[s]);
          if (++s == p.stages) {
            s = 0;
            phase ^= 1u;
          }
        }
    }
  } else {
    // ---- consumer warpgroups: warpgroup cw takes the tile's pixels
    // [64 cw, 64 cw + 64) and all BN Cout: per stage, tap by tap, the A
    // fragment (64 pixels x 16 channels) from the window at the tap's
    // column shift, by ldmatrix (CL) or 16-bit shared loads (normalized
    // with NORM), then the tap's wgmma with its weights as B, which runs
    // while the next tap's fragment is loaded ------------------------------
    reg_alloc<224>();
    const int ctid = threadIdx.x - 128;
    const int cw = ctid >> 7;
    const int warp = (ctid >> 5) & 3, lane = ctid & 31;
    const int g = lane >> 2, q4 = lane & 3;
    const int ct = 1 << p.ct_lg;
    const uint32_t base = smem_u32(smem);
    float* vec = reinterpret_cast<float*>(smem + p.vec_off);
    int s = 0, held = -1;  // held: the sample whose vectors vec holds
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile u = tile_of(p, t, BN);
      const int b = u.b, m0 = u.m0, oy0 = u.oy0, ox0 = u.ox0;
      const int da = u.par >> 1, db = u.par & 1;
      const int KHp = par_taps(a.KH, a.npar, da);
      const int KWp = par_taps(a.KW, a.npar, db);
      const int pw = a.pad_w - db;
      const int nsteps = (a.Cin + BK - 1) / BK * KHp;
      if (NORM && b != held) {
        // both warpgroups walk the same tiles: the fold's first barrier
        // finds the other one done with the last tile's fragments
        fold_norm<256>(p.nm, b, a, vec, fsh, ctid,
                       [] { named_sync(1, 256); });
        held = b;
      }

      // the window address of this thread's fragment elements, per tap kw,
      // pixel half h (row g or g + 8 of the warp's 16) and channel parity e
      // (channel 2 q4 + e, then + 8 t + 16 kk at `line` bytes a channel)
      uint32_t aoff[kMaxKW][2][2], line[kMaxKW][2];
      // CL: this lane's ldmatrix row per tap kw, pixel 16 warp + (lane & 15)
      // of the warpgroup's 64, channels 8 (lane >> 4) + 16 kk of the chunk
      // (matrix lane >> 3 of the x4: pixel half, then channel half), its
      // 16-byte chunk swizzled by its line's key; + 16 kk channels is the
      // chunk's bits 1-2, XOR kk << 5
      uint32_t arow[kMaxKW];
      const uint32_t mmask = (uint32_t)(ctw / 8) - 1;  // main box swizzle
      if constexpr (CL) {
        const int m = 64 * cw + 16 * warp + (lane & 15);
        const int pr = m >> p.ct_lg, pc = m & (ct - 1);
#pragma unroll
        for (int kw = 0; kw < kMaxKW; ++kw) {
          const uint32_t o =
              cl_line(p, pr, pc * a.stride + kw * a.dil - pw + kHaloCL,
                      ox0 * a.stride, ctw + 2 * kHaloCL);
          arow[kw] = o | ((((o >> 7) ^ (uint32_t)(lane >> 4)) & 7u) << 4);
        }
      }
#pragma unroll
      for (int kw = 0; kw < kMaxKW; ++kw)
#pragma unroll
        for (int h = 0; h < 2 && !CL; ++h) {
          const int m = 64 * cw + 16 * warp + g + 8 * h;
          const int pr = m >> p.ct_lg, pc = m & (ct - 1);
          const int wc = pc * a.stride + kw * a.dil - pw + kHalo;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = 2 * q4 + e;
            uint32_t o;
            if (wc < kHalo) {
              o = p.halo_off - p.win_off + ((pr * BK + ch) * kHalo + wc) * 2;
            } else if (wc >= ctw + kHalo) {
              o = p.halo_off - p.win_off + halo_bytes(p.rows) +
                  ((pr * BK + ch) * kHalo + wc - ctw - kHalo) * 2;
            } else {
              const uint32_t o0 = ((pr * BK + ch) * ctw + wc - kHalo) * 2;
              o = o0 ^ (((o0 >> 7) & mmask) << 4);
            }
            aoff[kw][h][e] = o;
          }
          line[kw][h] = wc < kHalo || wc >= ctw + kHalo ? kHalo * 2 : ctw * 2;
        }

      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      float4 ab[BK / 16][2];  // the layer norm's a, b of the fragments
      for (int j = 0; j < nsteps; ++j) {
        mbar_wait(&full[s], phase);
        const uint32_t st = base + s * p.stage_bytes;
        const uint32_t win = st + p.win_off;
        if (NORM && j % KHp == 0) {
          // this thread's channel pairs c0 + 16 kk + 8 t + 2 q4 of the
          // chunk, for its KHp stages
          const int c0 = j / KHp * BK;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int t = 0; t < 2; ++t)
              ab[kk][t] = *reinterpret_cast<const float4*>(
                  vec + ((c0 + 16 * kk + 8 * t + 2 * q4) >> 1) * 4);
        }
        uint32_t af[kMaxKW][4][4];
        fence_regs<BN / 2>(acc);
#pragma unroll
        for (int kw = 0; kw < kMaxKW; ++kw) {
          if (kw >= KWp) break;
#pragma unroll
          for (int kk = 0; kk < BK / 16 && CL; ++kk) {
            ldsm_x4(af[kw][kk], win + (arow[kw] ^ (uint32_t)(kk << 5)));
#pragma unroll
            for (int i = 0; i < 4 && NORM; ++i)
              af[kw][kk][i] = norm_frag(af[kw][kk][i], ab[kk][i >> 1]);
          }
#pragma unroll
          for (int kk = 0; kk < BK / 16 && !CL; ++kk)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t d = (16 * kk + 8 * t) * line[kw][h];
                const uint32_t v = lds_u16(win + aoff[kw][h][0] + d) |
                                   lds_u16(win + aoff[kw][h][1] + d) << 16;
                af[kw][kk][h + 2 * t] = NORM ? norm_frag(v, ab[kk][t]) : v;
              }
          wg_fence();
          const uint64_t dW = make_desc(st + kw * kTapW, kBoxW, 1024, 1);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs<BN>(acc, af[kw][kk], dW + (uint64_t)((kk * 2048) >> 4));
        }
        wg_commit();
        wg_wait<0>();
        fence_regs<BN / 2>(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == p.stages) {
          s = 0;
          phase ^= 1u;
        }
      }

      // ---- epilogue: fragment d[4j + 2h + e] is pixel 16 warp + g + 8h of
      // the warpgroup's 64, Cout m0 + 8j + 2 q4 + e ---------------------------
      const bool sub = a.npar == 4;
      if (p.mode == kCoord) {
        // the tile's coord weights, [tap][Cout in the tile], f32 of bf16,
        // once the other warpgroup is done with the last tile's
        named_sync(1, 256);
        for (int i = ctid; i < 9 * BN; i += 256) {
          const int t = i / BN, m = m0 + i % BN;
          const int kh = t / 3, kw = t % 3;
          wcs[t][i % BN] =
              m < a.Cout && kh < a.KH && kw < a.KW
                  ? matry::to_f32(__ushort_as_bfloat16(
                        w[((long long)(kh * a.KW + kw) * Ck + a.Cin) * a.Cout +
                          m]))
                  : 0.f;
        }
        named_sync(1, 256);
      }
      float s1 = 0.f, s2 = 0.f;
      bool nchw = true;
      if constexpr (CLO) {
        if (p.cl_out) {
          // channels-last bf16: the values packed a channel pair a register
          // (the accumulator's fragment layout) and stored by stmatrix,
          // four 8-channel chunks at a time, into the tile buffer, which
          // store_tile_cl copies out. Every lane takes part in the
          // stmatrix, a pixel outside the output too
          nchw = false;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 64 * cw + 16 * warp + g + 8 * h;
            const int oy = oy0 + (m >> p.ct_lg);
            const int ox = ox0 + (m & (ct - 1));
            const bool inside = oy < a.Ho && ox < a.Wo;
            float cf[9];
            if (p.mode == kCoord && inside)
              coord_factors(cf, coord, a, oy, ox);
#pragma unroll
            for (int jq = 0; jq < BN / 32; ++jq) {
              uint32_t pk[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int jn = 4 * jq + i;
                pk[i] = 0u;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int n = m0 + 8 * jn + 2 * q4 + e;
                  if (!inside || n >= a.Cout) continue;
                  float v = acc[4 * jn + 2 * h + e];
                  if (p.mode == kCoord) {
                    // the coord channel: the exact bf16 products in tap
                    // order
                    float c = 0.f;
#pragma unroll
                    for (int t9 = 0; t9 < 9; ++t9)
                      c = fmaf(wcs[t9][n - m0], cf[t9], c);
                    v += c;
                  }
                  v += __ldg(bias + n);
                  if (a.act == 1) v = tanhf(v);
                  const __nv_bfloat16 qv = __float2bfloat16(v);
                  pk[i] |= (uint32_t)__bfloat16_as_ushort(qv) << (16 * e);
                  if (p.stats) {
                    const float r = __bfloat162float(qv);
                    s1 += r;
                    s2 += r * r;
                  }
                }
              }
              // chunk 4 jq + i of row 16 warp + 8 h + lane % 8 from lane
              // 8 i + lane % 8, its 16 bytes at chunk ^ (row % 8)
              const int row = 16 * warp + 8 * h + (lane & 7);
              stsm_x4(smem_u32(smem + p.out_off) + (cw * 64 + row) * BN * 2 +
                          (((4 * jq + (lane >> 3)) ^ (lane & 7)) << 4),
                      pk[0], pk[1], pk[2], pk[3]);
            }
          }
          store_tile_cl<BN>(p, smem + p.out_off, out, b, da, db, m0, oy0,
                            ox0, cw, ctid & 127);
        }
      }
      if (nchw) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 64 * cw + 16 * warp + g + 8 * h;
          const int oy = oy0 + (m >> p.ct_lg);
          const int ox = ox0 + (m & (ct - 1));
          if (oy >= a.Ho || ox >= a.Wo) continue;
          const long long pix =
              sub ? (long long)(2 * oy + da) * a.out_w + 2 * ox + db
                  : (long long)oy * a.out_w + ox;
          float cf[9];
          if (p.mode == kCoord) coord_factors(cf, coord, a, oy, ox);
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = m0 + 8 * jn + 2 * q4 + e;
              if (n >= a.Cout) continue;
              float v = acc[4 * jn + 2 * h + e];
              if (p.mode == kCoord) {
                // the coord channel: the exact bf16 products in tap order
                float c = 0.f;
#pragma unroll
                for (int t9 = 0; t9 < 9; ++t9)
                  c = fmaf(wcs[t9][n - m0], cf[t9], c);
                v += c;
              }
              v += __ldg(bias + n);
              if (a.act == 1) v = tanhf(v);
              const long long o =
                  ((long long)b * a.Cout + n) * a.out_h * a.out_w + pix;
              float r;
              if (p.out_f32) {
                static_cast<float*>(out)[o] = v;
                r = v;
              } else {
                const __nv_bfloat16 qv = __float2bfloat16(v);
                static_cast<__nv_bfloat16*>(out)[o] = qv;
                r = __bfloat162float(qv);
              }
              if (p.stats) {
                s1 += r;
                s2 += r * r;
              }
            }
        }
      }
      if (p.stats) {
        // butterfly within each warp, the eight warp sums in order by the
        // first consumer thread: one partial per (sample, tile)
        for (int off = 16; off > 0; off >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (lane == 0) {
          red[0][cw * 4 + warp] = s1;
          red[1][cw * 4 + warp] = s2;
        }
        named_sync(1, 256);
        if (ctid == 0) {
          float t1 = 0.f, t2 = 0.f;
          for (int i = 0; i < 8; ++i) {
            t1 += red[0][i];
            t2 += red[1][i];
          }
          float* pb = partial + ((long long)b * p.stat_blocks +
                                 (long long)u.par * p.mtiles * p.ntx * p.nty +
                                 u.local) * 2;
          pb[0] = t1;
          pb[1] = t2;
        }
        named_sync(1, 256);  // red is free for the next tile
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32 operands: exact f32 FMA on the CUDA cores.
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BM = 64;   // output channels per block
constexpr int BN = 128;  // output pixels per block
constexpr int BK = 16;   // reduction step
constexpr int TM = 4;    // channels per thread
constexpr int TN = 8;    // pixels per thread

// partial: null, or the STATS partials [B, npar * gridDim.y * gridDim.x,
// 2]; nm: the input's layer norm, its vectors in dynamic shared memory
// (vec_bytes).
template <typename TO, int MODE>
__global__ void __launch_bounds__(256)
    conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ coord, TO* __restrict__ out,
                    float* __restrict__ partial, ConvArgs a, Norm nm) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[2][256 / 32];
  __shared__ double fsh[2][8];
  extern __shared__ float vec[];  // the norm's vectors (vec_bytes)

  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int b = z / a.npar;
  if (nm.nsrc)
    fold_norm<256>(nm, b, a, vec, fsh, tid, [] { __syncthreads(); });
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
            if (nm.nsrc) v = norm_relu(v, vec_a(vec, c), vec_b(vec, c));
          } else {
            const int ix = ix0 + kw * a.dil;
            if (ix >= 0 && ix < a.Wi) {
              if (MODE == kCoord && c == a.Cin) {
                v = coord[iy];
              } else {
                v = xb[((long long)c * a.Hi + iy) * a.Wi + ix];
                if (nm.nsrc)
                  v = norm_relu(v, vec_a(vec, c), vec_b(vec, c));
              }
            }
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
      if (partial) {
        const float r = matry::to_f32(q);
        s1 += r;
        s2 += r * r;
      }
    }
  }
  if (partial)
    block_stats<256>(s1, s2, red,
                     partial + (((long long)z * gridDim.y + blockIdx.y) *
                                    gridDim.x + blockIdx.x) * 2);
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

// ---------------------------------------------------------------------------
// The bf16 plan: tile and producer per launch (ops/conv.conv_plan mirrors
// it in Python).
// ---------------------------------------------------------------------------

// The tiles, Cout x pixels: 0: 128 x 128, 1: 64 x 128.
constexpr int kTileBM[2] = {128, 64};

struct Plan {
  int tile;    // index into kTileBM
  int ct_lg;   // log2 of the output columns of a tile: 6, 5 or 4
  int tma_x;   // the patch windows by TMA (else gathered)
  int tma_w;   // the weights by TMA (else gathered)
};

// Columns: the widest of 64, 32, 16 that divides Wo (16 otherwise, the
// last column tile ragged), at most 32 at stride 2 (the window's main box,
// two columns an output one, is at most 64 wide). Tile: 128 Cout where
// Cout > 64, else 64 (the persistent blocks need no count of waves; the
// tools/variants.py times of 128 against 64 at every stage). Patch
// windows by TMA at stride 1 or 2 when x's innermost line is a multiple
// of 16 bytes (Wi % 8 == 0 for NCHW x, Cin % 8 == 0 for channels-last x,
// cl) and, in wrap mode, the column tiles divide Wo (a ragged tile's right
// halo would not be the wrapped columns), else gathered; weights by TMA
// when Cout % 8 == 0.
Plan make_plan(int Cin, int Wi, int Cout, int Wo, int stride, int zero_w,
               int cl) {
  Plan p;
  p.ct_lg = Wo % 64 == 0 ? 6 : Wo % 32 == 0 ? 5 : 4;
  if (stride == 2 && p.ct_lg > 5) p.ct_lg = 5;
  const int ct = 1 << p.ct_lg;
  p.tile = Cout > 64 ? 0 : 1;
  p.tma_x = (stride == 1 || stride == 2) && (cl ? Cin : Wi) % 8 == 0 &&
            (zero_w || Wo % ct == 0);
  p.tma_w = Cout % 8 == 0;
  return p;
}

int plan_code(const Plan& p) {
  return p.tile | (p.ct_lg - 4) << 2 | p.tma_x << 4 | p.tma_w << 5;
}

// x [B, Cin, Hi, Wi] bf16 as the 4-D tensor (W, C, H, B): box {cols, 64,
// rows * stride, 1} taking every stride-th row, the swizzle as wide as a
// box row (none for the 16-byte halo boxes); zeros outside the input, or
// NaN for a launch with the layer norm (nan_fill).
int encode_x(CUtensorMap* m, const void* x, const ConvArgs& a, int cols,
             int rows, int nan_fill) {
  return matry::hop::encode_nchw(m, x, a.B, a.Cin, a.Hi, a.Wi, cols, wg::BK,
                                 rows * a.stride, a.stride,
                                 cols == wg::kHalo ? 0 : 2 * cols, nan_fill);
}

// The packed weight [krows, Cout] bf16, box {64, 64}, 128-byte swizzle.
int encode_w(CUtensorMap* m, const void* w, int cout, int krows) {
  matry::hop::MapKey k;
  memset(&k, 0, sizeof(k));
  k.ptr = w;
  k.rank = 2;
  k.dims[0] = cout;
  k.dims[1] = krows;
  k.strides[0] = (cuuint64_t)cout * 2;
  k.box[0] = 64;
  k.box[1] = wg::BK;
  k.es[0] = k.es[1] = 1;
  k.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  return matry::hop::encode_cached(m, k);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

void finish_stats(const ConvArgs& a, int nblk, void* partial, void* stats,
                  cudaStream_t s) {
  stats_fold<<<a.B, 256, 0, s>>>((const float*)partial, (double*)stats,
                                 nblk);
}

// The bf16 launch's shared memory: a stage's bytes (the KW taps' weights
// and the window: the main box and two halos, or for channels-last x, cl,
// the window's box and two seam boxes), the norm's vectors after the ring,
// the output tile after them (cl_out: a channels-last bf16 output, 128
// pixels x the tile's Cout), the ring depth (at most kStages, as many as
// the budget holds beside the vectors and the tile; 0 if fewer than 2: the
// launch refuses the shape) and the dynamic bytes the launch asks for (the
// ring, the vectors, the tile and 1024 for the alignment).
// ops/conv.conv_smem mirrors it.
struct Smem {
  int stage_bytes, vec_bytes, out_bytes, stages, dynamic;
};
Smem smem_of(const ConvArgs& a, const Plan& pl, int norm, int cl,
             int cl_out) {
  const int bn = kTileBM[pl.tile];
  const int rows = wg::kTilePx >> pl.ct_lg;
  Smem m;
  const int ctw = a.stride << pl.ct_lg;
  m.stage_bytes = a.KW * (bn / 64) * wg::kBoxW +
                  (cl ? wg::cl_main_bytes(rows, ctw) +
                            2 * wg::cl_halo_region(rows)
                      : wg::main_bytes(rows, ctw) + 2 * wg::halo_bytes(rows));
  m.vec_bytes = norm ? vec_bytes(a.Cin) : 0;
  m.out_bytes = cl_out ? wg::kTilePx * bn * 2 : 0;
  m.stages = (wg::kSmemBudget - m.vec_bytes - m.out_bytes) / m.stage_bytes;
  if (m.stages > wg::kStages) m.stages = wg::kStages;
  if (m.stages < 2) m.stages = 0;
  m.dynamic = m.stages * m.stage_bytes + m.vec_bytes + m.out_bytes + 1024;
  return m;
}

// Partials a sample of the STATS epilogue: one per (parity, pixel tile,
// Cout tile) of the bf16 kernel, one per block of the f32 kernel.
int stat_blocks(const ConvArgs& a, const Plan& pl, int in_f32) {
  if (in_f32)
    return cdiv(a.Ho * a.Wo, f32::BN) * cdiv(a.Cout, f32::BM) * a.npar;
  return cdiv(a.Wo, 1 << pl.ct_lg) * cdiv(a.Ho, wg::kTilePx >> pl.ct_lg) *
         cdiv(a.Cout, kTileBM[pl.tile]) * a.npar;
}

template <int BN, bool NORM, bool CL, bool CLO>
int launch_wg(const void* x, const void* w, const void* bias,
              const void* coord, void* out, void* partial, void* stats,
              const Norm& nm, const ConvArgs& a, const Plan& pl, int mode,
              int out_f32, int cl_out, cudaStream_t s) {
  // a channels-last output is bf16 in whole 16-byte chunks of a pixel
  if (cl_out && (!CLO || out_f32 || a.Cout % 8))
    return (int)cudaErrorInvalidValue;
  auto kern = wg::conv_wgmma_kernel<BN, NORM, CL, CLO>;
  static bool attr = false;  // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg::kSmemBudget + 1024);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const Smem sm = smem_of(a, pl, nm.nsrc, CL, cl_out);
  if (!sm.stages) return (int)cudaErrorInvalidValue;
  wg::Params p;
  memset(&p, 0, sizeof(p));
  p.a = a;
  p.nm = nm;
  p.mode = mode;
  p.stats = partial != nullptr;
  p.out_f32 = out_f32;
  p.cl_out = cl_out;
  p.ct_lg = pl.ct_lg;
  p.rows = wg::kTilePx >> pl.ct_lg;
  p.ntx = cdiv(a.Wo, 1 << pl.ct_lg);
  p.nty = cdiv(a.Ho, p.rows);
  p.mtiles = cdiv(a.Cout, BN);
  p.stat_blocks = stat_blocks(a, pl, 0);
  p.tma_x = pl.tma_x && aligned16(x);
  p.tma_w = pl.tma_w && aligned16(w);
  p.halo = !(a.KW == 1 && a.pad_w == 0);
  p.krows = a.npar * a.KH * a.KW * (a.Cin + (mode == kCoord));
  const int ctw = a.stride << pl.ct_lg;
  p.win_off = a.KW * (BN / 64) * wg::kBoxW;
  p.halo_off = p.win_off + (CL ? wg::cl_main_bytes(p.rows, ctw)
                                : wg::main_bytes(p.rows, ctw));
  p.hb = CL ? wg::cl_halo_region(p.rows) : wg::halo_bytes(p.rows);
  p.stage_bytes = sm.stage_bytes;
  p.stages = sm.stages;
  p.vec_off = p.stages * p.stage_bytes;
  p.out_off = p.vec_off + sm.vec_bytes;
  CUtensorMap tmx, tmh, tmw;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmh, 0, sizeof(tmh));
  memset(&tmw, 0, sizeof(tmw));
  if (p.tma_x && CL) {
    using matry::hop::encode_nhwc;
    int e = encode_nhwc(&tmx, x, a.B, a.Cin, a.Hi, a.Wi,
                        ctw + 2 * wg::kHaloCL, p.rows * a.stride, a.stride,
                        nm.nsrc);
    if (!e && p.halo)
      e = encode_nhwc(&tmh, x, a.B, a.Cin, a.Hi, a.Wi, wg::kHaloCL,
                      p.rows * a.stride, a.stride, nm.nsrc);
    if (e) return e;
  } else if (p.tma_x) {
    int e = encode_x(&tmx, x, a, ctw, p.rows, nm.nsrc);
    if (!e && p.halo) e = encode_x(&tmh, x, a, wg::kHalo, p.rows, nm.nsrc);
    if (e) return e;
  }
  if (p.tma_w) {
    const int e = encode_w(&tmw, w, a.Cout, p.krows);
    if (e) return e;
  }
  // persistent: a block per SM, each walking the tiles blockIdx.x +
  // k * gridDim.x
  const int ntiles = p.stat_blocks * a.B;
  const int sms = matry::hop::num_sms();
  const dim3 grid(ntiles < sms ? ntiles : sms);
  kern<<<grid, wg::kThreads, sm.dynamic, s>>>(
      tmx, tmh, tmw, (const unsigned short*)x, (const unsigned short*)w,
      (const float*)bias, (const float*)coord, out, (float*)partial, p);
  if (stats) finish_stats(a, p.stat_blocks, partial, stats, s);
  return 0;
}

int launch_bf16(const void* x, const void* w, const void* bias,
                const void* coord, void* out, void* partial, void* stats,
                const Norm& nm, const ConvArgs& a, const Plan& pl, int mode,
                int out_f32, int cl_in, int cl_out, cudaStream_t s) {
  // a tap's columns lie within the window's halos: shifts of -8 .. 8
  // (NCHW x), or of -2 .. 2 past the tile's columns (channels-last x; a
  // parity form's right shift one more than its pads say)
  if (a.pad_w > wg::kHalo || (a.KW - 1) * a.dil - a.pad_w > wg::kHalo ||
      a.KW > wg::kMaxKW || a.KH > 3 || (a.stride != 1 && a.stride != 2))
    return (int)cudaErrorInvalidValue;
  if (cl_in) {
    // every channels-last input of the net is layer-normed
    if (!nm.nsrc || a.pad_w > wg::kHaloCL ||
        (a.KW - 1) * a.dil - a.pad_w + (a.npar == 4) - (a.stride - 1) >
            wg::kHaloCL)
      return (int)cudaErrorInvalidValue;
    if (pl.tile == 0)
      return launch_wg<128, true, true, true>(x, w, bias, coord, out,
                                              partial, stats, nm, a, pl,
                                              mode, out_f32, cl_out, s);
    return launch_wg<64, true, true, true>(x, w, bias, coord, out, partial,
                                           stats, nm, a, pl, mode, out_f32,
                                           cl_out, s);
  }
  if (cl_out) {
    // NCHW x, channels-last output: the net's first conv (64 Cout, its
    // input the sweep's volume, not normed)
    if (pl.tile == 0 || nm.nsrc) return (int)cudaErrorInvalidValue;
    return launch_wg<64, false, false, true>(x, w, bias, coord, out, partial,
                                             stats, nm, a, pl, mode, out_f32,
                                             cl_out, s);
  }
  if (pl.tile == 0 && nm.nsrc)
    return launch_wg<128, true, false, false>(x, w, bias, coord, out,
                                              partial, stats, nm, a, pl,
                                              mode, out_f32, 0, s);
  if (pl.tile == 0)
    return launch_wg<128, false, false, false>(x, w, bias, coord, out,
                                               partial, stats, nm, a, pl,
                                               mode, out_f32, 0, s);
  if (nm.nsrc)
    return launch_wg<64, true, false, false>(x, w, bias, coord, out, partial,
                                             stats, nm, a, pl, mode, out_f32,
                                             0, s);
  return launch_wg<64, false, false, false>(x, w, bias, coord, out, partial,
                                            stats, nm, a, pl, mode, out_f32,
                                            0, s);
}

template <typename TO, int MODE>
int launch_f32(const void* x, const void* w, const void* bias,
               const void* coord, void* out, void* partial, void* stats,
               const Norm& nm, const ConvArgs& a, cudaStream_t s) {
  const dim3 grid(cdiv(a.Ho * a.Wo, f32::BN), cdiv(a.Cout, f32::BM),
                  a.B * a.npar);
  const int vec = nm.nsrc ? vec_bytes(a.Cin) : 0;
  if (vec > 32 * 1024) return (int)cudaErrorInvalidValue;
  f32::conv_f32_kernel<TO, MODE><<<grid, 256, vec, s>>>(
      (const float*)x, (const float*)w, (const float*)bias,
      (const float*)coord, (TO*)out, (float*)partial, a, nm);
  if (stats) finish_stats(a, grid.x * grid.y * a.npar, partial, stats, s);
  return 0;
}

template <typename TO>
int launch_f32_mode(const void* x, const void* w, const void* bias,
                    const void* coord, void* out, void* partial, void* stats,
                    const Norm& nm, const ConvArgs& a, int mode,
                    cudaStream_t s) {
  if (mode == kCoord)
    return launch_f32<TO, kCoord>(x, w, bias, coord, out, partial, stats, nm,
                                  a, s);
  if (mode == kZero)
    return launch_f32<TO, kZero>(x, w, bias, coord, out, partial, stats, nm,
                                 a, s);
  return launch_f32<TO, kWrap>(x, w, bias, coord, out, partial, stats, nm, a,
                               s);
}

}  // namespace

// The bf16 launch's plan for this shape, as plan_code packs it: tile
// (bit 0: 128 or 64 Cout x 128 pixels), log2(tile columns) - 4 (bits 2-3),
// patch windows by TMA (bit 4), weights by TMA (bit 5); cl: x
// channels-last. It assumes 16-byte aligned x and w (the launch gathers an
// operand that is not).
extern "C" int matry_conv_plan(int Cin, int Wi, int Cout, int Wo,
                               int stride, int zero_w, int cl) {
  return plan_code(make_plan(Cin, Wi, Cout, Wo, stride, zero_w, cl));
}

// Partials a sample that a launch of this shape with STATS writes
// (stat_blocks; ops/conv.stats_blocks mirrors it); Ho, Wo: the GEMM grid
// (per parity for npar 4).
extern "C" int matry_conv_stats_blocks(int Wi, int Cout, int Ho, int Wo,
                                       int stride, int npar, int zero_w,
                                       int in_f32) {
  ConvArgs a;
  memset(&a, 0, sizeof(a));
  a.Cout = Cout;
  a.Ho = Ho;
  a.Wo = Wo;
  a.npar = npar;
  return stat_blocks(a, make_plan(0, Wi, Cout, Wo, stride, zero_w, 0),
                     in_f32);
}

// The dynamic shared memory (bytes) a bf16 launch of this shape asks for,
// with (norm != 0) or without the layer norm's vectors, x channels-last
// (cl != 0) or NCHW, out channels-last bf16 (cl_out != 0) or not; 0 if the
// launch refuses the shape (its ring does not fit beside the vectors and
// the output tile, or a channels-last output with Cout % 8 != 0).
extern "C" int matry_conv_smem(int Cin, int Wi, int Cout, int Wo, int KW,
                               int stride, int zero_w, int norm, int cl,
                               int cl_out) {
  ConvArgs a;
  memset(&a, 0, sizeof(a));
  a.Cin = Cin;
  a.KW = KW;
  a.stride = stride;
  if (cl_out && Cout % 8) return 0;
  const Smem m = smem_of(
      a, make_plan(Cin, Wi, Cout, Wo, stride, zero_w, cl), norm, cl, cl_out);
  return m.stages ? m.dynamic : 0;
}

// coord: null, or the coord channel's f32 value per input row [Hi] (then
// zero_w must be set); zero_w: zero horizontal padding, else wrap. in_f32:
// x and w are float32 (the f32 kernel), else bfloat16 (the wgmma kernel).
// partial: null, or the STATS epilogue's partials [B, nblk, 2] f32, nblk
// the launch's partials a sample (ops/conv.stats_blocks; checked here);
// stats: null, or (with partial) their fold, f64 [B, 2] = (sum y, sum y^2)
// per sample, by stats_fold (K7c). nsrc: 0, or the sources of x's layer
// norm (1, or 2 for a skip concat whose first source has c0 channels),
// source i with its producer's partials part_i [B, nblk_i, 2] and its
// gamma_i, beta_i (f32, one per channel of the source). cl_in, cl_out: x,
// out channels-last (NHWC memory of the [B, C, H, W] tensor), else NCHW:
// bf16 x only, cl_in with the layer norm, cl_out a bf16 output with Cout %
// 8 == 0 from x channels-last, or from NCHW x without the norm at 64 Cout
// (the net's first conv); other combinations return
// cudaErrorInvalidValue.
extern "C" int matry_conv(const void* x, const void* w, const void* bias,
                          const void* coord, void* out, int B, int Cin,
                          int Hi, int Wi, int Cout, int Ho, int Wo, int KH,
                          int KW, int stride, int dil, int pad_h, int pad_w,
                          int npar, int out_h, int out_w, int act,
                          int in_f32, int out_f32, int zero_w, void* partial,
                          void* stats, int nblk, int nsrc, int c0,
                          const void* part0, const void* gamma0,
                          const void* beta0, int nblk0, const void* part1,
                          const void* gamma1, const void* beta1, int nblk1,
                          int cl_in, int cl_out, void* stream) {
  const ConvArgs a{B,  Cin,    Hi,  Wi,    Cout,  Ho,    Wo,
                   KH, KW,     stride, dil, pad_h, pad_w, npar,
                   out_h, out_w, act};
  cudaStream_t s = (cudaStream_t)stream;
  if (coord && !zero_w) return (int)cudaErrorInvalidValue;
  const int mode = coord ? kCoord : (zero_w ? kZero : kWrap);
  const Plan pl = make_plan(Cin, Wi, Cout, Wo, stride, mode != kWrap, cl_in);
  if (in_f32 && (cl_in || cl_out)) return (int)cudaErrorInvalidValue;
  if ((stats && !partial) ||
      (partial && nblk != stat_blocks(a, pl, in_f32)))
    return (int)cudaErrorInvalidValue;
  Norm nm;
  memset(&nm, 0, sizeof(nm));
  nm.nsrc = nsrc;
  nm.c0 = c0;
  nm.partial[0] = (const float*)part0;
  nm.partial[1] = (const float*)part1;
  nm.gamma[0] = (const float*)gamma0;
  nm.gamma[1] = (const float*)gamma1;
  nm.beta[0] = (const float*)beta0;
  nm.beta[1] = (const float*)beta1;
  nm.nblk[0] = nblk0;
  nm.nblk[1] = nblk1;
  if (nsrc < 0 || nsrc > 2 ||
      (nsrc && (!part0 || !gamma0 || !beta0 || nblk0 < 1 || c0 < 1 ||
                c0 > Cin || (nsrc == 1) != (c0 == Cin))) ||
      (nsrc == 2 && (!part1 || !gamma1 || !beta1 || nblk1 < 1)))
    return (int)cudaErrorInvalidValue;
  int e;
  if (!in_f32)
    e = launch_bf16(x, w, bias, coord, out, partial, stats, nm, a, pl, mode,
                    out_f32, cl_in, cl_out, s);
  else if (out_f32)
    e = launch_f32_mode<float>(x, w, bias, coord, out, partial, stats, nm, a,
                               mode, s);
  else
    e = launch_f32_mode<__nv_bfloat16>(x, w, bias, coord, out, partial,
                                       stats, nm, a, mode, s);
  if (e) return e;
  return (int)cudaGetLastError();
}
