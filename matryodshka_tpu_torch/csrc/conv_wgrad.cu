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
// H); NCHW, dW [Cout, Cin, 3, 3] and db [Cout] in f32.
//
// Bound: operations (2 * 9 * Cin * Cout * B*H*W; 151 GFLOP per step over
// the eight K7 layers at the flagship shape, 0.153 ms at 989 TFLOP/s in
// bf16). The operands, g and x read once, are 13-105 MB per layer (~0.08
// ms per step at 3.35 TB/s); the f32 split partials below add ~19 MB
// written and read per layer, mostly in L2.
//
// bf16 operands (wgrad_wgmma_kernel) run on Hopper's warpgroup tensor-core
// path, in place of an earlier mma.sync kernel (64 x 32-channel blocks of
// 8 warps, x halo tiles stored three times as shifted copies through
// registers, a separate reduction launch).
//   1. GEMM orientation, per tap (kh, kw): M = 64 input channels, N = 64
//      output channels, K = pixels; the accumulator is dW's tap transposed,
//      [ci][co]. A k-step is KP pixels of one image row (KP = 64, 32 or
//      16, the widest dividing W: 64 at W = 640 and 320, 32 at W = 160).
//      The tap's column shift kw - 1 falls on K, and a TMA box or a wgmma
//      descriptor cannot start between 16-byte groups (conv.cu's note 3),
//      so x is A, in registers: for each k-slice of 16 pixels a thread
//      loads the three 32-bit words of its two channels around its pixel
//      pair (pixels -2, 0, +2) with 32-bit shared loads and makes the
//      three taps' pairs with byte permutes (kw = 0: hi of the left word,
//      lo of the middle; kw = 1: the middle; kw = 2: hi of the middle, lo
//      of the right). g is B through a K-major descriptor: g[co][pixels]
//      is a TMA box {KP, 64} swizzled as wide as its rows (128, 64 or 32
//      bytes), the descriptor stepping 32 bytes a k-slice; one g tile
//      serves all nine taps.
//   2. A block is three warpgroups (384 threads), one per kernel row kh,
//      each holding its row's three taps (3 x 32 f32 a thread),
//      wgmma.mma_async.m64n64k16 with A from registers; within a k-step
//      the A fragments of the next k-slice are loaded while the current
//      one's wgmma run (two register sets). There is no producer
//      warpgroup: ptxas gives a block of 416 or 512 threads 128 registers
//      a thread whatever setmaxnreg later allows, and the consumers then
//      spilled; 384 threads get 168. 64 x 128 tiles would need 192
//      accumulators a thread.
//   3. The ring: kStages stages, each one k-step (b, y, x0): the g tile at
//      (x0, m0, y, b) of a 4-D map over g as (W, Cout, H, B); the x window
//      of rows y-1..y+1 as one box {KP, 64, 3, 1} at (x0, c0, y - 1, b) of
//      a map over x as (W, Cin, H, B), whose out-of-bounds rows load zeros
//      (the vertical padding), and conv.cu's two 8-column halo boxes
//      either side, which carry the wrap by their coordinates (W - 8 left
//      of column 0, 0 right of W - KP). Thread 0 loads the first kStages
//      k-steps; after each k-step every warp counts itself done with the
//      slot in a shared counter, and the twelfth issues the slot's next
//      k-step, so a slot is reloaded the moment it is free. Full
//      mbarriers carry the TMA bytes. Tensor maps come from hopper.cuh's
//      cache, shared with conv.cu.
//   4. Shapes a map cannot express (W % 16 != 0, where a k-step would run
//      past the row end; unaligned operands) gather each stage element by
//      element with the block's threads between two barriers (columns
//      wrapped mod W, zeros past the row end for g, rows outside [0, H)
//      and channels past Cin), in the layout the boxes have.
//   5. db: in blocks of the first Cin tile the threads sum the g tile's
//      16-byte chunks (one or two a thread, the same ones every k-step)
//      in f32, then each row's chunk sums in order through shared memory.
//   6. The pixel sum is split over blocks: a block is (tile, split), the
//      splits as many as keep tiles x splits within one block per SM
//      (make_wplan; ops/wrap_conv.wgrad_plan mirrors it), each a run of
//      whole k-steps. Each block writes its tile's partial (the 9 x 64 x
//      64 accumulators in their fragment order, 16-byte coalesced stores,
//      and the 64 bias sums) to [splits, tiles, kEntries] f32.
//   7. The fold is in the same launch: a cooperative launch (every block
//      resident), one grid-wide barrier, then split z of each tile sums
//      the z-th of S slices of its tile's entries over the S partials in
//      f64 in a fixed order (fold()) and writes them to dW and db. No
//      atomics on the outputs: every output is the same from launch to
//      launch. (A second launch for the fold was slower, PERF.md.)
// What bounds it on the card (tools/variants.py wgrad, PERF.md): the
// stages' loads; the same kernel without its MMAs takes ~85% of its time.
//
// f32 operands (wgrad_f32_kernel) keep exact f32 FMA on the CUDA cores: a
// 64 (Cout) x 128 (column) tile per block, K in steps of 16 pixels staged
// in shared memory, a 4 x 8 register tile per thread; the bias is the
// all-ones column N = 9*Cin; K split over blockIdx.z into pixel chunks;
// wgrad_reduce sums the S partials of each entry in order, in f64.

#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

struct WArgs {
  int B, Cin, Cout, H, W;
  long long chunk;  // f32: pixels per split
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
// bf16 operands: wgmma fed by TMA (see the note above).
// ---------------------------------------------------------------------------
namespace wg {

using namespace matry::hop;

constexpr int BC = 64;          // input channels of a tile (wgmma M)
constexpr int BN = 64;          // output channels of a tile (wgmma N)
constexpr int kHalo = 8;        // window columns each side of a k-step
constexpr int kThreads = 384;  // three warpgroups, one per kernel row
// Ring depth, at most as many stages as kSmemBudget holds
// (tools/variants.py times others); mbarriers for up to kMaxStages.
constexpr int kStages = 4;
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 200 * 1024;
constexpr int kTapEntries = BC * BN;            // one tap's accumulators
constexpr int kEntries = 9 * kTapEntries + BN;  // a tile's partial, floats
constexpr int kWarps = kThreads / 32;  // a slot is freed by all of them

// A stage's layout for k-steps of KP pixels (all offsets multiples of
// 1024): the g tile [64 co][KP] and the x window's main box [3 rows][64
// ci][KP], both swizzled as wide as their L-byte rows, then the left and
// right halo boxes [3][64][8].
template <int KP>
struct Geo {
  static constexpr int L = 2 * KP;
  static constexpr int kG = BN * L;
  static constexpr int kX = 3 * BC * L;
  static constexpr int kH = 3 * BC * kHalo * 2;
  static constexpr int kXOff = kG;
  static constexpr int kHL = kG + kX;
  static constexpr int kHR = kHL + kH;
  static constexpr int kStage = kHR + kH;
  static constexpr uint32_t kMask = L / 16 - 1;  // swizzle of L-byte rows
  static constexpr int kLayout = KP == 64 ? 1 : KP == 32 ? 2 : 3;
  static constexpr int kSlices = KP / 16;        // k-slices of a k-step
  static_assert(kStage % 1024 == 0, "stages stay 1024-byte aligned");
};

// The TMA swizzle of an offset within a box of L-byte rows.
template <int KP>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & Geo<KP>::kMask) << 4);
}

struct Params {
  int B, Cin, Cout, H, W;
  int kpr;      // k-steps per image row, ceil(W / KP)
  int nk;       // k-steps in all, B * H * kpr
  int chunk;    // k-steps per split
  int splits;
  int ctiles, mtiles;  // Cin and Cout tiles
  int tma;      // stages by TMA (else gathered)
  int stages;   // ring depth
  int coop;     // cooperative launch: a grid-wide barrier before the fold
};

// A block's tile and split, the tile's first input and output channel,
// and the offset of its partial in floats.
struct Block {
  int tile, z, c0, m0;
  long long part;
};
__device__ __forceinline__ Block block_of(const Params& p, uint32_t bid) {
  const int tiles = p.ctiles * p.mtiles;
  Block b;
  b.tile = (int)bid % tiles;
  b.z = (int)bid / tiles;
  b.c0 = (b.tile / p.mtiles) * BC;
  b.m0 = (b.tile % p.mtiles) * BN;
  b.part = ((long long)b.z * tiles + b.tile) * kEntries;
  return b;
}

__device__ __forceinline__ void st16(unsigned char* p, const uint32_t* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// Any row pitch: one stage gathered element by element by the block's
// threads, laid out as the TMA boxes lie.
template <int KP>
__device__ __forceinline__ void gather_stage(unsigned char* st,
                                             const unsigned short* g,
                                             const unsigned short* x,
                                             const Params& p, int b, int y,
                                             int x0, int m0, int c0,
                                             int tid) {
  using G = Geo<KP>;
  constexpr int cpl = KP / 8;  // 16-byte chunks of a box row
  for (int q = tid; q < BN * cpl; q += kThreads) {
    const int r = q / cpl, cc = q - r * cpl;
    const int co = m0 + r;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (co < p.Cout) {
      const unsigned short* src =
          g + (((long long)b * p.Cout + co) * p.H + y) * p.W;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int px = x0 + 8 * cc + e;
        if (px < p.W) v[e >> 1] |= (uint32_t)src[px] << (16 * (e & 1));
      }
    }
    st16(st + swz<KP>(r * G::L + cc * 16), v);
  }
  // x: lines (row r3 of y-1..y+1, channel) of cpl + 2 chunks, the first
  // the left halo, the last the right halo; columns x0 - 8 + j wrapped
  constexpr int cpx = cpl + 2;
  for (int q = tid; q < 3 * BC * cpx; q += kThreads) {
    const int line = q / cpx, cc = q - line * cpx;
    const int c = c0 + (line & (BC - 1)), iy = y - 1 + line / BC;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (c < p.Cin && iy >= 0 && iy < p.H) {
      const unsigned short* src =
          x + (((long long)b * p.Cin + c) * p.H + iy) * p.W;
      const int col0 = x0 - kHalo + 8 * cc;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e >> 1] |= (uint32_t)src[matry::wrap(col0 + e, p.W)]
                     << (16 * (e & 1));
    }
    const uint32_t off =
        cc == 0 ? G::kHL + line * 16
        : cc == cpx - 1 ? G::kHR + line * 16
                        : G::kXOff + swz<KP>(line * G::L + (cc - 1) * 16);
    st16(st + off, v);
  }
}

// 16-byte chunk q (row q / (KP / 8)) of the stage's g tile summed in f32,
// in pixel order.
template <int KP>
__device__ __forceinline__ float chunk_sum(const unsigned char* st, int q) {
  const uint4 u = *reinterpret_cast<const uint4*>(st + swz<KP>(q * 16));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s += __uint_as_float(w[e] << 16) + __uint_as_float(w[e] & 0xffff0000u);
  return s;
}

// The TMA loads of k-step k into ring slot s: the g tile, the x window's
// three rows and its two halo boxes, whose bytes complete full[s].
template <int KP>
__device__ __forceinline__ void load_stage(const Params& p, const Block& blk,
                                           unsigned char* smem,
                                           uint64_t* full,
                                           const CUtensorMap* tmg,
                                           const CUtensorMap* tmx,
                                           const CUtensorMap* tmh, int k,
                                           int s) {
  using G = Geo<KP>;
  const int row = k / p.kpr;
  const int x0 = (k - row * p.kpr) * KP;
  const int b = row / p.H, y = row - b * p.H;
  unsigned char* st = smem + s * G::kStage;
  mbar_arrive_tx(&full[s], G::kStage);
  tma_load_4d(st, tmg, &full[s], x0, blk.m0, y, b);
  tma_load_4d(st + G::kXOff, tmx, &full[s], x0, blk.c0, y - 1, b);
  tma_load_4d(st + G::kHL, tmh, &full[s],
              x0 == 0 ? p.W - kHalo : x0 - kHalo, blk.c0, y - 1, b);
  tma_load_4d(st + G::kHR, tmh, &full[s], x0 + KP >= p.W ? 0 : x0 + KP,
              blk.c0, y - 1, b);
}

// A consumer thread's window addresses (tix its threadIdx.x) for its first
// channel, A row 16 warp + gq of its warpgroup's kernel row kh (the
// second, + 8, lies 8 box rows further, with the same swizzle): the main
// box row, its swizzle, and the halo words next to the main box (pixels
// -2, -1 and KP, KP + 1); and its q4.
struct Lines {
  uint32_t row, xr, hl, hr, q4;
};
template <int KP>
__device__ __forceinline__ Lines lines_of(uint32_t tix) {
  using G = Geo<KP>;
  const uint32_t line =
      (tix >> 7) * BC + 16 * ((tix >> 5) & 3) + ((tix & 31) >> 2);
  return {G::kXOff + line * G::L, (((line * G::L) >> 7) & G::kMask) << 4,
          G::kHL + line * 16 + 12, G::kHR + line * 16, tix & 3};
}

// v, which the compiler may not assume unchanged: addresses computed from
// it stay inside the loop that reads it instead of being hoisted into
// registers held across the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// A fragments of k-slice ks for the three taps: af[kw][i + 2h] holds
// channel i (0: 16 warp + gq, 1: + 8) at pixels p0 + kw - 1 and p0 + kw,
// p0 = 16 ks + 8 h + 2 q4, relative to the k-step's x0.
template <int KP>
__device__ __forceinline__ void load_a(uint32_t (*af)[4], uint32_t st,
                                       const Lines& ln, int ks) {
  const int q4 = (int)ln.q4;
  constexpr int last = Geo<KP>::kSlices - 1;
  constexpr uint32_t kHi = 8 * Geo<KP>::L;  // the second channel's row
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p0 = 16 * ks + 8 * h + 2 * q4;
      const uint32_t mrow = st + ln.row + i * kHi;
      const uint32_t hl = st + ln.hl + i * 128, hr = st + ln.hr + i * 128;
      const uint32_t am = mrow + ((uint32_t)(2 * p0 - 4) ^ ln.xr);
      const uint32_t ap = mrow + ((uint32_t)(2 * p0 + 4) ^ ln.xr);
      const uint32_t w0 = lds_u32(mrow + ((uint32_t)(2 * p0) ^ ln.xr));
      const uint32_t wm = lds_u32(ks == 0 && h == 0 && q4 == 0 ? hl : am);
      const uint32_t wp =
          lds_u32(ks == last && h == 1 && q4 == 3 ? hr : ap);
      af[0][i + 2 * h] = __byte_perm(wm, w0, 0x5432);
      af[1][i + 2 * h] = w0;
      af[2][i + 2 * h] = __byte_perm(w0, wp, 0x5432);
    }
}

// Entry f of a tile's partial: f < 9 * kTapEntries is the fragment value a
// consumer thread stored at f (tap f >> 12, then ((j * 128 + thread) * 4 +
// v) for accumulator 4 j + v of that warpgroup thread); f - 9 *
// kTapEntries is db's. Its place in dW (>= 0), db (-1 - co), or kSkip
// (past Cin or Cout).
constexpr long long kSkip = -(1LL << 40);
__device__ __forceinline__ long long place(const Params& p, int c0, int m0,
                                           int f) {
  if (f < 9 * kTapEntries) {
    const int tap = f >> 12;
    const int rem = f & (kTapEntries - 1);
    const int thr = (rem >> 2) & 127, v = rem & 3;
    const int ci = 16 * (thr >> 5) + ((thr & 31) >> 2) + 8 * (v >> 1);
    const int co = 8 * (rem >> 9) + 2 * (thr & 3) + (v & 1);
    return m0 + co < p.Cout && c0 + ci < p.Cin
               ? ((long long)(m0 + co) * p.Cin + c0 + ci) * 9 + tap
               : kSkip;
  }
  const int co = f - 9 * kTapEntries;
  return m0 + co < p.Cout ? -1 - (m0 + co) : kSkip;
}

__device__ __forceinline__ void put(float* dw, float* db, long long o,
                                    double s) {
  if (o >= 0)
    dw[o] = (float)s;
  else
    db[-1 - o] = (float)s;
}

// Entries [lo, hi) of tile `tile`, each the sum over the S splits'
// partials in f64, written to dW or db: in split order where S <= 16;
// else in P parts of at most 16 consecutive splits each (P a power of two
// up to 32), each summed in order by one of P consecutive lanes, the parts
// then added by a fixed tree of shuffles. The order is fixed by the shape.
__device__ __forceinline__ void fold(const float* __restrict__ partial,
                                     float* __restrict__ dw,
                                     float* __restrict__ db, const Params& p,
                                     int tile, int lo, int hi, int t0,
                                     int nt) {
  const int c0 = (tile / p.mtiles) * BC, m0 = (tile % p.mtiles) * BN;
  const long long zs = (long long)p.ctiles * p.mtiles * kEntries;
  const float* src = partial + (long long)tile * kEntries;
  // parts of the split range a sum is cut into: each part at most 16
  // splits (its loads in flight at once), at most a warp's lanes
  int P = 1;
  while (P < 32 && P * 16 < p.splits) P *= 2;
  if (P == 1) {
    constexpr int U = 4;  // entries a thread sums at once
    for (int f0 = lo + t0; f0 < hi; f0 += U * nt) {
      long long out[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = f0 + u * nt;
        out[u] = f < hi ? place(p, c0, m0, f) : kSkip;
      }
      double s[U] = {};
#pragma unroll 4
      for (int z = 0; z < p.splits; ++z) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[u] = out[u] != kSkip ? __ldcg(src + f0 + u * nt + z * zs) : 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] += v[u];
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (out[u] != kSkip) put(dw, db, out[u], s[u]);
    }
    return;
  }
  // P consecutive lanes per entry, part j summing splits [j S / P, (j + 1)
  // S / P) in order, the parts then added by a fixed tree of shuffles
  const int n = hi - lo;
  for (int q0 = 0; q0 < n * P; q0 += nt) {
    const int q = q0 + t0, part = q % P, f = lo + q / P;
    const long long o = q < n * P ? place(p, c0, m0, f) : kSkip;
    double s = 0.0;
    if (o != kSkip) {
      const int z1 = (part + 1) * p.splits / P;
      int z = part * p.splits / P;
      const float* qf = src + f;
      for (; z + 8 <= z1; z += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(qf + (z + u) * zs);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      for (; z < z1; ++z) s += __ldcg(qf + z * zs);
    }
    for (int off = P / 2; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (part == 0 && o != kSkip) put(dw, db, o, s);
  }
}

// Split z's slice of its tile's entries (the bias sums only in the first
// Cin tile).
__device__ __forceinline__ void slice_of(const Params& p, int tile, int z,
                                         int& lo, int& hi) {
  const long long n = 9 * kTapEntries + (tile / p.mtiles == 0 ? BN : 0);
  lo = (int)(n * z / p.splits);
  hi = (int)(n * (z + 1) / p.splits);
}

__device__ __forceinline__ void sync_all(int coop) {
  if (coop)
    cg::this_grid().sync();
  else
    __syncthreads();
}

template <int KP>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tmg,
                       const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmh,
                       const unsigned short* __restrict__ g,
                       const unsigned short* __restrict__ x,
                       float* __restrict__ partial, float* __restrict__ dw,
                       float* __restrict__ db, const Params p) {
  using G = Geo<KP>;
  constexpr int kChunks = BN * KP / 8;  // 16-byte chunks of a g tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int released[kMaxStages];  // warps done with a slot's k-step
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const Block blk = block_of(p, blockIdx.x);
  const int kbeg = blk.z * p.chunk;
  const int kend = min(kbeg + p.chunk, p.nk);
  const int tid = threadIdx.x;
  const bool bias = blk.c0 == 0;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);  // the issuing thread's arrival, and the bytes
      released[s] = 0;
    }
    fence_mbar_init();
    if (p.tma) {
      prefetch_tmap(&tmg);
      prefetch_tmap(&tmx);
      prefetch_tmap(&tmh);
      for (int k = kbeg; k < kend && k < kbeg + p.stages; ++k)
        load_stage<KP>(p, blk, smem, full, &tmg, &tmx, &tmh, k, k - kbeg);
    }
  }
  __syncthreads();

  // ---- warpgroup kh takes kernel row kh's three taps; per k-slice the A
  // fragments from the window, then three wgmma with the g tile as B; the
  // g tile's chunks tid and tid + kThreads summed for db ---------------------
  const uint32_t base = smem_u32(smem);
  float acc[3][BN / 2];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.f;
  float dsum[2] = {0.f, 0.f};
  for (int k = kbeg; k < kend; ++k) {
    const int i = k - kbeg, s = i % p.stages;
    unsigned char* sp = smem + s * G::kStage;
    if (p.tma) {
      mbar_wait(&full[s], (i / p.stages) & 1);
    } else {
      const int row = k / p.kpr;
      const int b = row / p.H;
      __syncthreads();  // the slot's last reads are done
      gather_stage<KP>(sp, g, x, p, b, row - b * p.H,
                       (k - row * p.kpr) * KP, blk.m0, blk.c0, tid);
      fence_proxy_async();
      __syncthreads();
    }
    if (bias) {
      if (tid < kChunks) dsum[0] += chunk_sum<KP>(sp, tid);
      if (tid + kThreads < kChunks)
        dsum[1] += chunk_sum<KP>(sp, tid + kThreads);
    }
    // the A fragments of k-slice j + 1 are loaded while k-slice j's wgmma
    // run (two register sets), addresses from values read after the last
    // wait, so that none is computed early and held in a register across
    // the wgmma
    uint32_t af[2][3][4];
    load_a<KP>(af[0], opaque(base + s * G::kStage), lines_of<KP>(opaque(tid)),
               0);
#pragma unroll
    for (int j = 0; j < G::kSlices; ++j) {
      const uint32_t st = base + s * G::kStage;
      const uint64_t dB = make_desc(st, 16, 8 * G::L, G::kLayout);
      fence_regs<3 * BN / 2>(&acc[0][0]);
      wg_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
        wgmma_rs<BN, 0>(acc[t], af[j & 1][t],
                        dB + (uint64_t)((j * 32) >> 4));
      wg_commit();
      if (j + 1 < G::kSlices) {
        wg_wait<1>();  // k-slice j - 1's wgmma, which read af[(j + 1) & 1]
        load_a<KP>(af[(j + 1) & 1], opaque(base + s * G::kStage),
                   lines_of<KP>(opaque(tid)), j + 1);
      }
    }
    wg_wait<0>();
    fence_regs<3 * BN / 2>(&acc[0][0]);
    if (p.tma) {
      // the warp is done with slot s; the last of the 12 to say so loads
      // the slot's next k-step (no producer: the loads go out the moment
      // a slot is free, from whichever warp frees it)
      __syncwarp();
      if ((tid & 31) == 0 && atomicAdd(&released[s], 1) == kWarps - 1) {
        released[s] = 0;
        if (k + p.stages < kend)
          load_stage<KP>(p, blk, smem, full, &tmg, &tmx, &tmh,
                         k + p.stages, s);
      }
      __syncwarp();
    }
  }

  // ---- the tile's partial: accumulator 4 j + v of tap 3 kh + t at
  // ((tap * 8 + j) * 128 + thread) * 4 + v, 16-byte stores; the block's
  // place taken again, not held through the loop ----------------------------
  const Block b2 = block_of(p, opaque(blockIdx.x));
  const int kh = tid >> 7, wtid = tid & 127;
  float* part = partial + b2.part;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float4*>(
          part + (((3 * kh + t) * (BN / 8) + j) * 128 + wtid) * 4) =
          make_float4(acc[t][4 * j], acc[t][4 * j + 1], acc[t][4 * j + 2],
                      acc[t][4 * j + 3]);
  if (bias) {
    // db: each row's chunk sums in chunk order, through shared memory (the
    // ring is idle: every k-step was waited for)
    float* cs = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (tid < kChunks) cs[tid] = dsum[0];
    if (tid + kThreads < kChunks) cs[tid + kThreads] = dsum[1];
    __syncthreads();
    if (tid < BN) {
      float r = 0.f;
#pragma unroll
      for (int c = 0; c < KP / 8; ++c) r += cs[tid * (KP / 8) + c];
      part[9 * kTapEntries + tid] = r;
    }
  }
  sync_all(p.coop);
  int lo, hi;
  slice_of(p, b2.tile, b2.z, lo, hi);
  fold(partial, dw, db, p, b2.tile, lo, hi, tid, kThreads);
}

}  // namespace wg

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

// ---------------------------------------------------------------------------
// The bf16 plan (ops/wrap_conv.wgrad_plan mirrors it in Python).
// ---------------------------------------------------------------------------

struct WPlan {
  int kp;      // pixels of a k-step: 64, 32 or 16
  int tma;     // stages by TMA (else gathered)
  int kpr;     // k-steps per image row
  int nk;      // k-steps in all
  int ctiles, mtiles;
  int splits;  // blocks per tile
  int chunk;   // k-steps per split
};

// k-steps: KP = the widest of 64, 32, 16 dividing W (16 otherwise, the last
// k-step of a row ragged); TMA when W % 16 == 0 (so KP divides W and the
// row pitch is a multiple of 16 bytes) and the operands are 16-byte
// aligned. Splits: as many as keep tiles x splits within one block per SM
// (the cooperative launch needs every block resident; one when the tiles
// alone fill the card), k-steps shared out evenly, every split non-empty.
WPlan make_wplan(int B, int Cin, int Cout, int H, int W, int sms,
                 int aligned) {
  WPlan p;
  p.kp = W % 64 == 0 ? 64 : W % 32 == 0 ? 32 : 16;
  p.tma = aligned && W % 16 == 0;
  p.kpr = cdiv(W, p.kp);
  p.nk = B * H * p.kpr;
  p.ctiles = cdiv(Cin, wg::BC);
  p.mtiles = cdiv(Cout, wg::BN);
  const int tiles = p.ctiles * p.mtiles;
  int splits = sms / tiles;
  if (splits > p.nk) splits = p.nk;
  if (splits < 1) splits = 1;
  p.chunk = cdiv(p.nk, splits);
  p.splits = cdiv(p.nk, p.chunk);
  return p;
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

template <int KP>
int launch_wg(const void* g, const void* x, void* partial, void* dw,
              void* db, const WPlan& pl, int B, int Cin, int Cout, int H,
              int W, cudaStream_t s) {
  using G = wg::Geo<KP>;
  auto kern = wg::wgrad_wgmma_kernel<KP>;
  static bool attr = false;  // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg::kSmemBudget + 1024);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  wg::Params p;
  memset(&p, 0, sizeof(p));
  p.B = B;
  p.Cin = Cin;
  p.Cout = Cout;
  p.H = H;
  p.W = W;
  p.kpr = pl.kpr;
  p.nk = pl.nk;
  p.chunk = pl.chunk;
  p.splits = pl.splits;
  p.ctiles = pl.ctiles;
  p.mtiles = pl.mtiles;
  p.tma = pl.tma;
  p.stages = wg::kSmemBudget / G::kStage;
  if (p.stages > wg::kStages) p.stages = wg::kStages;
  if (p.stages > wg::kMaxStages) p.stages = wg::kMaxStages;
  const int tiles = pl.ctiles * pl.mtiles;
  p.coop = pl.splits > 1;
  CUtensorMap tmg, tmx, tmh;
  memset(&tmg, 0, sizeof(tmg));
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmh, 0, sizeof(tmh));
  if (p.tma) {
    int e = matry::hop::encode_nchw(&tmg, g, B, Cout, H, W, KP, wg::BN, 1,
                                    1, G::L);
    if (!e)
      e = matry::hop::encode_nchw(&tmx, x, B, Cin, H, W, KP, wg::BC, 3, 1,
                                  G::L);
    if (!e)
      e = matry::hop::encode_nchw(&tmh, x, B, Cin, H, W, wg::kHalo, wg::BC,
                                  3, 1, 0);
    if (e) return e;
  }
  const dim3 grid(tiles * pl.splits);
  const size_t smem = (size_t)p.stages * G::kStage + 1024;
  const unsigned short* gp = (const unsigned short*)g;
  const unsigned short* xp = (const unsigned short*)x;
  float* pp = (float*)partial;
  float* dwp = (float*)dw;
  float* dbp = (float*)db;
  if (p.coop) {
    void* args[] = {&tmg, &tmx, &tmh, &gp, &xp, &pp, &dwp, &dbp, &p};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)kern, grid, dim3(wg::kThreads), args, smem, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    kern<<<grid, wg::kThreads, smem, s>>>(tmg, tmx, tmh, gp, xp, pp, dwp,
                                          dbp, p);
  }
  return 0;
}

}  // namespace

// The bf16 launch's plan for this shape on `sms` SMs, packed: log2(KP) - 4
// (bits 0-1; KP the pixels of a k-step), stages by TMA (bit 2; assuming
// 16-byte aligned g and x), splits (bits 3 and up). The tile is wg::BC x
// wg::BN = 64 x 64 (x 9 taps), the window's halo boxes 8 columns wide;
// chunk = ceil(k-steps / splits).
extern "C" int matry_wgrad_plan(int B, int Cin, int Cout, int H, int W,
                                int sms) {
  const WPlan p = make_wplan(B, Cin, Cout, H, W, sms, 1);
  return (p.kp == 64 ? 2 : p.kp == 32 ? 1 : 0) | p.tma << 2 | p.splits << 3;
}

// g [B, Cout, H, W] and x [B, Cin, H, W], both f32 (is_f32) or both bf16;
// dw [Cout, Cin, 3, 3] and db [Cout] f32.
// f32: partial is f32 scratch [splits, Cout, 9*Cin + 1]; split z covers
// pixels [z*chunk, (z+1)*chunk) of B*H*W.
// bf16: sms is the SM count of the operands' device, and splits and
// chunk must be matry_wgrad_plan's for it (the splits of one tile's pixel
// sum, the k-steps of each); partial f32 scratch [splits, tiles, 9*64*64
// + 64] (tiles = ceil(Cin/64) * ceil(Cout/64)). f32 ignores sms.
extern "C" int matry_conv_wgrad(const void* g, const void* x, void* partial,
                                void* dw, void* db, int B, int Cin, int Cout,
                                int H, int W, int splits, long long chunk,
                                int is_f32, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    const long long need = (long long)B * H * W;
    if (splits < 1 || chunk < 1 || (long long)splits * chunk < need)
      return (int)cudaErrorInvalidValue;
    const WArgs a{B, Cin, Cout, H, W, chunk};
    launch_f32(g, x, partial, a, splits, s);
    const int n1 = 9 * Cin + 1;
    const long long total = (long long)Cout * n1;
    wgrad_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        (const float*)partial, (float*)dw, (float*)db, splits, Cout, n1);
    return (int)cudaGetLastError();
  }
  if (sms < 1) return (int)cudaErrorInvalidValue;
  const WPlan pl =
      make_wplan(B, Cin, Cout, H, W, sms, aligned16(g) && aligned16(x));
  if (splits != pl.splits || chunk != pl.chunk)
    return (int)cudaErrorInvalidValue;
  int e;
  if (pl.kp == 64)
    e = launch_wg<64>(g, x, partial, dw, db, pl, B, Cin, Cout, H, W, s);
  else if (pl.kp == 32)
    e = launch_wg<32>(g, x, partial, dw, db, pl, B, Cin, Cout, H, W, s);
  else
    e = launch_wg<16>(g, x, partial, dw, db, pl, B, Cin, Cout, H, W, s);
  if (e) return e;
  return (int)cudaGetLastError();
}
