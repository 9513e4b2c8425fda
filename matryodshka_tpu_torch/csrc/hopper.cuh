// Hopper (sm_90a) building blocks of the wgmma kernels (conv.cu,
// conv_wgrad.cu), as raw PTX: mbarriers, TMA tensor loads
// (cp.async.bulk.tensor), shared-memory matrix descriptors, wgmma.mma_async
// with A in registers and B in shared memory (bf16, f32 accumulators; B
// MN-major or K-major), ldmatrix, the proxy fence that makes generic
// shared-memory writes visible to the async proxy (wgmma, TMA), named
// barriers and setmaxnreg; and, on the host, the tensor maps those kernels
// load through (encoded through the runtime's driver entry point, cached by
// their arguments).
#pragma once

#include <stdint.h>
#include <string.h>

#include <mutex>

#include <cuda.h>  // CUtensorMap (the type only: no driver call is linked)
#include <cuda_runtime.h>

namespace matry {
namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy and the block.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One arrival that also expects `bytes` more of TMA transactions.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
// Cycles a wait may take before the kernel traps (~9 s at 1.8 GHz): a
// pipeline that cannot complete ends in a launch failure the wrapper
// reports, not in a card that hangs.
constexpr long long kWaitCycles = 1LL << 34;
// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// ---- TMA --------------------------------------------------------------------

__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)map)
               : "memory");
}
// Box of a 2-D tensor map at (c0, c1) (innermost first) into dst; the
// bytes complete on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Generic-proxy writes to shared memory (st.shared) become visible to the
// async proxy (a later wgmma or TMA) after this fence.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the layout (0 none, 1 128-byte swizzle, 2
// 64-byte, 3 32-byte). For an MN-major operand in a swizzled layout of S
// bytes (S / 2 bf16 along M or N, 8 along K per atom) the leading offset
// is the stride between atoms along M or N and the stride offset the
// stride between groups of 8 along K. Buffers are 1024-byte aligned, so
// the base offset field is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across a
// wgmma fence, commit or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16 bits of shared memory at a byte address in the shared window.
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// Four 8x8 b16 matrices of shared memory (ldmatrix.x4): lane l gives the
// address of a 16-byte row of matrix l / 8 (row l % 8) and receives in
// r[i] the elements (l / 4, 2 (l % 4)) and (l / 4, 2 (l % 4) + 1) of matrix
// i, the lower in the low half.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The inverse of ldsm_x4 (stmatrix.x4): lane l gives the address of row
// l % 8 of matrix l / 8 and r[i] holds its elements (l / 4, 2 (l % 4)) and
// (l / 4, 2 (l % 4) + 1) of matrix i, the lower in the low half.
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// 32 bits of shared memory at a (4-byte aligned) byte address.
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// d (64 x N, f32) += A (64 x 16, bf16 fragment in registers a[4]) *
// B (16 x N, bf16 in shared memory through the descriptor db), N = 64 or
// 128. TB = 1: B is MN-major (transpose bit set; conv.cu's packed weights,
// Cout-contiguous); TB = 0: B is K-major (conv_wgrad.cu's g tile, pixel-
// contiguous rows of one output channel).
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TB));
  }
}

// ---- tensor maps (host) -----------------------------------------------------

// Streaming multiprocessors of the current device (132 if the query
// fails), read once.
inline int num_sms() {
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Encoded tensor maps by their arguments (pointer, shape, strides, box,
// element strides, swizzle): a direct-mapped cache of 256, one for the
// library (an inline variable), so that a layer run again on the same
// buffers (the caching allocator hands them back) costs no
// cuTensorMapEncodeTiled. A map holds nothing but these arguments, so a
// hit is the map the call would encode.
struct MapKey {
  const void* ptr;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], es[4];
  int rank, swizzle, nan_fill;
};
struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};
inline MapSlot g_maps[256];
inline std::mutex g_maps_mu;

inline int encode_cached(CUtensorMap* m, const MapKey& k) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(&k);
  for (size_t i = 0; i < sizeof(k); ++i) h = (h ^ kb[i]) * 1099511628211ull;
  std::lock_guard<std::mutex> lock(g_maps_mu);
  MapSlot& slot = g_maps[h & 255];
  if (slot.used && memcmp(&slot.key, &k, sizeof(k)) == 0) {
    *m = slot.map;
    return 0;
  }
  const CUresult r = fn(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)k.rank,
      const_cast<void*>(k.ptr), k.dims, k.strides, k.box, k.es,
      CU_TENSOR_MAP_INTERLEAVE_NONE, (CUtensorMapSwizzle)k.swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      k.nan_fill ? CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA
                 : CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  slot.key = k;
  slot.map = *m;
  slot.used = true;
  return 0;
}

inline CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                    : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// An NCHW bf16 tensor [B, C, H, W] as the 4-D tensor (W, C, H, B): box
// {box_w, box_c, box_h, 1}, taking every h_stride-th row, swizzled as
// swz bytes (0: none). Boxes past any edge load zeros, or NaN with
// nan_fill; the row pitch (2 W bytes) must be a multiple of 16.
inline int encode_nchw(CUtensorMap* m, const void* p, int B, int C, int H,
                       int W, int box_w, int box_c, int box_h, int h_stride,
                       int swz, int nan_fill = 0) {
  MapKey k;
  memset(&k, 0, sizeof(k));
  k.ptr = p;
  k.rank = 4;
  k.dims[0] = W;
  k.dims[1] = C;
  k.dims[2] = H;
  k.dims[3] = B;
  k.strides[0] = (cuuint64_t)H * W * 2;
  k.strides[1] = (cuuint64_t)W * 2;
  k.strides[2] = (cuuint64_t)C * H * W * 2;
  k.box[0] = box_w;
  k.box[1] = box_c;
  k.box[2] = box_h;
  k.box[3] = 1;
  k.es[0] = k.es[1] = k.es[3] = 1;
  k.es[2] = h_stride;
  k.swizzle = swizzle_of(swz);
  k.nan_fill = nan_fill;
  return encode_cached(m, k);
}

// A channels-last bf16 tensor [B, C, H, W] (strides C: 1, W: C, H: W C,
// B: H W C elements) as the 4-D tensor (C, W, H, B): box {64, box_w,
// box_h, 1}, taking every h_stride-th row, the 128-byte swizzle (a pixel's
// 64 channels are one 128-byte line). Boxes past any edge load zeros, or
// NaN with nan_fill; the pixel pitch (2 C bytes) must be a multiple of 16.
inline int encode_nhwc(CUtensorMap* m, const void* p, int B, int C, int H,
                       int W, int box_w, int box_h, int h_stride,
                       int nan_fill = 0) {
  MapKey k;
  memset(&k, 0, sizeof(k));
  k.ptr = p;
  k.rank = 4;
  k.dims[0] = C;
  k.dims[1] = W;
  k.dims[2] = H;
  k.dims[3] = B;
  k.strides[0] = (cuuint64_t)C * 2;
  k.strides[1] = (cuuint64_t)W * C * 2;
  k.strides[2] = (cuuint64_t)H * W * C * 2;
  k.box[0] = 64;
  k.box[1] = box_w;
  k.box[2] = box_h;
  k.box[3] = 1;
  k.es[0] = k.es[1] = k.es[3] = 1;
  k.es[2] = h_stride;
  k.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  k.nan_fill = nan_fill;
  return encode_cached(m, k);
}

}  // namespace hop
}  // namespace matry
