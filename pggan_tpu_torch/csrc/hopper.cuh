// Hopper building blocks of conv3x3.cu, conv3x3_dw.cu and conv_chain.cu:
// TMA tile loads completing on mbarriers, warpgroup MMAs (wgmma) in TF32
// with A from registers and B from shared memory, the warp-level
// mma.sync.m16n8k8 for tiles too small for wgmma's 64 rows, the split of
// each f32 operand into TF32 halves, and the host-side encoding of a TMA
// tensor map. Everything here needs sm_90a (wgmma).
//
// The split. A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32
// product is off by up to ~1e-3 relative. Writing each f32 operand as
// a = hi + lo, with hi = tf32(a) and lo = tf32(a - hi) (both rounded to
// nearest, ties away), gives
//   a * b = hi_a hi_b + hi_a lo_b + lo_a hi_b + lo_a lo_b,
// and the last term is below 2^-22 of the product, so three tensor-core
// products with f32 accumulators keep about 21-22 mantissa bits per
// product: the f32 FMA's accuracy, at 3 / 495 TFLOP/s (H100 TF32 dense)
// instead of f32's 67. The TPU kernels did the same for f32 on the MXU, in
// several bf16 passes. The tensor cores truncate when they add into an
// accumulator, so the kernels sum short chains of products from zero and
// add each chain to their f32 sums with a rounded add.
//
// wgmma.m64nNk8 (TF32): four warps multiply a 64 x 8 A (registers) by an
// 8 x N B (shared memory) into a 64 x N f32 accumulator. Warp w of the
// warpgroup holds rows 16w..16w+15; with g = lane / 4, t = lane % 4:
//   A: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   D: d[4j + 2h + e] = (row g + 8h, col 8j + 2t + e),
// the fragments of mma.sync.m16n8k8 side by side, so a row's N outputs
// sit in one quad of lanes. TF32 wgmma reads a shared-memory operand
// K-major only: B is stored as "core matrices" of 8 N-rows x 4 K-values
// (128 contiguous bytes), the two K-halves of a k-step LBO bytes apart and
// consecutive groups of 8 N-rows SBO bytes apart, without swizzle.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace pggan {

// -- mbarriers --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival, and `bytes` more to come from TMA copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes to shared memory (the split operands) made visible
// to the async proxy (wgmma); then a barrier orders them for the readers
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// warpgroup register budgets (all four warps of a warpgroup together):
// a producer gives registers back, consumers take them
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// a barrier over `threads` threads (a multiple of 32) of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- TMA --------------------------------------------------------------------

// the box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst (128-byte aligned); elements outside the tensor
// arrive as zeros. Completes `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// -- the TF32 split ----------------------------------------------------------

// a = hi + lo, both TF32 (an f32 whose low 13 bits are 0), each rounded to
// nearest with ties away from zero: the values of cvt.rna.tf32.f32 for
// every finite a, in integer and f32 adds that issue at full rate, where
// cvt.rna.tf32.f32 issues at a fraction of it and bounds a kernel that
// splits every operand it loads. a - hi is exact in f32.
__device__ __forceinline__ void tf32_split_fast(float a, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(a - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// -- mma.sync ---------------------------------------------------------------

// d += a b for one warp's m16n8k8 TF32 tile, fragments as wgmma's A and D
// above (one warp's 16 rows) and b0 (row t, col g), b1 (row t + 4, col g)
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 products of split operands, cross terms first,
// summed from zero in the tensor cores and added to d with one rounded f32
// add
__device__ __forceinline__ void mma_m16n8k8_3x(float (&d)[4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               const uint32_t (&bh)[2],
                                               const uint32_t (&bl)[2]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_m16n8k8(s, al, bh[0], bh[1]);
  mma_m16n8k8(s, ah, bl[0], bl[1]);
  mma_m16n8k8(s, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += s[e];
}

// -- wgmma ------------------------------------------------------------------

// descriptor of a K-major, unswizzled shared-memory operand at p: core
// matrices of 128 bytes, lbo bytes apart along K, sbo bytes along N
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fff) |
         (uint64_t)((lbo >> 4) & 0x3fff) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fff) << 32;
}

// before the first wgmma of a group: orders the registers and shared
// memory written before it
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N committed groups of this warpgroup are still in flight: the
// registers of the older ones may be read or written again
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins accumulator registers in place across the asynchronous MMAs: the
// compiler may not move their reads or writes over this point
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b for one m64nNk8 TF32 wgmma: a is this thread's A fragment,
// desc names B; scale_d == 0 ignores d's old value (a group's first
// product starts from zero without clearing the registers)
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

}  // namespace pggan

// -- host -------------------------------------------------------------------

namespace pggan {
namespace host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime loaded, found
// once through the runtime's entry-point query (no link against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A tiled f32 tensor map over `rank` dims (innermost first) of a dense
// tensor at ptr, zero-filled outside it, unswizzled; box[i] elements along
// dim i. Returns a CUDA error code (cudaErrorInvalidValue if the encoding
// is refused).
inline int tensor_map_f32(CUtensorMap* map, const void* ptr, int rank,
                          const uint64_t* dims, const uint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  uint64_t stride = sizeof(float);
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    estride[i] = 1;
    stride *= dims[i];
    if (i + 1 < rank) gstride[i] = stride;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
      const_cast<void*>(ptr), gdim, gstride, gbox, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace host
}  // namespace pggan
