// Tensor-core building blocks shared by conv3x3.cu and conv3x3_dw.cu: the
// three-product TF32 split and the asynchronous shared-memory copies.
//
// The split. A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32
// product is off by up to ~1e-3 relative. Writing each f32 operand as
// a = hi + lo, with hi = tf32(a) and lo = tf32(a - hi) (both rounded to
// nearest, ties away: cvt.rna.tf32.f32), gives
//   a * b = hi_a hi_b + hi_a lo_b + lo_a hi_b + lo_a lo_b,
// and the last term is below 2^-22 of the product, so three tensor-core
// products with f32 accumulators keep about 21-22 mantissa bits per
// product: the f32 FMA's accuracy, at 3 / 495 TFLOP/s (H100 TF32 dense)
// instead of f32's 67. The small cross terms are issued before hi * hi.
// The TPU kernels did the same for f32 on the MXU, in several bf16 passes.
//
// mma.sync.m16n8k8 (TF32) takes its fragments from registers, so the
// operands may sit in shared memory in any layout; the callers pad their
// row strides so that a warp's fragment loads hit 32 distinct banks.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pggan {

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo, both TF32 (as the bits of an f32 whose low 13 bits are 0)
__device__ __forceinline__ void tf32_split(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile. Fragments (g = lane / 4, t = lane % 4):
// a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (row t, col g), b1 (t + 4, g);
// d0 (row g, col 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 products of split operands, cross terms first.
// The products are summed from zero and then added to d with one f32 add
// (round to nearest): the tensor cores truncate when they add into an
// accumulator, and over the hundreds of MMAs of a long reduction that
// drifts by tens of f32 ulps in one direction (enough to miss the plain
// version's tolerance at C = 64-128 on an H100), where rounding to nearest
// does not.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(s, al, bh[0], bh[1]);
  mma_tf32(s, ah, bl[0], bl[1]);
  mma_tf32(s, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += s[e];
}

// Asynchronous global -> shared copies; a copy with valid == false writes
// zeros and reads nothing (the zero padding outside the image). src must
// be a 16-byte aligned address for the 16-byte form.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed; a __syncthreads() after it makes all
// threads' copies visible to the block
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace pggan
