// Float32-accurate products on Hopper's tensor cores (3xTF32 mma.sync) and the
// cp.async copies that stage their tiles: what serving_topk.cu, afm_attention.cu
// and din_attention.cu share.
//
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), each rounded to
// the nearest TF32 (10 mantissa bits, ties away from zero: cvt.rna, or
// tf32_bits on finite values). Then
//   a b ~= lo_a hi_b + hi_a lo_b + hi_a hi_b,
// each an mma.sync m16n8k8 TF32 with a float32 accumulator, the small terms
// first. The dropped lo_a lo_b is below 2^-22 of |a b|.
//
// mma.sync m16n8k8 TF32 fragments (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"): with g = lane / 4 and t = lane % 4, a lane holds A (16 x 8,
// row-major) as a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B
// (8 x 8, by column) as b0 (t, g), b1 (t + 4, g); C (16 x 8, float32) as
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32mma {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// acc (16 x 8, float32) += a (16 x 8, TF32, row-major) b (8 x 8, TF32, column-major)
__device__ __forceinline__ void mma_tf32(float (&acc)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// tf32(x) on the bits, for a finite x: the same rounding (to nearest, ties away
// from zero, carries into the exponent included) in two integer instructions,
// where cvt.rna.tf32.f32 compiles to a longer sequence on sm_90a.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// acc[j] += a b_j in float32 accuracy for the N n8 tiles j (B's hi and lo parts
// in bh[j], bl[j]): the three products of 3xTF32, small terms first, pass by
// pass over the tiles, so that neighbouring mma.sync take different
// accumulators and do not wait on each other. No tile is skipped: a predicated
// mma.sync costs a warp synchronisation, so callers pad widths with zeros.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[N][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[j], ah, bh[j]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// 16 bytes from src, or 16 zero bytes when !in (src is then not read).
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4_or_zero(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

}  // namespace tf32mma
