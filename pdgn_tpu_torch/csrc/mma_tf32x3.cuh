// fp32-accurate matrix products on Hopper's tensor cores (3xTF32), and the
// cp.async staging that feeds them.
//
// TF32 keeps 10 mantissa bits, so one TF32 product is ~3e-4 off fp32. Each
// fp32 operand splits as hi = tf32(a) and lo = tf32(a - hi) (cvt.rna: round
// to nearest, ties away from zero), and a product accumulates
// lo*hi + hi*lo + hi*hi in fp32: the dropped lo*lo term is below 2^-22 of
// |a||b|, so the result keeps fp32's own error. It is the Hopper counterpart
// of the TPU kernels' bf16 hi/lo split (pdgn_tpu/ops/pallas/edge_head.py
// _hi_lo). tests/test_torch_tf32x3.py emulates the split in numpy.
//
// Fragments are those of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// with g = lane / 4, t = lane % 4:
//   A (16 x 8, row): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                    a3 = A[g+8][t+4]
//   B (8 x 8, col):  b0 = B[t][g], b1 = B[t+4][g]
//   D (16 x 8):      d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t],
//                    d3 = D[g+8][2t+1]
//
// The bf16 instances' products take mma.sync.aligned.m16n8k16.row.col.f32.
// bf16.bf16.f32 (mma_bf16): bf16 products are exact in fp32 and accumulate
// in fp32, with two bf16 of the same row of A (adjacent k) or of the same
// column of B (adjacent k) in one 32-bit register, the lower k in the low
// half:
//   A (16 x 16, row): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, col):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   D as above.
// A bf16 value is exact in TF32 too, so a TF32 product of bf16 operands
// needs one pass, not three (slot stats and the gate's slot logits).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cvt.rna.tf32.f32 for finite a, in two integer operations: half of the
// dropped unit added to the magnitude, the 13 low mantissa bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo to ~2^-22 of |a|; both halves are TF32 bit patterns
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a b, one TF32 tensor-core pass
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at fp32 accuracy: the two small cross terms first, then hi*hi
__device__ __forceinline__ void mma_tf32x3(float d[4], const uint32_t ahi[4],
                                           const uint32_t alo[4],
                                           const uint32_t bhi[2],
                                           const uint32_t blo[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// d += a b, one bf16 tensor-core pass (m16n8k16, fp32 accumulation)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// a value of an fp32 or a bf16 operand as fp32 (exact), and an fp32 value
// stored as either (bf16: rounded to nearest even)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v as the storage type T would hold it, back in fp32
template <class T>
__device__ __forceinline__ float round_as(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// 16-byte asynchronous copy global -> shared; src_bytes < 16 fills the rest
// of the 16 bytes with zeros (0: nothing is read, gmem need only be valid)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4-byte asynchronous copy global -> shared (cp.async.ca); src_bytes 0
// writes a zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace
