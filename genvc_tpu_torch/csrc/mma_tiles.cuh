// Tensor-core tile helpers for Hopper (sm_90a): bf16 mma.sync with f32
// accumulators, ldmatrix, 16-byte cp.async, and the quad reductions over an
// accumulator fragment. Shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu).
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), 4 x bf16x2: a0 (row g, k 2t..2t+1),
//     a1 (row g + 8, k 2t..), a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..)
//   B (16 x 8, "col": k runs along a register), 2 x bf16x2:
//     b0 (k 2t..2t+1, col g), b1 (k 2t + 8.., col g)
//   C / D (16 x 8, f32): c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8)
// So the accumulator of S = Q.K^T over 16 keys (two n-tiles) is, packed to
// bf16 pairs, the A operand of P.V over those 16 keys without any shuffle.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16-byte aligned). Thread lane receives, from each matrix, row
// lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, transposed: thread lane receives column lane / 4, rows
// 2 (lane % 4) and 2 (lane % 4) + 1 of each matrix (the B operand from a
// row-major [k][n] tile, e.g. V stored [key][hd]).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += a . b on the tensor cores: 16x16 bf16 by 16x8 bf16, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
// (and reads nothing), 16 copies the row. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronously (through L1); src_bytes = 0
// writes a zero and reads nothing. Both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n));
}

// two f32 -> one bf16x2 register (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// what pack_bf16x2(lo, hi) = `packed` left out, itself rounded to bf16: a
// product of both packs carries the pair to about 2^-17 relative
__device__ __forceinline__ uint32_t pack_bf16x2_rest(float lo, float hi, uint32_t packed) {
  const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16x2(lo - r.x, hi - r.y);
}

// max / sum over the four threads (t = 0..3) that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mma_tiles
