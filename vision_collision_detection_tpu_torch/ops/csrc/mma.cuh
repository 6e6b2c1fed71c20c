// Tensor-core and async-copy primitives shared by the kernels that multiply
// bf16 tiles staged in shared memory (K3, K4): cp.async, ldmatrix and
// mma.sync m16n8k16 with float32 accumulation.
#pragma once

#include "common.cuh"

namespace vcd {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A bf16 m16n8k16 product into a float32 m16n8 accumulator. A lane with
// g = lane / 4 and tg = lane % 4 holds d[0], d[1] at row g, columns 2*tg and
// 2*tg + 1, and d[2], d[3] at row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. As the A operand of mma_bf16 for a row-major
// 16x16 tile; with .trans, two B operands (k 0-15, n 0-7 and n 8-15) of a
// [k][n] row-major tile.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two float32 values rounded to bf16 in one register, the first in the low
// half: a pair of neighbouring columns of an mma A fragment.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragments (16 rows x 16 columns each) of a warp's 16 x 8·NT
// float32 tile held as mma accumulators, rounded to bf16: accumulator
// column tiles 2j and 2j + 1 are the two halves of fragment j.
template <int NT>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NT][4],
                                         unsigned (&a)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    a[j][0] = pack_bf16(acc[2 * j][0], acc[2 * j][1]);
    a[j][1] = pack_bf16(acc[2 * j][2], acc[2 * j][3]);
    a[j][2] = pack_bf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
    a[j][3] = pack_bf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vcd
