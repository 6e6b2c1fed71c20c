// What K4's float32 kernels for Hopper share (flash_attention_fwd_f32.cu,
// flash_attention_bwd_f32.cu): float32 attention on the bf16 tensor cores
// as split products.
//
// Every float32 operand x is split as x = hi + lo, hi = bf16(x) and
// lo = bf16(x - hi) (x - hi is exact in float32), and a product a · b is
// taken as lo_a · hi_b + hi_a · lo_b + hi_a · hi_b, three bf16 wgmma
// products into one float32 accumulator; lo_a · lo_b (2^-18 of |a||b|) is
// left out, and x - hi - lo is 2^-18 of |x| at most, so each product is
// within about 3 · 2^-18 of a · b. The small terms go first.
//
// q, k, v and do reach the kernels as split copies written by the split
// pass (vcd_flash_split_f32 in flash_attention_fwd_f32.cu: bf16
// [B, S, H, 64] hi and lo, contiguous), whose tiles TMA loads as the bf16
// kernels' (flash_wgmma.cuh). The wrapper launches it once a forward and
// once a backward, whose two kernels read the same copies. p and ds are
// float32 in registers and are split there into hi and lo A fragments.
//
// v and do are split in three (lo2 = bf16(x - hi - lo), the rest within
// 2^-27 of |x|), and the products that take them keep every term down to
// 2^-18: o += P V as five products (split_ab5), dp = do · v^T as six
// (split6_abt_ss). The backward's ds = p (dp - di) scale subtracts
// di = sum(o · do), which the row kernel sums in float32 from the
// forward's o. Where the softmax puts its weight on one key, dp and di
// are nearly equal and their difference is all that is left of them:
// with one key, dq and dk are 0 in exact arithmetic, and the float32 rule
// at one key allows 2^-20 of scale * sum |do v|. There, with v and do in
// two parts, o carries v's split residual (2^-18 of |v|) into di, and dp
// carries do's: dq and dk read 1.4e-5 against an allowance of 6.2e-6 on
// an H100; with do in three but v in two, 8.0e-6 (the plain version, fed
// di from that o, reads the same). With both in three the emulation on
// the CPU reads under a hundredth of the allowance.
#pragma once

#include "flash_wgmma.cuh"

namespace vcd {

// x -> (hi, lo) of two neighbouring values, each pair packed as one mma A
// fragment register (the first value in the low half).
__device__ __forceinline__ void split_pack(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// A warp's 16 x 8·NT float32 accumulator tile as hi and lo A fragments
// (the layout of acc_to_a).
template <int NT>
__device__ __forceinline__ void acc_to_a_split(const float (&acc)[NT][4],
                                               unsigned (&hi)[NT / 2][4],
                                               unsigned (&lo)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    split_pack(acc[2 * j][0], acc[2 * j][1], hi[j][0], lo[j][0]);
    split_pack(acc[2 * j][2], acc[2 * j][3], hi[j][1], lo[j][1]);
    split_pack(acc[2 * j + 1][0], acc[2 * j + 1][1], hi[j][2], lo[j][2]);
    split_pack(acc[2 * j + 1][2], acc[2 * j + 1][3], hi[j][3], lo[j][3]);
  }
}

// d (+)= A · B^T over a depth of 64 with both operands K-major swizzled
// tiles in shared memory (A: the warpgroup's 64 rows): four k-steps, 32
// bytes apart, the first of which overwrites d unless `accumulate`.
__device__ __forceinline__ void wgmma_tile_abt_ss(float (&d)[8][4],
                                                  uint64_t a, uint64_t b,
                                                  int accumulate) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss64(d, a + 2 * ks, b + 2 * ks, ks > 0 || accumulate);
}

// d = A · B^T (logits), A as hi and lo register fragments, B as the
// descriptors of its hi and lo tiles: three products, d overwritten.
__device__ __forceinline__ void split_abt(float (&d)[8][4],
                                          const unsigned (&a_hi)[4][4],
                                          const unsigned (&a_lo)[4][4],
                                          uint64_t b_hi, uint64_t b_lo) {
  wgmma_tile_abt(d, a_lo, b_hi);
  wgmma_tile_abt(d, a_hi, b_lo, 1);
  wgmma_tile_abt(d, a_hi, b_hi, 1);
}

// The same with A's hi and lo tiles in shared memory.
__device__ __forceinline__ void split_abt_ss(float (&d)[8][4], uint64_t a_hi,
                                             uint64_t a_lo, uint64_t b_hi,
                                             uint64_t b_lo) {
  wgmma_tile_abt_ss(d, a_lo, b_hi, 0);
  wgmma_tile_abt_ss(d, a_hi, b_lo, 1);
  wgmma_tile_abt_ss(d, a_hi, b_hi, 1);
}

// dp = A · B^T with both operands split in three (do and v), both in
// shared memory: the six products whose terms reach 2^-18 (lo2 · hi,
// hi · lo2, lo · lo, lo · hi, hi · lo, hi · hi), d overwritten.
__device__ __forceinline__ void split6_abt_ss(float (&d)[8][4], uint64_t a_hi,
                                              uint64_t a_lo, uint64_t a_lo2,
                                              uint64_t b_hi, uint64_t b_lo,
                                              uint64_t b_lo2) {
  wgmma_tile_abt_ss(d, a_lo2, b_hi, 0);
  wgmma_tile_abt_ss(d, a_hi, b_lo2, 1);
  wgmma_tile_abt_ss(d, a_lo, b_lo, 1);
  wgmma_tile_abt_ss(d, a_lo, b_hi, 1);
  wgmma_tile_abt_ss(d, a_hi, b_lo, 1);
  wgmma_tile_abt_ss(d, a_hi, b_hi, 1);
}

// d += A · B (o += P V and the gradients), A as hi and lo register
// fragments, B's hi and lo tiles read MN-major.
__device__ __forceinline__ void split_ab(float (&d)[8][4],
                                         const unsigned (&a_hi)[4][4],
                                         const unsigned (&a_lo)[4][4],
                                         uint64_t b_hi, uint64_t b_lo) {
  wgmma_tile_ab(d, a_lo, b_hi);
  wgmma_tile_ab(d, a_hi, b_lo);
  wgmma_tile_ab(d, a_hi, b_hi);
}

// o += P · V with V split in three: the five products whose terms reach
// 2^-18 (hi · lo2, lo · lo, lo · hi, hi · lo, hi · hi), B read MN-major.
__device__ __forceinline__ void split_ab5(float (&d)[8][4],
                                          const unsigned (&a_hi)[4][4],
                                          const unsigned (&a_lo)[4][4],
                                          uint64_t b_hi, uint64_t b_lo,
                                          uint64_t b_lo2) {
  wgmma_tile_ab(d, a_hi, b_lo2);
  wgmma_tile_ab(d, a_lo, b_lo);
  split_ab(d, a_hi, a_lo, b_hi, b_lo);
}

// Parts of each operand in the split scratch: q, k in two, v, do in three.
constexpr int Q_PARTS = 2, K_PARTS = 2, V_PARTS = 3, DO_PARTS = 3;

// The elements of one split copy, and the strides of a contiguous
// [B, S, H, 64] tensor.
inline int64_t split_elems(int B, int S, int H) {
  return (int64_t)B * S * H * 64;
}
inline Strides contiguous_strides(int S, int H) {
  return {(int64_t)S * H * 64, (int64_t)H * 64, 64};
}

}  // namespace vcd
