// What K4's Hopper kernels share (flash_attention_fwd_wgmma.cu,
// flash_attention_bwd_wgmma.cu and their float32 and head_dim-16
// siblings): the tensor map of a strided [B, S, H, 64] or [B, S, H, 16]
// operand and the walk of a persistent grid over its work items.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace vcd {

// The grid is persistent: block i takes the work items i, i + gridDim.x, ...
// One item is one block of 64 * NWG rows of one (batch, head); neighbouring
// items share a head, so the blocks at work together read the same
// operands out of L2.
struct Item {
  int r0, h, b;
};
__device__ __forceinline__ Item item_at(int w, int row_blocks, int rows,
                                        int H) {
  return {w % row_blocks * rows, w / row_blocks % H, w / row_blocks / H};
}

// The map of one bf16 [B, S, H, 64] operand, dimensions (D, S, H, B)
// innermost first with the tensor's own strides, a box of 64 rows of one
// (batch, head), 128-byte swizzle, zeros past S.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr,
                            const Strides& st, int B, int S, int H) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  // bytes; an axis of one element is never stepped along, and a view may
  // give it any stride, so it gets one the encoder takes
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)st.s * 2 : 128,
                                 H > 1 ? (cuuint64_t)st.h * 2 : 128,
                                 B > 1 ? (cuuint64_t)st.b * 2 : 128};
  const cuuint32_t box[4] = {64, TILE_ROWS, 1, 1};
  return make_bf16_map(map, ptr, 4, dims, strides, box);
}

// The map of one bf16 [B, S, H, 16] operand (head_dim 16: rows of 32
// bytes), dimensions (16, S, H, B) with the tensor's own strides, a box of
// `rows` rows of one (batch, head), 32-byte swizzle (hopper.cuh), zeros
// past S.
inline cudaError_t make_map16(CUtensorMap* map, const void* ptr,
                              const Strides& st, int B, int S, int H,
                              int rows) {
  const cuuint64_t dims[4] = {16, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)st.s * 2 : 32,
                                 H > 1 ? (cuuint64_t)st.h * 2 : 32,
                                 B > 1 ? (cuuint64_t)st.b * 2 : 32};
  const cuuint32_t box[4] = {16, (cuuint32_t)rows, 1, 1};
  return make_bf16_map(map, ptr, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace vcd
