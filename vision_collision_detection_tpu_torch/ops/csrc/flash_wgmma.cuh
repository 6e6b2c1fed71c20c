// What K4's Hopper kernels share (flash_attention_fwd_wgmma.cu,
// flash_attention_bwd_wgmma.cu): the tensor map of a strided [B, S, H, 64]
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

}  // namespace vcd
