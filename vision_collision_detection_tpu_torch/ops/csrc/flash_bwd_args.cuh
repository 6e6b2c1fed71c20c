// What K4's backward C entries share: the operands of one call.
#pragma once

#include "flash_common.cuh"

namespace vcd {

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *di;
  Strides sq, sk, sv, sd;
  int B, S, H;
  float scale;
  int dtype;  // 0 = bfloat16, 1 = float32
  cudaStream_t stream;
};

// The operands of an entry that takes q, k, v, dout with element strides
// `s[12]` = (batch, sequence, head) of each.
inline BwdArgs bwd_args(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        const int64_t* s, int B, int S, int H, float scale,
                        int dtype, void* stream) {
  return {q, k, v, dout, lse, di,
          {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
          {s[9], s[10], s[11]}, B, S, H, scale, dtype,
          (cudaStream_t)stream};
}

}  // namespace vcd
