// What K4's backward launchers share: the operands of one call, and the
// entry points of the bf16, head_dim 64 kernels (flash_attention_bwd_wgmma.cu)
// that the C launchers of flash_attention_bwd.cu route to.
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

// bf16 [B, S, H, 64] operands; dk, dv, dq contiguous. Each returns a
// cudaError_t as int: a tensor map that cannot be encoded, a refused
// attribute or launch.
int launch_bwd_dkv_wgmma(const BwdArgs& a, void* dk, void* dv);
int launch_bwd_dq_wgmma(const BwdArgs& a, void* dq);

}  // namespace vcd
