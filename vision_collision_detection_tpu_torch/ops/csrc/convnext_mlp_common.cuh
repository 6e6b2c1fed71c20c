// What K3's two kernels share (convnext_mlp.cu, convnext_mlp_wgmma.cu):
// the LayerNorm's epsilon and GELU in float32.
#pragma once

namespace vcd {

constexpr float LN_EPS = 1e-6f;

// GELU in float32, the tanh form where APPROX, else the erf form. The tanh
// form is evaluated as v * sigmoid(2u), since 0.5 * (1 + tanh(u)) =
// 1 / (1 + exp(-2u)): one exp and one division on the fast paths (relative
// error ~1e-6, far under h's bf16 rounding) instead of tanhf's branches.
// exp's argument is capped so that the divisor stays finite.
template <bool APPROX>
__device__ __forceinline__ float gelu(float v) {
  if constexpr (APPROX) {
    const float u = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    return __fdividef(v, 1.0f + __expf(fminf(-2.0f * u, 80.0f)));
  } else {
    return v * (erff(v / 1.4142135623730951f) + 1.0f) / 2.0f;
  }
}
__device__ __forceinline__ float gelu(float v, int approximate) {
  return approximate ? gelu<true>(v) : gelu<false>(v);
}

}  // namespace vcd
