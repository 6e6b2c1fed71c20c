// Shared helpers for the port's kernels: typed loads and stores of channel
// pairs, so one template body serves bf16 and float32 tensors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vcd {

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using vec = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ vec load_vec(const __nv_bfloat16* p) {
    return *reinterpret_cast<const vec*>(p);
  }
  static __device__ __forceinline__ vec zero() {
    return __floats2bfloat162_rn(0.f, 0.f);
  }
  static __device__ __forceinline__ float2 to_float2(vec v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
};

template <>
struct Pair<float> {
  using vec = float2;
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ vec load_vec(const float* p) {
    return *reinterpret_cast<const vec*>(p);
  }
  static __device__ __forceinline__ vec zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ float2 to_float2(vec v) { return v; }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

}  // namespace vcd
