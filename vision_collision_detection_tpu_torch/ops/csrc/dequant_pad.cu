// K1: uint8 letterbox-content frames -> normalised, padded frames in bf16
// or float32.
//
// Replaces the TPU kernel vision_collision_detection_tpu/ops/pallas_ops.py
// `fused_dequant_normalize_pad` (`_kernel`), which takes the output dtype as
// a parameter too. out[n, i, j, c] is x * a[c] + b[c] where (i, j) falls on
// the content placed at ((S - ch) / 2, (S - cw) / 2), and b[c] (the
// normalised black) on the bars.
//
// Bound on the H100: bytes. It reads each content byte once and writes each
// output once (N*ch*cw*3 + N*S*S*3*sizeof(T) bytes); there is no arithmetic
// to speak of. Each thread writes 16 bytes (8 bf16 or 4 float32) of the flat
// channel-packed output, so stores are full 16-byte vectors and a warp
// writes 512 contiguous bytes. x * a + b is computed with __fmul_rn /
// __fadd_rn so that nvcc does not contract it into an FMA: the result is
// then bit-equal to the plain PyTorch version, which rounds after the
// product too.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float v) {
  return __float2bfloat16_rn(v);
}

template <>
__device__ __forceinline__ float from_float(float v) {
  return v;
}

template <typename T>
__global__ void dequant_pad_kernel(const uint8_t* __restrict__ in,
                                   T* __restrict__ out, int64_t total, int ch,
                                   int cw, int S, int pad_h, int pad_w,
                                   float a0, float a1, float a2, float b0,
                                   float b1, float b2) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t e0 = v * VEC;
  if (e0 >= total) return;
  const float a[3] = {a0, a1, a2};
  const float b[3] = {b0, b1, b2};
  const int64_t frame_elems = (int64_t)S * S * 3;
  const int row_elems = S * 3;
  __align__(16) T vals[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int64_t e = e0 + k;
    if (e >= total) break;
    const int64_t f = e / frame_elems;
    const int rem = (int)(e - f * frame_elems);
    const int r = rem / row_elems;
    const int col = rem - r * row_elems;
    const int x = col / 3;
    const int c = col - x * 3;
    const int cr = r - pad_h;
    const int cx = x - pad_w;
    float y = b[c];
    if (cr >= 0 && cr < ch && cx >= 0 && cx < cw) {
      const float u = (float)in[((f * ch + cr) * cw + cx) * 3 + c];
      y = __fadd_rn(__fmul_rn(u, a[c]), b[c]);
    }
    vals[k] = from_float<T>(y);
  }
  if (e0 + VEC <= total) {
    *reinterpret_cast<uint4*>(out + e0) = *reinterpret_cast<const uint4*>(vals);
  } else {
    for (int64_t e = e0; e < total; ++e) out[e] = vals[e - e0];
  }
}

template <typename T>
int launch(const void* in, void* out, int n, int ch, int cw, int S, float a0,
           float a1, float a2, float b0, float b1, float b2, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t total = (int64_t)n * S * S * 3;
  const int threads = 256;
  const int64_t vecs = (total + VEC - 1) / VEC;
  const unsigned blocks = (unsigned)((vecs + threads - 1) / threads);
  if (blocks > 0) {
    dequant_pad_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (T*)out, total, ch, cw, S, (S - ch) / 2,
        (S - cw) / 2, a0, a1, a2, b0, b1, b2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of out: 0 = bfloat16, 1 = float32. in [n, ch, cw, 3] uint8 and out
// [n, S, S, 3] contiguous; out starts on a 16-byte boundary.
extern "C" int vcd_dequant_pad(const void* in, void* out, int n, int ch,
                               int cw, int S, float a0, float a1, float a2,
                               float b0, float b1, float b2, int dtype,
                               void* stream) {
  if (dtype == 0)
    return launch<__nv_bfloat16>(in, out, n, ch, cw, S, a0, a1, a2, b0, b1,
                                 b2, stream);
  if (dtype == 1)
    return launch<float>(in, out, n, ch, cw, S, a0, a1, a2, b0, b1, b2,
                         stream);
  return (int)cudaErrorInvalidValue;
}
