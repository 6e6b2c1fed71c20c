// K2 weight gradient: the per-tap reduction of the depthwise 7x7 conv's
// backward,
//   dw[dy*7 + dx, c] = sum over n, h, w of x[n, h+dy-3, w+dx-3, c] * g[n, h, w, c]
// with the halo read as zero, in float32, for bf16 or float32 NHWC x and g.
//
// Replaces the TPU kernel vision_collision_detection_tpu/ops/dwconv_pallas.py
// `_run_wgrad` (`_wgrad_kernel`). That kernel visited the frames in order and
// added each frame's sums into one [49, C] block, which a TPU grid may do
// because it runs in order. Here blocks run in parallel, so each block keeps
// its own sums and a second pass adds the blocks' partial sums in a fixed
// order. No float atomics: two runs give the same dw bit for bit.
//
// Bound on the H100: operations. 49 FMAs (98 flops) per input element
// against 4 bytes read (bf16 x and g): the float32 FMAs run on the CUDA
// cores (67 TFLOP/s), so at every width they take longer than the bytes
// (3.35 TB/s).
//
// Design. A block owns a slab of 32 channels and one of `parts` shares of the
// (frame, 8x8 output tile) space, which it walks tile by tile. For each tile
// it loads x with its 3-pixel halo (14x14 pixels, masked at the borders) and
// g (8x8) into shared memory as float32, 16 bytes per load. Each thread owns
// one channel and one tile row: it keeps that row of g in registers and, for
// each kernel row dy, slides a 14-value register window of x over the 7
// taps dx, so a loaded value feeds up to 7 FMAs. Its 49 sums stay in
// registers over all of the block's tiles. At the end the 8 rows' sums are
// added in shared memory, in row order, into partial[part, tap, c]; the
// second kernel adds the parts in order.
#include "common.cuh"

namespace {

constexpr int K = 7;
constexpr int PAD = 3;
constexpr int TH = 8;            // output rows per tile (threadIdx.y)
constexpr int TW = 8;            // output columns per tile
constexpr int CS = 32;           // channels per block (threadIdx.x)
constexpr int IH = TH + 2 * PAD;
constexpr int IW = TW + 2 * PAD;
constexpr int THREADS = CS * TH;
constexpr int VPP = CS / 8;      // 8-channel vectors per pixel

// Eight consecutive channels as float32, 16 bytes (bf16) or 32 bytes per load.
template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float4& a, float4& b) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 f0 = __bfloat1622float2(v[0]), f1 = __bfloat1622float2(v[1]);
    const float2 f2 = __bfloat1622float2(v[2]), f3 = __bfloat1622float2(v[3]);
    a = make_float4(f0.x, f0.y, f1.x, f1.y);
    b = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
};
template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float4& a,
                                              float4& b) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
dwconv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    float* __restrict__ partial, int n_frames, int H, int W,
                    int C, int tiles_w, int tiles_per_frame, int parts) {
  __shared__ __align__(16) float xs[IH][IW][CS];
  __shared__ __align__(16) float gs[TH][TW][CS];

  const int c0 = blockIdx.x * CS;
  const int part = blockIdx.y;
  const int cx = threadIdx.x;
  const int r = threadIdx.y;
  const int tid = r * CS + cx;

  float acc[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) acc[i] = 0.f;

  const int64_t tiles = (int64_t)n_frames * tiles_per_frame;
  for (int64_t tile = part; tile < tiles; tile += parts) {
    const int64_t n = tile / tiles_per_frame;
    const int tt = (int)(tile % tiles_per_frame);
    const int h0 = (tt / tiles_w) * TH;
    const int w0 = (tt % tiles_w) * TW;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < IH * IW * VPP; i += THREADS) {
      const int v = i % VPP, pix = i / VPP;
      const int iy = pix / IW, ix = pix % IW;
      const int gy = h0 - PAD + iy, gx = w0 - PAD + ix;
      const int c = c0 + 8 * v;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
        Vec8<T>::load(x + ((n * H + gy) * W + gx) * C + c, a, b);
      float4* dst = reinterpret_cast<float4*>(&xs[iy][ix][8 * v]);
      dst[0] = a;
      dst[1] = b;
    }
    for (int i = tid; i < TH * TW * VPP; i += THREADS) {
      const int v = i % VPP, pix = i / VPP;
      const int iy = pix / TW, ix = pix % TW;
      const int gy = h0 + iy, gx = w0 + ix;
      const int c = c0 + 8 * v;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (gy < H && gx < W && c < C)
        Vec8<T>::load(g + ((n * H + gy) * W + gx) * C + c, a, b);
      float4* dst = reinterpret_cast<float4*>(&gs[iy][ix][8 * v]);
      dst[0] = a;
      dst[1] = b;
    }
    __syncthreads();

    float grow[TW];
#pragma unroll
    for (int j = 0; j < TW; ++j) grow[j] = gs[r][j][cx];
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      float row[IW];
#pragma unroll
      for (int j = 0; j < IW; ++j) row[j] = xs[r + dy][j][cx];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        float s = acc[dy * K + dx];
#pragma unroll
        for (int j = 0; j < TW; ++j) s = fmaf(row[j + dx], grow[j], s);
        acc[dy * K + dx] = s;
      }
    }
  }

  // The 8 rows' sums, one kernel row dy at a time: red[dx][r][c] in the
  // space of xs, then thread (c, r < 7) adds rows 0..7 of tap (dy, r).
  float* red = &xs[0][0][0];
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    __syncthreads();
#pragma unroll
    for (int dx = 0; dx < K; ++dx) red[(dx * TH + r) * CS + cx] = acc[dy * K + dx];
    __syncthreads();
    if (r < K && c0 + cx < C) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < TH; ++q) s += red[(r * TH + q) * CS + cx];
      partial[((int64_t)part * K * K + dy * K + r) * C + c0 + cx] = s;
    }
  }
}

// dw[i] = sum over p of partial[p, i], in order p = 0, 1, ...
__global__ void wgrad_sum_parts(const float* __restrict__ partial,
                                float* __restrict__ dw, int parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(int64_t)p * n + i];
  dw[i] = s;
}

template <typename T>
int launch(const void* x, const void* g, void* partial, void* dw, int n,
           int H, int W, int C, int parts, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  cudaStream_t s = (cudaStream_t)stream;
  if (parts < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((C + CS - 1) / CS, parts);
  dim3 block(CS, TH);
  dwconv_wgrad_kernel<T><<<grid, block, 0, s>>>(
      (const T*)x, (const T*)g, (float*)partial, n, H, W, C, tiles_w,
      tiles_w * tiles_h, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = K * K * C;
  wgrad_sum_parts<<<(total + 255) / 256, 256, 0, s>>>(
      (const float*)partial, (float*)dw, parts, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. x, g [n, H, W, C] of that dtype,
// contiguous, C a multiple of 8, 16-byte aligned; partial float32
// [parts, 49, C] scratch; dw float32 [49, C].
extern "C" int vcd_dwconv_wgrad(const void* x, const void* g, void* partial,
                                void* dw, int n, int H, int W, int C,
                                int parts, int dtype, void* stream) {
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, g, partial, dw, n, H, W, C, parts, stream);
  if (dtype == 1) return launch<float>(x, g, partial, dw, n, H, W, C, parts, stream);
  return (int)cudaErrorInvalidValue;
}
