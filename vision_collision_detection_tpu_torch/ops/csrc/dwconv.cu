// K2: depthwise 7x7 convolution, stride 1, SAME (3-pixel zero halo), + bias,
// NHWC, float32 accumulation. Forward only.
//
// Replaces the TPU kernel vision_collision_detection_tpu/ops/dwconv_pallas.py
// `dwconv7x7` -> `_run_fwd` (`_fwd_kernel`). That kernel read a frame padded
// in HBM by jnp.pad; here the halo is masked while the tile is loaded, so
// the padded copy never exists.
//
// Bound on the H100: operations. 98 flops per output element against 4
// bytes moved (bf16 in and out): the float32 FMAs run on the CUDA cores
// (67 TFLOP/s), not the tensor cores, so the 49 taps take longer than the
// bytes (3.35 TB/s) at any width. The design keeps each input element's 49
// reads in shared memory: a block loads one frame's (16+6) x (8+6) pixel
// tile for a slab of 32 channels once, as packed channel pairs, then each
// thread owns one channel pair and one output row of the tile and slides a
// 14-pixel register window over the 7 taps of each kernel row, so a loaded
// pixel feeds up to 7 FMAs from registers. Taps are summed in (dy, dx)
// order from 0, then the bias is added, as in the TPU kernel.
#include "common.cuh"

namespace {

constexpr int K = 7;
constexpr int PAD = 3;
constexpr int TH = 16;          // output rows per block
constexpr int TW = 8;           // output columns per block
constexpr int CS = 32;          // channels per block
constexpr int PAIRS = CS / 2;   // threadIdx.x: channel pair
constexpr int IH = TH + 2 * PAD;
constexpr int IW = TW + 2 * PAD;

template <typename T>
__global__ void __launch_bounds__(PAIRS * TH, 2)
dwconv7x7_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int C, int tiles_w) {
  using P = vcd::Pair<T>;
  __shared__ typename P::vec tile[IH][IW][PAIRS];
  __shared__ float2 wsm[K * K][PAIRS];

  const int n = blockIdx.z;
  const int c0 = blockIdx.y * CS;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.y * PAIRS + threadIdx.x;
  const int nthreads = PAIRS * TH;

  for (int i = tid; i < IH * IW * PAIRS; i += nthreads) {
    const int p = i % PAIRS;
    const int pix = i / PAIRS;
    const int iy = pix / IW;
    const int ix = pix % IW;
    const int gy = h0 - PAD + iy;
    const int gx = w0 - PAD + ix;
    const int c = c0 + 2 * p;
    typename P::vec v = P::zero();
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C) {
      v = P::load_vec(x + (((int64_t)n * H + gy) * W + gx) * C + c);
    }
    tile[iy][ix][p] = v;
  }
  for (int i = tid; i < K * K * PAIRS; i += nthreads) {
    const int p = i % PAIRS;
    const int tap = i / PAIRS;
    const int c = c0 + 2 * p;
    float2 v = make_float2(0.f, 0.f);
    if (c < C) v = vcd::Pair<T>::load(w + (int64_t)tap * C + c);
    wsm[tap][p] = v;
  }
  __syncthreads();

  const int p = threadIdx.x;
  const int r = threadIdx.y;
  float2 acc[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) acc[j] = make_float2(0.f, 0.f);

#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    float2 row[IW];
#pragma unroll
    for (int j = 0; j < IW; ++j) row[j] = P::to_float2(tile[r + dy][j][p]);
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float2 wv = wsm[dy * K + dx][p];
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        acc[j].x = fmaf(row[j + dx].x, wv.x, acc[j].x);
        acc[j].y = fmaf(row[j + dx].y, wv.y, acc[j].y);
      }
    }
  }

  const int c = c0 + 2 * p;
  const int gy = h0 + r;
  if (c >= C || gy >= H) return;
  const float2 bv = vcd::Pair<T>::load(bias + c);
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int gx = w0 + j;
    if (gx < W) {
      float2 v = make_float2(acc[j].x + bv.x, acc[j].y + bv.y);
      vcd::Pair<T>::store(out + (((int64_t)n * H + gy) * W + gx) * C + c, v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int n,
           int H, int W, int C, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (C + CS - 1) / CS, n);
  dim3 block(PAIRS, TH);
  if (n > 0) {
    dwconv7x7_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)out, H, W, C, tiles_w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. x/out [n, H, W, C], w [49, C], b [C],
// all of that dtype and contiguous; C must be even.
extern "C" int vcd_dwconv7x7(const void* x, const void* w, const void* b,
                             void* out, int n, int H, int W, int C, int dtype,
                             void* stream) {
  if (dtype == 0) return launch<__nv_bfloat16>(x, w, b, out, n, H, W, C, stream);
  if (dtype == 1) return launch<float>(x, w, b, out, n, H, W, C, stream);
  return (int)cudaErrorInvalidValue;
}
