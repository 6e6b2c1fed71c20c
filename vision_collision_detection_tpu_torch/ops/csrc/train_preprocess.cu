// The training preprocess in two launches: uint8 letterbox content ->
// flipped, letterboxed, augmented, normalised frames in bf16 or float32.
//
// Replaces no TPU kernel: the JAX package leaves train_preprocess to XLA,
// which fuses it on a TPU; in eager PyTorch the same function is a chain of
// about a hundred launches with float32 intermediates (ops/preprocess.py,
// the plain version). ops/fused_preprocess.py routes to it uint8 content
// [B, T, ch, cw, 3] with ch, cw <= S and one of them S (K1's test), under a
// configuration with no noise and no blur: every step is then a function of
// a few source pixels. The wrapper draws the parameters as the chain does
// and packs them into a float32 table [B, ncol] (Col below); nothing is
// read back to the host.
//
// Bound on the H100: bytes. The function reads the content once and writes
// the frames once: at [8, 32, 189, 336, 3] -> [8, 32, 336, 336, 3] bf16
// that is 48.8 MB + 173.4 MB, about 0.066 ms at 3.35 TB/s. This design
// reads the content twice (once for the contrast means, once for the
// frames), 271 MB or about 0.081 ms; a frame's 190 KB of content would fit
// one block's shared memory, so a design with one read exists. The arithmetic (the HSV round trip
// and three IEEE divisions a source pixel, three a normalised pixel) is a
// few hundred instructions a pixel, about 0.3 ms of the card's CUDA cores
// at that shape if each source pixel is adjusted once.
//
// Launch 1, frame_means: one block a frame sums gray(clamp(x/255 * b)) over
// the content in a fixed order (the bars are black, so they add 0) and
// divides by S^2: the per-frame mean that contrast blends towards.
//
// Launch 2, fused_frames: a block takes a tile of 32 x 56 output pixels of
// one clip (a thread 8 neighbours in a row, so its output is 16-byte
// stores) through FPB of the clip's frames. The coordinate map is the
// clip's, so the tile's source box (the rows and columns its bilinear taps
// reach) is found once, from the tile's corners: every coordinate is a
// monotone function of x and of y, each rounding included. For each frame
// the block first adjusts the colour of every source pixel of the box into
// shared memory (brightness, contrast, saturation, hue: the HSV arithmetic
// runs once a source pixel, about 1.7 a tile pixel, instead of four times,
// once a tap), then blends each output pixel's four taps from there. A box
// larger than shared memory (a scale far below 1) adjusts each tap where it
// is read instead; the result is the same. The box is the design because
// the card says so: at [8, 32, 189, 336, 3] -> bf16 on an H100 the two
// launches take 0.84 ms with it and 1.66 ms with every tile on the
// per-tap path (the same source with CAP = 0), bit for bit the same frames.
//
// The arithmetic is the chain's, operation for operation, in float32:
// products and sums rounded as PyTorch's separate elementwise kernels round
// them (__fmul_rn / __fadd_rn, so nvcc does not contract them into FMAs),
// x / c for a constant c as PyTorch's CUDA kernels take it (x * (1/c)),
// IEEE division elsewhere. The separable warp rounds its operands to bf16
// where the chain's two batched products do (the adjusted frame, the band
// weights, the first pass's result) and sums each pass's two products in
// float32; the gather warp is float32 throughout. Every output is rounded
// once, to out_dtype. What differs from the chain is the order of the
// contrast mean's sum and of the luma dot products' (cuBLAS's).
#include "common.cuh"

namespace {

// columns of the table: ops/fused_preprocess.py
enum Col {
  FLIP = 0, SKIP, BRIGHTNESS, CONTRAST, SATURATION, HUE, GRAYSCALE, POSTERIZE,
  POSTERIZE_BITS, SOLARIZE, INVERT, CUTS, WARP = 12, BOXES = 20
};

constexpr int NX = 7;               // threads along a tile row
constexpr int PX = 8;               // pixels a thread
constexpr int TW = NX * PX;         // 56 columns a tile
constexpr int TH = 32;              // rows a tile
constexpr int THREADS = NX * TH;    // 224
constexpr int FPB = 8;              // frames a block
constexpr int CAP = 4000;           // source pixels of a box in shared memory
constexpr int MEAN_THREADS = 512;

constexpr float INV255 = 1.0f / 255.0f;  // PyTorch's x / 255.0 on the card
constexpr float INV6 = 1.0f / 6.0f;      // its h / 6.0
constexpr float L0 = 0.2989f, L1 = 0.587f, L2 = 0.114f;  // luma weights

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float gray(float r, float g, float b) {
  return fmaf(b, L2, fmaf(g, L1, mul(r, L0)));
}
// torch.remainder(a, 1.0) on the card: fmod(a, 1), moved into [0, 1).
// fmod(a, 1) is a - trunc(a), and that difference is exact in float32.
__device__ __forceinline__ float rem1(float a) {
  float m = sub(a, truncf(a));
  if (m != 0.f && m < 0.f) m = add(m, 1.f);
  return m;
}
// a * f + (1 - f) * m, each step rounded: contrast's and saturation's blend
__device__ __forceinline__ float blend(float f, float a, float fm) {
  return clamp01(add(mul(f, a), fm));
}

struct Clip {
  float brightness, contrast, saturation, hue;
};

// brightness -> contrast (cm: (1 - c) * the frame's mean) -> saturation ->
// hue, in place on one pixel, as ops/color.py computes them
__device__ __forceinline__ void adjust(float (&v)[3], const Clip& cp,
                                       float cm) {
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = clamp01(mul(v[c], cp.brightness));
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = blend(cp.contrast, v[c], cm);
  const float sg = mul(sub(1.f, cp.saturation), gray(v[0], v[1], v[2]));
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = blend(cp.saturation, v[c], sg);
  // hue: rgb_to_hsv, the shift, hsv_to_rgb
  const float r = clamp01(v[0]), g = clamp01(v[1]), b = clamp01(v[2]);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = sub(maxc, minc);
  const float sd = delta == 0.f ? 1.f : delta;
  const float s = maxc == 0.f ? 0.f : __fdiv_rn(delta, maxc);
  float h;
  if (maxc == r)
    h = sub(__fdiv_rn(sub(maxc, b), sd), __fdiv_rn(sub(maxc, g), sd));
  else if (maxc == g)
    h = sub(add(2.f, __fdiv_rn(sub(maxc, r), sd)), __fdiv_rn(sub(maxc, b), sd));
  else
    h = sub(add(4.f, __fdiv_rn(sub(maxc, g), sd)), __fdiv_rn(sub(maxc, r), sd));
  if (delta == 0.f) h = 0.f;
  h = rem1(add(rem1(mul(h, INV6)), cp.hue));
  const float h6 = mul(h, 6.f);
  const float fi = floorf(h6);
  const float f = sub(h6, fi);
  const float p = mul(maxc, sub(1.f, s));
  const float q = mul(maxc, sub(1.f, mul(s, f)));
  const float t = mul(maxc, sub(1.f, mul(s, sub(1.f, f))));
  int i = (int)fi % 6;
  if (i < 0) i += 6;
  switch (i) {
    case 0: v[0] = maxc; v[1] = t; v[2] = p; break;
    case 1: v[0] = q; v[1] = maxc; v[2] = p; break;
    case 2: v[0] = p; v[1] = maxc; v[2] = t; break;
    case 3: v[0] = p; v[1] = q; v[2] = maxc; break;
    case 4: v[0] = t; v[1] = p; v[2] = maxc; break;
    default: v[0] = maxc; v[1] = p; v[2] = q; break;
  }
}

struct Geometry {
  int S, ch, cw, pad_h, pad_w;
};

// the letterboxed, flipped frame at (i, k), in [0, 1]; the bars are black.
// Returns whether (i, k) is content.
__device__ __forceinline__ bool source(const uint8_t* frame, const Geometry& g,
                                       bool flip, int i, int k, float (&v)[3]) {
  const int ci = i - g.pad_h;
  const int ck = (flip ? g.S - 1 - k : k) - g.pad_w;
  if (ci >= 0 && ci < g.ch && ck >= 0 && ck < g.cw) {
    const uint8_t* px = frame + ((size_t)ci * g.cw + ck) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = mul((float)__ldg(px + c), INV255);
    return true;
  }
  v[0] = v[1] = v[2] = 0.f;
  return false;
}

// ---- launch 1 ----------------------------------------------------------

__global__ void __launch_bounds__(MEAN_THREADS)
frame_means(const uint8_t* __restrict__ in, const float* __restrict__ table,
            float* __restrict__ means, int T, int ch, int cw, int S,
            int ncol) {
  const int n = blockIdx.x;
  const float fb = table[(size_t)(n / T) * ncol + BRIGHTNESS];
  const uint8_t* frame = in + (size_t)n * ch * cw * 3;
  const int npx = ch * cw;
  float acc = 0.f;
  for (int i = threadIdx.x; i < npx; i += MEAN_THREADS) {
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = clamp01(mul(mul((float)__ldg(frame + 3 * i + c), INV255), fb));
    acc = add(acc, gray(v[0], v[1], v[2]));
  }
  // a fixed tree: the warps' shuffles, then warp 0 over the warps' sums
  __shared__ float part[MEAN_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = add(acc, __shfl_xor_sync(~0u, acc, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < MEAN_THREADS / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = add(acc, __shfl_xor_sync(~0u, acc, o));
    if (threadIdx.x == 0) means[n] = __fdiv_rn(acc, (float)S * (float)S);
  }
}

// ---- launch 2 ----------------------------------------------------------

struct Norm {
  float mean[3], std[3], threshold;
};

// the clip's inverse map: separable (mode 0) or gather (mode 1)
struct Warp {
  int mode;
  float w[7];
  float cx, cy;
  // separable: q (the source row coordinate at output (j, x)) and p (the
  // source column coordinate at source row i, output column x)
  __device__ __forceinline__ float q(float x, float j) const {
    return add(add(mul(w[3], x), mul(w[4], j)), w[5]);
  }
  __device__ __forceinline__ float p(float x, float i) const {
    return add(add(mul(w[0], x), mul(w[1], i)), w[2]);
  }
  // gather: the source coordinates of output (j, x)
  __device__ __forceinline__ void src(float x, float j, float& sy,
                                      float& sx) const {
    const float dx = sub(sub(x, cx), w[5]);
    const float dy = sub(sub(j, cy), w[6]);
    sx = add(__fdiv_rn(add(mul(w[0], dx), mul(w[1], dy)), w[4]), cx);
    sy = add(__fdiv_rn(add(mul(w[2], dx), mul(w[3], dy)), w[4]), cy);
  }
};

// the adjusted source pixel (i, k) of a frame, computed where it is read;
// bf16-rounded for the separable warp, whose first product takes bf16. The
// bars (black) all take one colour, ``bar``, adjusted once a frame.
struct Adjusted {
  const uint8_t* frame;
  Geometry g;
  bool flip, round_bf16;
  Clip cp;
  float cm;
  float bar[3];
  __device__ __forceinline__ void finish(float (&v)[3]) const {
    adjust(v, cp, cm);
    if (round_bf16) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = bf16r(v[c]);
    }
  }
  __device__ __forceinline__ void init() {
    bar[0] = bar[1] = bar[2] = 0.f;
    finish(bar);
  }
  __device__ __forceinline__ void operator()(int i, int k,
                                             float (&v)[3]) const {
    if (source(frame, g, flip, i, k, v)) {
      finish(v);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = bar[c];
    }
  }
};

// the same pixel from the block's box in shared memory
struct FromBox {
  const float* box;
  int r0, c0, bw;
  __device__ __forceinline__ void operator()(int i, int k,
                                             float (&v)[3]) const {
    const int idx = (i - r0) * bw + (k - c0);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = box[c * CAP + idx];
  }
};

__device__ __forceinline__ float band(float c, int i) {
  return bf16r(fmaxf(sub(1.f, fabsf(sub(c, (float)i))), 0.f));
}

// one output pixel's warped value from fetch(i, k, v) (the adjusted source
// pixel, bf16-rounded for the separable warp); taps outside the frame are 0
template <typename Fetch>
__device__ __forceinline__ void warp_pixel(const Warp& wp, int S, int j, int x,
                                           const Fetch& fetch, float (&o)[3]) {
  const float xf = (float)x, jf = (float)j;
  o[0] = o[1] = o[2] = 0.f;
  if (wp.mode == 0) {
    const float q = wp.q(xf, jf);
    const int i0 = (int)floorf(q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r;
      if (i < 0 || i >= S) continue;
      const float wy = band(q, i);
      const float p = wp.p(xf, (float)i);
      const int k0 = (int)floorf(p);
      float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + e;
        if (k < 0 || k >= S) continue;
        const float wx = band(p, k);
        float v[3];
        fetch(i, k, v);
#pragma unroll
        for (int c = 0; c < 3; ++c) t[c] = add(t[c], mul(wx, v[c]));
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] = add(o[c], mul(wy, bf16r(t[c])));
    }
  } else {
    float sy, sx;
    wp.src(xf, jf, sy, sx);
    const float y0 = floorf(sy), x0 = floorf(sx);
    const float wy = sub(sy, y0), wx = sub(sx, x0);
    const int iy = (int)y0, ix = (int)x0;
    float v[4][3];
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int i = iy + (tap >> 1), k = ix + (tap & 1);
      if (i >= 0 && i < S && k >= 0 && k < S) {
        fetch(i, k, v[tap]);
      } else {
        v[tap][0] = v[tap][1] = v[tap][2] = 0.f;
      }
    }
    const float ux = sub(1.f, wx), uy = sub(1.f, wy);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float top = add(mul(v[0][c], ux), mul(v[1][c], wx));
      const float bot = add(mul(v[2][c], ux), mul(v[3][c], wx));
      o[c] = add(mul(top, uy), mul(bot, wy));
    }
  }
}

// the source box of output rows [j0, j1] and columns [x0, x1]: rows
// [r0, r1] and columns [c0, c1] of the frame, clipped to it (r1 < r0: none)
__device__ void source_box(const Warp& wp, int S, int j0, int j1, int x0,
                           int x1, int& r0, int& r1, int& c0, int& c1) {
  float ylo, yhi, xlo, xhi;
  const float xs[2] = {(float)x0, (float)x1}, js[2] = {(float)j0, (float)j1};
  if (wp.mode == 0) {
    ylo = yhi = wp.q(xs[0], js[0]);
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b) {
        const float q = wp.q(xs[a], js[b]);
        ylo = fminf(ylo, q);
        yhi = fmaxf(yhi, q);
      }
    // rows the taps read: floor(q) and floor(q) + 1
    const float ia = floorf(ylo), ib = add(floorf(yhi), 1.f);
    xlo = xhi = wp.p(xs[0], ia);
    for (int a = 0; a < 2; ++a) {
      const float is[2] = {ia, ib};
      for (int b = 0; b < 2; ++b) {
        const float p = wp.p(xs[a], is[b]);
        xlo = fminf(xlo, p);
        xhi = fmaxf(xhi, p);
      }
    }
  } else {
    wp.src(xs[0], js[0], ylo, xlo);
    yhi = ylo;
    xhi = xlo;
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b) {
        float sy, sx;
        wp.src(xs[a], js[b], sy, sx);
        ylo = fminf(ylo, sy);
        yhi = fmaxf(yhi, sy);
        xlo = fminf(xlo, sx);
        xhi = fmaxf(xhi, sx);
      }
  }
  // a coordinate past the frame (or not finite) is clipped to it; the
  // taps outside read 0 and are not stored
  auto lo = [&](float v) { return v > -1.f ? (int)floorf(v) : -1; };
  auto hi = [&](float v) { return v < (float)S ? (int)floorf(v) + 1 : S; };
  r0 = max(lo(ylo), 0);
  r1 = min(hi(yhi), S - 1);
  c0 = max(lo(xlo), 0);
  c1 = min(hi(xhi), S - 1);
}

// the rare path: a box too large for shared memory (returned by value, so
// that the caller's pixel stays in registers)
__device__ __noinline__ float3 warp_pixel_direct(const Warp& wp, int S, int j,
                                                 int x, const Adjusted fetch) {
  float o[3];
  warp_pixel(wp, S, j, x, fetch, o);
  return make_float3(o[0], o[1], o[2]);
}

template <typename T>
struct Out;

template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void put(__nv_bfloat16* dst,
                                             const float* y, int n) {
#pragma unroll
    for (int e = 0; e < 24; ++e)
      if (e < n) dst[e] = __float2bfloat16_rn(y[e]);
  }
  // 24 values, 48 bytes, 16-byte aligned
  static __device__ __forceinline__ void put24(__nv_bfloat16* dst,
                                               const float* y) {
    uint32_t wd[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
      wd[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int e = 0; e < 3; ++e)
      d[e] = make_uint4(wd[4 * e], wd[4 * e + 1], wd[4 * e + 2], wd[4 * e + 3]);
  }
};

template <>
struct Out<float> {
  static __device__ __forceinline__ void put(float* dst, const float* y,
                                             int n) {
#pragma unroll
    for (int e = 0; e < 24; ++e)
      if (e < n) dst[e] = y[e];
  }
  static __device__ __forceinline__ void put24(float* dst, const float* y) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int e = 0; e < 6; ++e)
      d[e] = make_float4(y[4 * e], y[4 * e + 1], y[4 * e + 2], y[4 * e + 3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
fused_frames(const uint8_t* __restrict__ in, const float* __restrict__ table,
             const float* __restrict__ means, T* __restrict__ out, int T_,
             Geometry g, int ncol, int mode, Norm nm, int vec) {
  extern __shared__ float box[];  // 3 planes of CAP floats
  const int S = g.S;
  const int groups = (T_ + FPB - 1) / FPB;
  const int b = blockIdx.z / groups;
  const int t0 = (blockIdx.z - b * groups) * FPB;
  const int t1 = min(t0 + FPB, T_);
  const float* row = table + (size_t)b * ncol;
  const bool flip = row[FLIP] != 0.f;
  const bool skip = row[SKIP] != 0.f;
  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  const int j = blockIdx.y * TH + ty;
  const int xb = blockIdx.x * TW + tx * PX;  // the thread's first column
  const int tile_j1 = min((int)(blockIdx.y + 1) * TH, S) - 1;
  const int tile_x1 = min((int)(blockIdx.x + 1) * TW, S) - 1;
  const bool active = j < S && xb < S;
  const int npx = active ? min(PX, S - xb) : 0;
  const size_t frame_out = (size_t)S * S * 3;
  const size_t frame_in = (size_t)g.ch * g.cw * 3;

  auto store = [&](int t, const float* y) {
    T* dst = out + ((size_t)b * T_ + t) * frame_out +
             ((size_t)j * S + xb) * 3;
    if (vec && npx == PX)
      Out<T>::put24(dst, y);
    else
      Out<T>::put(dst, y, npx * 3);
  };
  auto normalise = [&](float (&v)[3], float* y) {
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = __fdiv_rn(sub(v[c], nm.mean[c]), nm.std[c]);
  };

  if (skip) {  // the skip gate: the untouched letterboxed frames
    for (int t = t0; t < t1; ++t) {
      if (!active) continue;
      const uint8_t* frame = in + ((size_t)b * T_ + t) * frame_in;
      float y[PX * 3];
#pragma unroll
      for (int e = 0; e < PX; ++e) {
        float v[3] = {0.f, 0.f, 0.f};
        if (e < npx) source(frame, g, flip, j, xb + e, v);
        normalise(v, y + 3 * e);
      }
      store(t, y);
    }
    return;
  }

  const Clip cp = {row[BRIGHTNESS], row[CONTRAST], row[SATURATION], row[HUE]};
  Warp wp;
  wp.mode = mode;
#pragma unroll
  for (int e = 0; e < 7; ++e) wp.w[e] = row[WARP + e];
  wp.cx = (S - 1) * 0.5f;
  wp.cy = (S - 1) * 0.5f;
  const bool gray_on = row[GRAYSCALE] != 0.f;
  const bool post_on = row[POSTERIZE] != 0.f;
  const int post_step = 1 << min(max(8 - (int)row[POSTERIZE_BITS], 0), 8);
  const bool solar_on = row[SOLARIZE] != 0.f;
  const bool invert_on = row[INVERT] != 0.f;
  const int cuts = (int)row[CUTS];

  // this thread's pixels inside an active cutout box (bit e: pixel e)
  unsigned cut_mask = 0;
  for (int k = 0; k < cuts; ++k) {
    const int top = (int)row[BOXES + 4 * k], left = (int)row[BOXES + 4 * k + 1];
    const int bh = (int)row[BOXES + 4 * k + 2], bw = (int)row[BOXES + 4 * k + 3];
    if (j >= top && j < top + bh)
      for (int e = 0; e < PX; ++e)
        if (xb + e >= left && xb + e < left + bw) cut_mask |= 1u << e;
  }

  int r0, r1, c0, c1;
  source_box(wp, S, blockIdx.y * TH, tile_j1, blockIdx.x * TW, tile_x1, r0, r1,
             c0, c1);
  const int bh = max(r1 - r0 + 1, 0), bw = max(c1 - c0 + 1, 0);
  const bool in_smem = bh * bw <= CAP;
  const float inv_bw = 1.f / (float)max(bw, 1);
  const FromBox from_box = {box, r0, c0, bw};

  for (int t = t0; t < t1; ++t) {
    const uint8_t* frame = in + ((size_t)b * T_ + t) * frame_in;
    const float cm = mul(sub(1.f, cp.contrast), means[(size_t)b * T_ + t]);
    Adjusted adjusted = {frame, g, flip, mode == 0, cp, cm};
    adjusted.init();
    if (in_smem) {
      for (int idx = threadIdx.x; idx < bh * bw; idx += THREADS) {
        // idx / bw: (idx + 1/2) / bw lies at least 1/(2 bw) from a whole
        // number, and the float product misses it by under idx 2^-23 / bw
        const int ri = (int)(((float)idx + 0.5f) * inv_bw);
        float v[3];
        adjusted(r0 + ri, c0 + idx - ri * bw, v);
#pragma unroll
        for (int c = 0; c < 3; ++c) box[c * CAP + idx] = v[c];
      }
      __syncthreads();
    }
    if (active) {
      float y[PX * 3];
#pragma unroll
      for (int e = 0; e < PX; ++e) {
        float v[3] = {0.f, 0.f, 0.f};
        if (e < npx) {
          if (in_smem) {
            warp_pixel(wp, S, j, xb + e, from_box, v);
          } else {
            const float3 d = warp_pixel_direct(wp, S, j, xb + e, adjusted);
            v[0] = d.x;
            v[1] = d.y;
            v[2] = d.z;
          }
          if (gray_on) {
            const float gv = gray(v[0], v[1], v[2]);
            v[0] = v[1] = v[2] = gv;
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (post_on) {
              const int q = (int)floorf(mul(clamp01(v[c]), 255.f));
              v[c] = mul((float)(q / post_step * post_step), INV255);
            }
            if (solar_on && v[c] >= nm.threshold) v[c] = sub(1.f, v[c]);
            if (invert_on) v[c] = sub(1.f, v[c]);
            if (cut_mask >> e & 1u) v[c] = mul(v[c], 0.f);
          }
        }
        normalise(v, y + 3 * e);
      }
      store(t, y);
    }
    if (in_smem) __syncthreads();
  }
}

template <typename T>
int launch(const uint8_t* in, const float* table, float* means, void* out,
           int B, int T_, const Geometry& g, int ncol, int mode, int augment,
           const Norm& nm, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (augment) {
    frame_means<<<B * T_, MEAN_THREADS, 0, st>>>(in, table, means, T_, g.ch,
                                                 g.cw, g.S, ncol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (T_ + FPB - 1) / FPB;
  const dim3 grid((g.S + TW - 1) / TW, (g.S + TH - 1) / TH, B * groups);
  // 16-byte stores where a row of output starts on a 16-byte boundary
  const int vec = ((size_t)g.S * 3 * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  fused_frames<T><<<grid, THREADS, 3 * CAP * sizeof(float), st>>>(
      in, table, means, (T*)out, T_, g, ncol, mode, nm, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// in [B, T, ch, cw, 3] uint8, table [B, ncol] float32 (its CUTS active boxes
// among the (ncol - BOXES) / 4 it holds), means [B * T] float32
// (scratch), out [B, T, S, S, 3]: dtype 0 = bfloat16, 1 = float32; all
// contiguous. mode 0 = separable warp, 1 = gather. augment 0: every clip's
// SKIP is set and the contrast means are not computed.
extern "C" int vcd_train_preprocess(const void* in, const void* table,
                                    void* means, void* out, int B, int T,
                                    int ch, int cw, int S, int ncol,
                                    int mode, int augment, float mean0,
                                    float mean1, float mean2, float std0,
                                    float std1, float std2, float threshold,
                                    int dtype, void* stream) {
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  if (ch > S || cw > S || (ch != S && cw != S) || mode < 0 || mode > 1 ||
      ncol < BOXES || (long long)B * ((T + FPB - 1) / FPB) > 65535 ||
      (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Geometry g = {S, ch, cw, (S - ch) / 2, (S - cw) / 2};
  const Norm nm = {{mean0, mean1, mean2}, {std0, std1, std2}, threshold};
  const uint8_t* src = (const uint8_t*)in;
  const float* tab = (const float*)table;
  if (dtype == 0)
    return launch<__nv_bfloat16>(src, tab, (float*)means, out, B, T, g, ncol,
                                 mode, augment, nm, stream);
  if (dtype == 1)
    return launch<float>(src, tab, (float*)means, out, B, T, g, ncol, mode,
                         augment, nm, stream);
  return (int)cudaErrorInvalidValue;
}
