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
// to speak of. x * a + b is computed with __fmul_rn / __fadd_rn so that nvcc
// does not contract it into an FMA: the result is then bit-equal to the
// plain PyTorch version, which rounds after the product too.
//
// Design: a row kernel. A warp writes one output row (a block of 8 warps
// takes 8 rows), so all index arithmetic is per row and the channel of each
// element follows from its place in the row.
// - A bar row is stores of the repeating 3-channel pattern: each 16-byte
//   vector is one of three patterns, by the phase of its first element.
// - A content row first copies its cw*3 input bytes into the warp's buffer
//   in shared memory, 16 bytes a load where the row starts on a 16-byte
//   boundary (every main-path shape: 672 and 1008 bytes a row), 4 or 1
//   where it does not. Then the warp writes the row in 16-byte vectors
//   across the left bar, the content and the right bar; a vector wholly in
//   a bar is a pattern store.
// - A row that does not start on a 16-byte boundary (S*3*sizeof(T) not a
//   multiple of 16) writes its first and last few elements one at a time.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // warps, so rows in flight, of a block

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

// 32-bit words of output: two bf16 or one float32 a word, each value
// rounded once from float32 as from_float does
template <typename T>
struct Word;

template <>
struct Word<__nv_bfloat16> {
  static constexpr int PER = 2;
  static __device__ __forceinline__ uint32_t pack(const float* y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[0], y[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

template <>
struct Word<float> {
  static constexpr int PER = 1;
  static __device__ __forceinline__ uint32_t pack(const float* y) {
    return __float_as_uint(y[0]);
  }
};

struct Coef {
  float a[3], b[3];
};

__device__ __forceinline__ float pick3(const float (&v)[3], int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

// the warp's copy of a content row, `len` bytes, into `buf`
__device__ __forceinline__ void stage_row(const uint8_t* src, uint8_t* buf,
                                          int len, int lane) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if ((addr & 15) == 0) {
    const int n16 = len / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(buf);
    for (int i = lane; i < n16; i += 32) d[i] = __ldg(s + i);
    done = n16 * 16;
  } else if ((addr & 3) == 0) {
    const int n4 = len / 4;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(buf);
    for (int i = lane; i < n4; i += 32) d[i] = __ldg(s + i);
    done = n4 * 4;
  }
  for (int i = done + lane; i < len; i += 32) buf[i] = __ldg(src + i);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dequant_pad_rows(const uint8_t* __restrict__ in, T* __restrict__ out,
                 int rows, int ch, int cw, int S, int pad_h, int pad_w,
                 int buf_bytes, Coef co) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int W = Word<T>::PER;  // elements a 32-bit word
  extern __shared__ __align__(16) uint8_t sbuf[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* buf = sbuf + warp * buf_bytes;
  const int E = S * 3;          // elements of an output row
  const int L = cw * 3;         // content elements of a content row
  const int p0 = pad_w * 3;     // the first of them
  // the bar pattern of a vector whose first element has channel ph
  uint4 bar[3];
#pragma unroll
  for (int ph = 0; ph < 3; ++ph) {
    float y[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = co.b[(ph + k) % 3];
    bar[ph] = make_uint4(Word<T>::pack(y), Word<T>::pack(y + W),
                         Word<T>::pack(y + 2 * W), Word<T>::pack(y + 3 * W));
  }
  // one element of the row: content if `content` and e is in [p0, p0 + L)
  auto element = [=](int e, bool content) -> T {
    const int c = e % 3;
    float y = pick3(co.b, c);
    if (content && e >= p0 && e < p0 + L)
      y = __fadd_rn(__fmul_rn((float)buf[e - p0], pick3(co.a, c)), y);
    return from_float<T>(y);
  };

  // a warp a row, so the whole warp leaves together
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  const int n = row / S, i = row - n * S;
  const int cr = i - pad_h;
  const bool content = cr >= 0 && cr < ch;
  if (content) {
    stage_row(in + ((size_t)n * ch + cr) * L, buf, L, lane);
    __syncwarp();
  }
  T* orow = out + (size_t)row * E;
  // elements before the row's first 16-byte boundary, and vectors after
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(orow) & 15)) & 15) /
                   sizeof(T));
  if (head > E) head = E;
  const int nvec = (E - head) / VEC;
  const int tail = head + nvec * VEC;
  for (int v = lane; v < nvec; v += 32) {
    const int e0 = head + v * VEC;
    int c = e0 % 3;
    uint4 val;
    if (!content || e0 + VEC <= p0 || e0 >= p0 + L) {
      val = c == 0 ? bar[0] : (c == 1 ? bar[1] : bar[2]);
    } else {
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int e = e0 + k;
        y[k] = pick3(co.b, c);
        if (e >= p0 && e < p0 + L)
          y[k] = __fadd_rn(__fmul_rn((float)buf[e - p0], pick3(co.a, c)),
                           y[k]);
        c = c == 2 ? 0 : c + 1;
      }
      val = make_uint4(Word<T>::pack(y), Word<T>::pack(y + W),
                       Word<T>::pack(y + 2 * W), Word<T>::pack(y + 3 * W));
    }
    *reinterpret_cast<uint4*>(orow + e0) = val;
  }
  if (lane < head) orow[lane] = element(lane, content);
  if (lane < E - tail) orow[tail + lane] = element(tail + lane, content);
}

template <typename T>
int launch(const void* in, void* out, int n, int ch, int cw, int S,
           const Coef& co, void* stream) {
  const long long rows = (long long)n * S;
  if (rows == 0) return (int)cudaGetLastError();
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int buf_bytes = (cw * 3 + 15) / 16 * 16;
  const size_t smem = (size_t)WARPS * buf_bytes;
  auto kernel = dequant_pad_rows<T>;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  // a warp a row, 8 rows a block: blocks are scheduled as others finish,
  // which evens out the tail better than a grid-stride of one wave
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (T*)out, (int)rows, ch, cw, S, (S - ch) / 2,
      (S - cw) / 2, buf_bytes, co);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of out: 0 = bfloat16, 1 = float32. in [n, ch, cw, 3] uint8 and out
// [n, S, S, 3] contiguous; out aligned to its element size.
extern "C" int vcd_dequant_pad(const void* in, void* out, int n, int ch,
                               int cw, int S, float a0, float a1, float a2,
                               float b0, float b1, float b2, int dtype,
                               void* stream) {
  const Coef co = {{a0, a1, a2}, {b0, b1, b2}};
  if (dtype == 0)
    return launch<__nv_bfloat16>(in, out, n, ch, cw, S, co, stream);
  if (dtype == 1) return launch<float>(in, out, n, ch, cw, S, co, stream);
  return (int)cudaErrorInvalidValue;
}
