// K4 forward: self-attention o = softmax(q k^T * scale) v per (batch, head),
// with an online softmax, so the [S, S] logits never reach device memory.
//
// Replaces the TPU kernel that vision_collision_detection_tpu/ops/
// flash_attention.py `flash_mha` reaches: the JAX library's
// `_flash_attention_kernel_single_batch` (jax/experimental/pallas/ops/tpu/
// flash_attention.py). Numerics as there: logits, running max, sum and
// output in float32; p rounded to the inputs' dtype before p @ v; the row
// sum taken from the unrounded p. Where the TPU kernel saves the row
// statistics l and m, this one saves their one-number form, the float32
// log-sum-exp m + log(l), [B, H, S], when the caller wants a gradient.
//
// q, k, v are read in the projections' own [B, S, H, D] layout through
// strides (the TPU wrapper's swapaxes and its padding to a multiple of 128
// are TPU block constraints); keys past S are masked by length, queries
// past S are computed on zero rows and not written, for any S >= 1.
//
// Bound on the H100: 4*S^2*D flops per (batch, head) against 8*S*D bytes
// (q, k, v in, o out, bf16) is S/2 flops per byte: 288 at the scaled
// configuration's S = 576, a hair under the card's ridge of ~295 (bytes
// bind there, operations from S = 592 on).
//
// With head_dim 64, bf16 takes the Hopper kernel of
// flash_attention_fwd_wgmma.cu and float32 that of
// flash_attention_fwd_f32.cu (the Python wrapper's `fwd_route`); this file
// serves head_dim 16, and its float32 kernel at head_dim 64 only where the
// route is forced, as the card's yardstick.
//
// Design (bf16). One block of 4 warps takes 64 queries of one (batch,
// head); each warp keeps its 16 query rows as mma A fragments in registers
// for the whole walk over the keys. K and V arrive in tiles of 64 keys
// through two shared-memory buffers filled with cp.async, the next tile
// loading while the current one is multiplied. Per tile: logits = Q K^T
// (mma.sync m16n8k16, K read with ldmatrix as the [n][k] operand), scale,
// mask, running max and sum per row (a row lives in the four lanes of a
// quad), the accumulators rescaled by exp(m_old - m_new), p rounded to bf16
// straight from the logits' accumulators into A fragments, out += P V (V
// read with ldmatrix.trans as the [k][n] operand). The output is divided
// by the row sum once, at the end.
//
// float32 inputs take a plain CUDA-core kernel, one thread per query row,
// every product in float32: it exists to be right, not to be fast.
#include "flash_common.cuh"

namespace {

using namespace vcd;

template <int D>
__global__ void __launch_bounds__(FlashTile<D>::THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 int S, int H, float scale) {
  using T = FlashTile<D>;
  __shared__ __align__(16) bf16 qs[T::ELEMS];
  __shared__ __align__(16) bf16 ks[2][T::ELEMS];
  __shared__ __align__(16) bf16 vs[2][T::ELEMS];

  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * T::ROWS;
  const int warp = threadIdx.x / 32;
  const Lanes L;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<D>(qs, qb, sq.s, m0, S);
  load_tile<D>(ks[0], kb, sk.s, 0, S);
  load_tile<D>(vs[0], vb, sv.s, 0, S);
  cp_async_commit();

  unsigned qf[T::KS][4];
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // running max and (per-lane partial) sum of rows g and g + 8
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  const int tiles = (S + T::ROWS - 1) / T::ROWS;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile<D>(ks[buf ^ 1], kb, sk.s, (t + 1) * T::ROWS, S);
      load_tile<D>(vs[buf ^ 1], vb, sv.s, (t + 1) * T::ROWS, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) load_a<D>(qf, qs, warp, L);

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    mma_a_bt<D>(s, qf, ks[buf], L);

    // scale; keys past S never win the max and weigh 0
    const int key0 = t * T::ROWS + 2 * L.tg;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = key0 + nt * 8 + (e & 1) < S ? s[nt][e] * scale
                                                 : -CUDART_INF_F;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile holds a key below S, so m_new is finite
      const float m_new = fmaxf(m_run[half], mx);
      const float alpha = __expf(m_run[half] - m_new);
      m_run[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[nt][e] = __expf(s[nt][e] - m_new);
          sum += s[nt][e];
        }
      l_run[half] = l_run[half] * alpha + sum;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][2 * half] *= alpha;
        acc[nt][2 * half + 1] *= alpha;
      }
    }
    unsigned pf[4][4];
    acc_to_a(s, pf);
    mma_a_b<D>(acc, pf, vs[buf], L);
    __syncthreads();  // the next iteration's loads overwrite this buffer's twin
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][2 * half] *= inv;
      acc[nt][2 * half + 1] *= inv;
    }
    const int row = m0 + warp * 16 + L.g + 8 * half;
    if (lse != nullptr && L.tg == 0 && row < S)
      lse[((int64_t)b * H + h) * S + row] = m_run[half] + logf(l);
  }
  store_rows<D>(o, acc, b, h, m0 + warp * 16, S, H, L);
}

// float32: one thread per query row, keys staged 32 at a time.
template <int D>
__global__ void __launch_bounds__(64)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, int S, int H, float scale) {
  constexpr int BN = 32;
  __shared__ float ks[BN][D];
  __shared__ float vs[BN][D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * 64 + threadIdx.x;
  const bool live = row < S;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[b * sq.b + h * sq.h + (int64_t)row * sq.s + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  for (int key0 = 0; key0 < S; key0 += BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < BN * D; i += 64) {
      const int r = i / D, d = i % D;
      const bool in = key0 + r < S;
      ks[r][d] = in ? kb[(int64_t)(key0 + r) * sk.s + d] : 0.f;
      vs[r][d] = in ? vb[(int64_t)(key0 + r) * sv.s + d] : 0.f;
    }
    __syncthreads();
    const int n = min(BN, S - key0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s += qr[d] * ks[j][d];
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new), p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = acc[d] * alpha + p * vs[j][d];
      m = m_new;
    }
  }
  if (!live) return;
  float* orow = o + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
  if (lse != nullptr) lse[((int64_t)b * H + h) * S + row] = m + logf(l);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           Strides sq, Strides sk, Strides sv, int B, int S, int H,
           float scale, int dtype, cudaStream_t stream) {
  const dim3 grid((S + 63) / 64, H, B);
  if (dtype == 0)
    flash_fwd_kernel<D><<<grid, FlashTile<D>::THREADS, 0, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
        sq, sk, sv, S, H, scale);
  else
    flash_fwd_f32_kernel<D><<<grid, 64, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, sq, sk, sv, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] of `dtype` (0 = bfloat16, 1 = float32) given with
// element strides `strides[9]` = (batch, sequence, head) of q, k, v, the last
// axis contiguous and, for bf16, every row 16-byte aligned. o: contiguous
// [B, S, H, D] of `dtype`; lse: float32 [B, H, S] or null. D is 16 or 64; B
// and H at most 65535.
extern "C" int vcd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const int64_t* strides,
                             int B, int S, int H, int D, float scale,
                             int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || S < 1 || H < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t* s = strides;
  const Strides sq{s[0], s[1], s[2]}, sk{s[3], s[4], s[5]},
      sv{s[6], s[7], s[8]};
  if (D == 64)
    return launch<64>(q, k, v, o, lse, sq, sk, sv, B, S, H, scale, dtype,
                      (cudaStream_t)stream);
  if (D == 16)
    return launch<16>(q, k, v, o, lse, sq, sk, sv, B, S, H, scale, dtype,
                      (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
