// K4 backward: the gradients of self-attention, two kernels.
//
// Replace the TPU kernels behind vision_collision_detection_tpu/ops/
// flash_attention.py `flash_mha`'s custom_vjp in the JAX library
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
// `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel`. Both
// recompute p = exp(q k^T * scale - lse) from the forward's saved float32
// log-sum-exp, so the [S, S] matrices never reach device memory, with the
// library's roundings: p and ds rounded to the inputs' dtype before their
// products, float32 accumulation.
//   dv = p^T do            ds = p * (do v^T - di) * scale
//   dk = ds^T q            dq = ds k
// di = sum(o * do) per row, float32 [B, H, S], comes from the caller: in the
// library it is jnp outside the Pallas kernels, here the row kernel
// `flash_bwd_di_kernel` below, a helper of this backward.
//
// Two kernels, each block the only writer of its output rows and each sum
// taken in a fixed order: no float atomics, so two runs agree bit for bit.
//
// Bound on the H100: operations. Per (batch, head) dK/dV does 8*S^2*D flops
// (the logits, do v^T, dv, dk) against 12*S*D bytes (q, k, v, do read, dk,
// dv written, bf16) and dQ 6*S^2*D (the logits, do v^T, dq) against
// 10*S*D: 2*S/3 and 3*S/5 flops per byte, 384 and 346 at S = 576. One
// fused kernel would need 10*S^2*D; two kernels recompute the logits and
// do v^T in each, which is the price of sums without atomics.
//
// bf16 with head_dim 64, the scaled ViViT configuration's case, takes the
// wgmma kernels of flash_attention_bwd_wgmma.cu and float32 with head_dim
// 64 the split-product kernels of flash_attention_bwd_f32.cu (their designs
// are described there), each through its own C entry: the Python wrapper's
// `bwd_route` names the entry. This file holds the row kernel for di and
// the kernels of the cases off the main paths, with their C entries:
//
// bf16, head_dim 16 (mma.sync). dK/dV: one block of 4 warps takes 64 keys
// of one (batch, head), each warp keeping its 16 rows of K and V as mma A
// fragments, and walks the queries in tiles of 64 (Q and dO through two
// cp.async buffers, lse and di beside them). It works on the transposed
// tiles, p^T = exp(K Q^T * scale - lse), dp^T = V dO^T, so that p^T and ds^T
// leave the accumulators as A fragments of dv += P^T dO and dk += dS^T Q.
// dQ: one block takes 64 queries (Q and dO as A fragments) and walks the
// keys the same way: p, dp, ds, dq += dS K. Rows past S are zero-filled in
// shared memory and left out of p.
//
// float32 inputs, head_dim 16 (and 64 where the route is forced, as the
// card's yardstick beside the split-product kernels), take plain CUDA-core
// kernels, one thread per key (dK/dV) or query (dQ), every product in
// float32.
#include "flash_bwd_args.cuh"

namespace {

using namespace vcd;

// The two tiles of one pipeline stage: Q and dO, or K and V.
template <int D>
struct Stage {
  bf16 a[FlashTile<D>::ELEMS];
  bf16 b[FlashTile<D>::ELEMS];
};

template <int D>
__global__ void __launch_bounds__(FlashTile<D>::THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                     Strides sd, int S, int H, float scale) {
  using T = FlashTile<D>;
  __shared__ __align__(16) Stage<D> st[2];  // a: Q (first K), b: dO (first V)
  __shared__ float lse_s[2][T::ROWS];
  __shared__ float di_s[2][T::ROWS];

  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * T::ROWS;
  const int warp = threadIdx.x / 32;
  const Lanes L;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;
  const float* lse_b = lse + ((int64_t)b * H + h) * S;
  const float* di_b = di + ((int64_t)b * H + h) * S;

  // the block's keys pass through stage 0 into registers
  load_tile<D>(st[0].a, k + b * sk.b + h * sk.h, sk.s, n0, S);
  load_tile<D>(st[0].b, v + b * sv.b + h * sv.h, sv.s, n0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned kf[T::KS][4], vf[T::KS][4];
  load_a<D>(kf, st[0].a, warp, L);
  load_a<D>(vf, st[0].b, warp, L);
  __syncthreads();

  auto load_queries = [&](int buf, int q0) {
    load_tile<D>(st[buf].a, qb, sq.s, q0, S);
    load_tile<D>(st[buf].b, db, sd.s, q0, S);
    if (threadIdx.x < T::ROWS) {
      const int row = q0 + threadIdx.x;
      lse_s[buf][threadIdx.x] = row < S ? lse_b[row] : 0.f;
      di_s[buf][threadIdx.x] = row < S ? di_b[row] : 0.f;
    }
    cp_async_commit();
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  const int tiles = (S + T::ROWS - 1) / T::ROWS;
  load_queries(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_queries(buf ^ 1, (t + 1) * T::ROWS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // p^T and dp^T: rows are this warp's keys, columns the tile's queries
    float pt[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[nt][e] = dpt[nt][e] = 0.f;
    mma_a_bt<D>(pt, kf, st[buf].a, L);
    mma_a_bt<D>(dpt, vf, st[buf].b, L);
    const int q0 = t * T::ROWS;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * L.tg + (e & 1);
        const float p = q0 + col < S
                            ? __expf(pt[nt][e] * scale - lse_s[buf][col])
                            : 0.f;
        pt[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - di_s[buf][col]) * scale;
      }
    unsigned frag[4][4];
    acc_to_a(pt, frag);
    mma_a_b<D>(dv_acc, frag, st[buf].b, L);
    acc_to_a(dpt, frag);
    mma_a_b<D>(dk_acc, frag, st[buf].a, L);
    __syncthreads();
  }
  store_rows<D>(dk, dk_acc, b, h, n0 + warp * 16, S, H, L);
  store_rows<D>(dv, dv_acc, b, h, n0 + warp * 16, S, H, L);
}

template <int D>
__global__ void __launch_bounds__(FlashTile<D>::THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sd, int S,
                    int H, float scale) {
  using T = FlashTile<D>;
  __shared__ __align__(16) Stage<D> st[2];  // a: K (first Q), b: V (first dO)

  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * T::ROWS;
  const int warp = threadIdx.x / 32;
  const Lanes L;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<D>(st[0].a, q + b * sq.b + h * sq.h, sq.s, m0, S);
  load_tile<D>(st[0].b, dout + b * sd.b + h * sd.h, sd.s, m0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[T::KS][4], df[T::KS][4];
  load_a<D>(qf, st[0].a, warp, L);
  load_a<D>(df, st[0].b, warp, L);
  __syncthreads();

  // lse and di of rows g and g + 8 (0 past S: those rows are not written)
  float lse_r[2], di_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + warp * 16 + L.g + 8 * half;
    const int64_t at = ((int64_t)b * H + h) * S + row;
    lse_r[half] = row < S ? lse[at] : 0.f;
    di_r[half] = row < S ? di[at] : 0.f;
  }

  auto load_keys = [&](int buf, int key0) {
    load_tile<D>(st[buf].a, kb, sk.s, key0, S);
    load_tile<D>(st[buf].b, vb, sv.s, key0, S);
    cp_async_commit();
  };

  float dq_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[nt][e] = 0.f;

  const int tiles = (S + T::ROWS - 1) / T::ROWS;
  load_keys(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_keys(buf ^ 1, (t + 1) * T::ROWS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float p[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = dp[nt][e] = 0.f;
    mma_a_bt<D>(p, qf, st[buf].a, L);
    mma_a_bt<D>(dp, df, st[buf].b, L);
    const int key0 = t * T::ROWS + 2 * L.tg;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = key0 + nt * 8 + (e & 1) < S
                             ? __expf(p[nt][e] * scale - lse_r[e / 2])
                             : 0.f;
        dp[nt][e] = pv * (dp[nt][e] - di_r[e / 2]) * scale;
      }
    unsigned frag[4][4];
    acc_to_a(dp, frag);
    mma_a_b<D>(dq_acc, frag, st[buf].a, L);
    __syncthreads();
  }
  store_rows<D>(dq, dq_acc, b, h, m0 + warp * 16, S, H, L);
}

// float32 dK/dV: one thread per key, its K and V rows in shared memory
// (padded against bank conflicts), queries staged 16 at a time.
template <int D>
__global__ void __launch_bounds__(64)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dk,
                         float* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sd, int S, int H, float scale) {
  constexpr int BQ = 16;
  __shared__ float kown[64][D + 1];
  __shared__ float vown[64][D + 1];
  __shared__ float qs[BQ][D];
  __shared__ float ds_[BQ][D];
  __shared__ float lse_s[BQ];
  __shared__ float di_s[BQ];
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * 64;
  const int me = threadIdx.x, row = n0 + me;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* db = dout + b * sd.b + h * sd.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int64_t stat0 = ((int64_t)b * H + h) * S;
  for (int i = threadIdx.x; i < 64 * D; i += 64) {
    const int r = i / D, d = i % D;
    const bool in = n0 + r < S;
    kown[r][d] = in ? kb[(int64_t)(n0 + r) * sk.s + d] : 0.f;
    vown[r][d] = in ? vb[(int64_t)(n0 + r) * sv.s + d] : 0.f;
  }
  float dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * D; i += 64) {
      const int r = i / D, d = i % D;
      const bool in = q0 + r < S;
      qs[r][d] = in ? qb[(int64_t)(q0 + r) * sq.s + d] : 0.f;
      ds_[r][d] = in ? db[(int64_t)(q0 + r) * sd.s + d] : 0.f;
    }
    if (threadIdx.x < BQ) {
      const bool in = q0 + threadIdx.x < S;
      lse_s[threadIdx.x] = in ? lse[stat0 + q0 + threadIdx.x] : 0.f;
      di_s[threadIdx.x] = in ? di[stat0 + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    const int n = min(BQ, S - q0);
    for (int i = 0; i < n; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += kown[me][d] * qs[i][d];
        dp += vown[me][d] * ds_[i][d];
      }
      const float p = expf(s * scale - lse_s[i]);
      const float dsv = p * (dp - di_s[i]) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv_acc[d] += p * ds_[i][d];
        dk_acc[d] += dsv * qs[i][d];
      }
    }
  }
  if (row >= S) return;
  const int64_t at = (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[at + d] = dk_acc[d];
    dv[at + d] = dv_acc[d];
  }
}

// float32 dQ: one thread per query, keys staged 32 at a time.
template <int D>
__global__ void __launch_bounds__(64)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, float* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sd, int S,
                        int H, float scale) {
  constexpr int BN = 32;
  __shared__ float ks[BN][D];
  __shared__ float vs[BN][D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * 64 + threadIdx.x;
  const bool live = row < S;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float qr[D], dor[D], dq_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[b * sq.b + h * sq.h + (int64_t)row * sq.s + d] : 0.f;
    dor[d] = live ? dout[b * sd.b + h * sd.h + (int64_t)row * sd.s + d] : 0.f;
    dq_acc[d] = 0.f;
  }
  const int64_t at_stat = ((int64_t)b * H + h) * S + row;
  const float lse_r = live ? lse[at_stat] : 0.f;
  const float di_r = live ? di[at_stat] : 0.f;
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
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qr[d] * ks[j][d];
        dp += dor[d] * vs[j][d];
      }
      const float dsv = expf(s * scale - lse_r) * (dp - di_r) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) dq_acc[d] += dsv * ks[j][d];
    }
  }
  if (!live) return;
  float* out = dq + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = dq_acc[d];
}

// dQ/dK/dV of this file: bf16 (head_dim 16) on the mma.sync kernels above,
// float32 on the CUDA-core kernels.
template <int D>
int launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  const dim3 grid((a.S + 63) / 64, a.H, a.B);
  if (a.dtype == 0)
    flash_bwd_dkv_kernel<D><<<grid, FlashTile<D>::THREADS, 0, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, (const float*)a.lse, (const float*)a.di,
        (bf16*)dk, (bf16*)dv, a.sq, a.sk, a.sv, a.sd, a.S, a.H, a.scale);
  else
    flash_bwd_dkv_f32_kernel<D><<<grid, 64, 0, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, (const float*)a.lse, (const float*)a.di,
        (float*)dk, (float*)dv, a.sq, a.sk, a.sv, a.sd, a.S, a.H, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const BwdArgs& a, void* dq) {
  const dim3 grid((a.S + 63) / 64, a.H, a.B);
  if (a.dtype == 0)
    flash_bwd_dq_kernel<D><<<grid, FlashTile<D>::THREADS, 0, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, (const float*)a.lse, (const float*)a.di,
        (bf16*)dq, a.sq, a.sk, a.sv, a.sd, a.S, a.H, a.scale);
  else
    flash_bwd_dq_f32_kernel<D><<<grid, 64, 0, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, (const float*)a.lse, (const float*)a.di,
        (float*)dq, a.sq, a.sk, a.sv, a.sd, a.S, a.H, a.scale);
  return (int)cudaGetLastError();
}

// di[b, h, s] = sum_d o[b, s, h, d] * dout[b, s, h, d] in float32: the row
// term of ds that both kernels above subtract. Rows in o's memory order, 16
// bytes of each operand a thread, D * sizeof(T) / 16 neighbouring lanes a
// row; a lane sums its products in order and the lanes of a row add up by a
// fixed butterfly, so two runs agree bit for bit. Bound: bytes, o and dout
// read once.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ di, Strides so, Strides sd, int S,
                    int H, int D, int64_t rows) {
  constexpr int VEC = 16 / sizeof(T);
  const int lanes = D / VEC;  // 2, 4, 8 or 16
  const int64_t gid = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int64_t row = gid / lanes;
  const int col = (int)(gid % lanes) * VEC;
  const int h = (int)(row % H), s = (int)(row / H % S);
  const int64_t b = row / H / S;
  float sum = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * so.b + s * so.s + h * so.h + col);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * sd.b + s * sd.s + h * sd.h + col);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum += (float)oe[i] * (float)de[i];
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && col == 0) di[(b * H + h) * S + s] = sum;
}

template <typename T>
int launch_di(const void* o, const void* dout, void* di, const int64_t* s,
              int B, int S, int H, int D, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * S * H;
  const int64_t threads = rows * (D * (int)sizeof(T) / 16);
  flash_bwd_di_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)di, {s[0], s[1], s[2]},
      {s[3], s[4], s[5]}, S, H, D, rows);
  return (int)cudaGetLastError();
}

// bf16 with head_dim 64 has no kernel in this file (its route is the wgmma
// entries').
bool valid(const BwdArgs& a, int D) {
  return ((a.dtype == 0 && D == 16) ||
          (a.dtype == 1 && (D == 16 || D == 64))) &&
         a.B >= 1 && a.S >= 1 && a.H >= 1 && a.B <= 65535 && a.H <= 65535;
}

}  // namespace

// q, k, v, dout: [B, S, H, D] of `dtype` (0 = bfloat16, 1 = float32) given
// with element strides `strides[12]` = (batch, sequence, head) of q, k, v,
// dout, the last axis contiguous and, for bf16, every row 16-byte aligned.
// lse, di: float32 [B, H, S]. dk, dv (and dq below): contiguous
// [B, S, H, D] of `dtype`. D is 16 (bf16, float32) or 64 (float32).
extern "C" int vcd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, void* dk, void* dv,
                                 const int64_t* strides, int B, int S, int H,
                                 int D, float scale, int dtype, void* stream) {
  const BwdArgs a = bwd_args(q, k, v, dout, lse, di, strides, B, S, H, scale,
                             dtype, stream);
  if (!valid(a, D)) return (int)cudaErrorInvalidValue;
  return D == 64 ? launch_dkv<64>(a, dk, dv) : launch_dkv<16>(a, dk, dv);
}

extern "C" int vcd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dq,
                                const int64_t* strides, int B, int S, int H,
                                int D, float scale, int dtype, void* stream) {
  const BwdArgs a = bwd_args(q, k, v, dout, lse, di, strides, B, S, H, scale,
                             dtype, stream);
  if (!valid(a, D)) return (int)cudaErrorInvalidValue;
  return D == 64 ? launch_dq<64>(a, dq) : launch_dq<16>(a, dq);
}

// o, dout: [B, S, H, D] of `dtype` given with element strides `strides[6]` =
// (batch, sequence, head) of o, dout, the last axis contiguous and every row
// 16-byte aligned. di: float32 [B, H, S].
extern "C" int vcd_flash_bwd_di(const void* o, const void* dout, void* di,
                                const int64_t* strides, int B, int S, int H,
                                int D, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (D != 16 && D != 64) || B < 1 || S < 1 ||
      H < 1 || (int64_t)B * S * H > (int64_t)1 << 34)
    return (int)cudaErrorInvalidValue;
  return dtype == 0 ? launch_di<bf16>(o, dout, di, strides, B, S, H, D,
                                      (cudaStream_t)stream)
                    : launch_di<float>(o, dout, di, strides, B, S, H, D,
                                       (cudaStream_t)stream);
}
