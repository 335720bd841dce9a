// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in,
// f32 accumulate.
//
// Replaces: ray_tpu/ops/attention.py, _flash_bwd_dkdv_kernel and
// _flash_bwd_dq_kernel (both launched by _flash_bwd_pallas). Same
// function: P = exp(S * scale - lse) recomputed from the forward's row
// log-sum-exp, delta = rowsum(dO * O) (computed by the wrapper, as the JAX
// launcher computes it outside its kernels), then
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K.
// P and dS are rounded to bf16 before their products, as the JAX kernels
// round them (`pt.astype(do.dtype)`, `dst.astype(q.dtype)`). Entries that
// are masked (k > q under causal, or a row past the sequence) are set to 0
// AFTER the exp, which keeps 0 * inf NaNs out; q/dO rows past sq and K/V
// rows past sk are never read (zero-filled in shared memory). The lse is
// read as (b, h, sq) f32, as the port's forward writes it; the TPU's
// (b, h, 8, sq) sublane layout and its transposed dQ^T output are Mosaic
// tiling choices and are not carried over: dQ is written directly through
// its (b, h, sq, d) strides.
//
// Bound on this card: operations. At the training path's shape
// (b 2, 16 heads, s 2048, head_dim 128, causal) each of the five products
// is 2 * d * (pairs under the diagonal) = 17.2 GFLOP; dK/dV does four
// (S, dV, dP, dK) and dQ three (S, dP, dQ), about 70 us and 52 us at the
// bf16 peak, against about 34 MB of q/k/v/dO/lse/delta traffic each
// (about 10 us).
//
// Design (simple first, as the forward; wgmma, TMA and warp
// specialisation come later):
//  * dK/dV: grid (ceil(sk / 64), b * kv_heads), one 128-thread block per
//    (k tile, batch, KV head). The block loops over the q heads of its
//    GQA group and, causally, over the q tiles from the diagonal down. All
//    group heads accumulate into the same f32 dK/dV tiles, which fuses the
//    TPU launcher's group sum (`dk.reshape(b, kvh, group, sk, d).sum(2)`)
//    with no f32 (b, h, sk, d) intermediate and no atomics.
//  * dQ: grid (ceil(sq / 64), b * h), one block per (q tile, head); the
//    loop over K/V tiles stops at the diagonal. q tiles run in reverse so
//    the longest causal tiles start first.
//  * each warp owns 16 rows of the block's tile. The products run on the
//    tensor cores through nvcuda::wmma bf16 16x16x16 with f32
//    accumulators; transposed operands (Q^T, dO^T, V^T) are the same
//    shared tiles read through col_major fragments, never copied.
//  * the f32 accumulators (dK and dV, or dQ) live in shared memory, as
//    the forward's O: wmma's register layout is opaque.
// Shared memory at head_dim 128: dK/dV holds K, V, Q, dO tiles
// (4 x 17 KB), S/P and dP in f32 (2 x 17 KB), P/dS in bf16 (9 KB) and the
// dK, dV accumulators (2 x 33 KB): about 177 KB, one block per SM. dQ
// holds the same four tiles, S/P, dP, P/dS and one accumulator: about
// 144 KB, one block per SM.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kB = 64;         // rows of every tile (q and k alike)
constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = kWarps * 32;

template <int D>
struct Layout {
  static constexpr int kLdT = D + 8;    // bf16 pitch of Q/K/V/dO tiles
  static constexpr int kLdS = kB + 4;   // f32 pitch of S/P and dP
  static constexpr int kLdP = kB + 8;   // bf16 pitch of P/dS
  static constexpr int kLdA = D + 4;    // f32 pitch of an accumulator
  static constexpr int kTile = kB * kLdT * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kDO = kV + kTile;
  static constexpr int kS = kDO + kTile;
  static constexpr int kDP = kS + kB * kLdS * 4;
  static constexpr int kP = kDP + kB * kLdS * 4;
  static constexpr int kStat = kP + kB * kLdP * 2;   // lse, delta (dK/dV)
  static constexpr int kAcc = kStat + 2 * kB * 4;
  static constexpr int kAccBytes = kB * kLdA * 4;
  static constexpr int kBytesDkdv = kAcc + 2 * kAccBytes;
  static constexpr int kBytesDq = kAcc + kAccBytes;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;     // (b, h, sq) contiguous
  const float* delta;   // (b, h, sq) contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, seq
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int h, kvh, group, sq, sk;
  float scale;
  int causal;
};

// Copy rows [r0, r0 + 64) of a (seq, D) slice into a padded tile; rows at
// or past `limit` are zero-filled, never read.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0,
                                          int limit) {
  constexpr int kVecsPerRow = D / 8;
  for (int i = threadIdx.x; i < kB * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::kLdT + c) = val;
  }
}

// C[16 x 64] = A[16 x D] B^T for this warp, with A the warp's 16 rows of
// a tile and B a 64-row tile read as col_major (B^T without a copy).
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float* c, const bf16* a,
                                                  const bf16* b) {
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < kB / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, a + kk * 16, L::kLdT);
      wmma::load_matrix_sync(bf, b + n * 16 * L::kLdT + kk * 16, L::kLdT);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(c + n * 16, acc, L::kLdS, wmma::mem_row_major);
  }
}

// acc[16 x D] += P[16 x 64] T[64 x D] for this warp: P its 16 rows of the
// bf16 P/dS tile, T a row-major 64-row tile.
template <int D>
__device__ __forceinline__ void accumulate(float* acc, const bf16* p,
                                           const bf16* t) {
  using L = Layout<D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      pf[kB / 16];
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk)
    wmma::load_matrix_sync(pf[kk], p + kk * 16, L::kLdP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> af;
    wmma::load_matrix_sync(af, acc + n * 16, L::kLdA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> tf;
      wmma::load_matrix_sync(tf, t + kk * 16 * L::kLdT + n * 16, L::kLdT);
      wmma::mma_sync(af, pf[kk], tf, af);
    }
    wmma::store_matrix_sync(acc + n * 16, af, L::kLdA, wmma::mem_row_major);
  }
}

// Write one lane's half row of an f32 accumulator as bf16 (16-byte stores).
template <int D>
__device__ __forceinline__ void store_half_row(bf16* dst, const float* src) {
#pragma unroll
  for (int j = 0; j < D / 2; j += 8) {
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(src[j + u]);
    *reinterpret_cast<uint4*>(dst + j) = packed;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::kDO);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::kP);
  float* sLse = reinterpret_cast<float*>(smem + L::kStat);
  float* sDelta = sLse + kB;
  float* sDK = reinterpret_cast<float*>(smem + L::kAcc);
  float* sDV = reinterpret_cast<float*>(smem + L::kAcc + L::kAccBytes);

  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / p.kvh;
  const int hk = blockIdx.y % p.kvh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);  // the k row this lane pair owns
  const int half = lane & 1;                // which half of its columns
  const int ki = k0 + row;

  load_tile<D>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.sk);
  load_tile<D>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.sk);
  for (int i = threadIdx.x; i < 2 * kB * L::kLdA; i += kThreads) sDK[i] = 0.f;

  // Causal: q tile i runs iff i * 64 + 63 >= k0, the TPU kernel's test.
  const int nq = (p.sq + kB - 1) / kB;
  const int i0 = p.causal ? k0 / kB : 0;
  const bf16* wK = sK + warp * 16 * L::kLdT;
  const bf16* wV = sV + warp * 16 * L::kLdT;
  float* wS = sS + warp * 16 * L::kLdS;
  float* wDP = sDP + warp * 16 * L::kLdS;
  bf16* wP = sP + warp * 16 * L::kLdP;

  for (int g = 0; g < p.group; ++g) {
    const int hq = hk * p.group + g;
    const bf16* qb = p.q + b * p.q_sb + hq * p.q_sh;
    const bf16* dob = p.dout + b * p.do_sb + hq * p.do_sh;
    const long long stat0 = (static_cast<long long>(b) * p.h + hq) * p.sq;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * kB;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<D>(sQ, qb, p.q_ss, q0, p.sq);
      load_tile<D>(sDO, dob, p.do_ss, q0, p.sq);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        const bool in = q0 + r < p.sq;
        sLse[r] = in ? p.lse[stat0 + q0 + r] : 0.f;
        sDelta[r] = in ? p.delta[stat0 + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 k rows.
      rows_times_tile_t<D>(wS, wK, sQ);
      rows_times_tile_t<D>(wDP, wV, sDO);
      __syncwarp();

      // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - delta) * scale,
      // both 0 where masked; P^T in bf16 for the dV product first.
      float ds[32];
      {
        const float* srow = sS + row * L::kLdS + half * 32;
        const float* dprow = sDP + row * L::kLdS + half * 32;
        bf16* prow = sP + row * L::kLdP + half * 32;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int c = half * 32 + j;
          const int qi = q0 + c;
          const bool valid = qi < p.sq && !(p.causal && ki > qi);
          const float pv = valid ? __expf(srow[j] * p.scale - sLse[c]) : 0.f;
          ds[j] = valid ? pv * (dprow[j] - sDelta[c]) * p.scale : 0.f;
          prow[j] = __float2bfloat16(pv);
        }
      }
      __syncwarp();
      accumulate<D>(sDV + warp * 16 * L::kLdA, wP, sDO);   // dV += P^T dO
      __syncwarp();
      {
        bf16* prow = sP + row * L::kLdP + half * 32;
#pragma unroll
        for (int j = 0; j < 32; ++j) prow[j] = __float2bfloat16(ds[j]);
      }
      __syncwarp();
      accumulate<D>(sDK + warp * 16 * L::kLdA, wP, sQ);    // dK += dS^T Q
    }
  }
  __syncthreads();  // the zero-fill reaches every row, even with no q tile

  if (ki < p.sk) {
    store_half_row<D>(p.dk + b * p.dk_sb + hk * p.dk_sh + ki * p.dk_ss +
                          half * (D / 2),
                      sDK + row * L::kLdA + half * (D / 2));
    store_half_row<D>(p.dv + b * p.dv_sb + hk * p.dv_sh + ki * p.dv_ss +
                          half * (D / 2),
                      sDV + row * L::kLdA + half * (D / 2));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::kDO);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::kP);
  float* sDQ = reinterpret_cast<float*>(smem + L::kAcc);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hq = bh % p.h;
  const int hk = hq / p.group;
  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);  // the q row this lane pair owns
  const int half = lane & 1;
  const int qi = q0 + row;

  load_tile<D>(sQ, p.q + b * p.q_sb + hq * p.q_sh, p.q_ss, q0, p.sq);
  load_tile<D>(sDO, p.dout + b * p.do_sb + hq * p.do_sh, p.do_ss, q0, p.sq);
  for (int i = threadIdx.x; i < kB * L::kLdA; i += kThreads) sDQ[i] = 0.f;
  const long long stat = static_cast<long long>(bh) * p.sq + qi;
  const float lse = qi < p.sq ? p.lse[stat] : 0.f;
  const float delta = qi < p.sq ? p.delta[stat] : 0.f;

  // Causal: tile t runs iff t * 64 <= q0 + 63, as the TPU kernel's test.
  const int k_end = p.causal ? min(p.sk, q0 + kB) : p.sk;
  const int n_tiles = (k_end + kB - 1) / kB;
  const bf16* wQ = sQ + warp * 16 * L::kLdT;
  const bf16* wDO = sDO + warp * 16 * L::kLdT;
  float* wS = sS + warp * 16 * L::kLdS;
  float* wDP = sDP + warp * 16 * L::kLdS;
  bf16* wP = sP + warp * 16 * L::kLdP;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, p.k_ss, k0, p.sk);
    load_tile<D>(sV, vb, p.v_ss, k0, p.sk);
    __syncthreads();

    rows_times_tile_t<D>(wS, wQ, sK);     // S = Q K^T
    rows_times_tile_t<D>(wDP, wDO, sV);   // dP = dO V^T
    __syncwarp();
    {
      const float* srow = sS + row * L::kLdS + half * 32;
      const float* dprow = sDP + row * L::kLdS + half * 32;
      bf16* prow = sP + row * L::kLdP + half * 32;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kc = k0 + half * 32 + j;
        const bool valid = kc < p.sk && !(p.causal && kc > qi);
        const float pv = valid ? __expf(srow[j] * p.scale - lse) : 0.f;
        const float ds = valid ? pv * (dprow[j] - delta) * p.scale : 0.f;
        prow[j] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    accumulate<D>(sDQ + warp * 16 * L::kLdA, wP, sK);   // dQ += dS K
  }
  __syncthreads();

  if (qi < p.sq)
    store_half_row<D>(p.dq + b * p.dq_sb + hq * p.dq_sh + qi * p.dq_ss +
                          half * (D / 2),
                      sDQ + row * L::kLdA + half * (D / 2));
}

template <int D>
cudaError_t launch_dkdv(const Params& p, int b, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<D>::kBytesDkdv);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sk + kB - 1) / kB, b * p.kvh);
  flash_bwd_dkdv_kernel<D>
      <<<grid, kThreads, Layout<D>::kBytesDkdv, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int b, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<D>::kBytesDq);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + kB - 1) / kB, b * p.h);
  flash_bwd_dq_kernel<D><<<grid, kThreads, Layout<D>::kBytesDq, stream>>>(p);
  return cudaGetLastError();
}

int make_params(Params* p, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, void* dk, void* dv, int b, int h, int kvh, int sq,
                int sk, const long long* st, float scale, int causal) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh || sq < 0 || sk < 0)
    return cudaErrorInvalidValue;
  *p = Params{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<bf16*>(dq),
              static_cast<bf16*>(dk), static_cast<bf16*>(dv),
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
              st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16],
              st[17], st[18], st[19], st[20],
              h, kvh, h / kvh, sq, sk, scale, causal};
  return 0;
}

}  // namespace

// Strides are in elements, 21 of them: (batch, head, seq) of q, k, v, dO,
// dQ, dK, dV in that order; head_dim stride 1. The wrapper guarantees bf16,
// 16-byte alignment, kvh | h and grid limits. dK/dV are (b, kvh, sk, d).
extern "C" int rtt_flash_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int kvh, int sq, int sk, int d, const long long* strides, float scale,
    int causal, void* stream) {
  Params p;
  const int bad = make_params(&p, q, k, v, dout, lse, delta, nullptr, dk, dv,
                              b, h, kvh, sq, sk, strides, scale, causal);
  if (bad) return bad;
  if (sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return static_cast<int>(launch_dkdv<128>(p, b, s));
  if (d == 64) return static_cast<int>(launch_dkdv<64>(p, b, s));
  return cudaErrorInvalidValue;
}

extern "C" int rtt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int h, int kvh,
    int sq, int sk, int d, const long long* strides, float scale, int causal,
    void* stream) {
  Params p;
  const int bad = make_params(&p, q, k, v, dout, lse, delta, dq, nullptr,
                              nullptr, b, h, kvh, sq, sk, strides, scale,
                              causal);
  if (bad) return bad;
  if (sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return static_cast<int>(launch_dq<128>(p, b, s));
  if (d == 64) return static_cast<int>(launch_dq<64>(p, b, s));
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
