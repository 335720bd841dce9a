// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in,
// f32 accumulate, every product on wgmma with its accumulator in
// registers.
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
// are masked (k > q under causal, or past the sequence) are set to 0
// AFTER the exp, which keeps 0 * inf NaNs out; q/dO rows past sq and K/V
// rows past sk are never read (zero-filled in shared memory). The lse is
// read as (b, h, sq) f32, as the port's forward writes it; the TPU's
// (b, h, 8, sq) sublane layout and its transposed dQ^T output are Mosaic
// tiling choices and are not carried over: dQ, dK and dV are written
// directly through their (b, heads, s, d) strides.
//
// Bound on this card: operations. At the training path's shape
// (b 2, 16 heads, s 2048, head_dim 128, causal) each of the five products
// is 2 * d * (pairs under the diagonal) = 17.2 GFLOP; dK/dV does four
// (S, dV, dP, dK) and dQ three (S, dP, dQ): 0.0695 ms and 0.0521 ms at
// the bf16 peak (989 TF/s), against about 34 MB of q/k/v/dO/lse/delta
// traffic each (about 10 us at 3.35 TB/s).
//
// Design (helpers in hopper.cuh):
//  * one warpgroup (128 threads) a block, which owns a 64-row tile: K/V
//    rows in dK/dV, q rows in dQ. Its accumulators stay in registers for
//    the whole loop: dK and dV (2 x 64 f32 a thread at head_dim 128), or
//    dQ (64), plus the two 64 x 64 score tiles (2 x 32).
//  * dK/dV block, per q tile: S^T = K Q^T and dP^T = V dO^T are SS wgmma
//    (both operands K-major in shared memory, as loaded). P^T and dS^T
//    are computed on the accumulator fragments and packed in place into
//    bf16 A fragments; dV += P^T dO and dK += dS^T Q are RS wgmma (A
//    from registers) with dO and Q read MN-major through the trans-b
//    flag, so nothing is transposed by a copy. dV's product runs while
//    dS^T is computed.
//  * dQ block, per K/V tile: S = Q K^T and dP = dO V^T are SS, dQ += dS K
//    is RS with K read MN-major.
//  * no f32 tile and no P/dS tile goes to shared memory. Tiles are
//    loaded with cp.async into 128-byte-swizzled shared memory, two
//    stages deep: the next q (or K/V) tile streams in while the current
//    one is computed. Rows past the sequence are zero-filled by the copy.
//  * shared memory: 6 tiles of 64 x head_dim bf16 (the block's two
//    resident tiles and two stages of two streamed ones) and the
//    streamed lse/delta: 98 KB at head_dim 128, so two blocks fit on an
//    SM (`__launch_bounds__(128, 2)`), each hiding the other's softmax
//    and load latency.
//  * work order: dK/dV blocks run the k tile on grid y and (batch, kv
//    head) on x, so under causal the longest k tiles (those near 0) are
//    scheduled first; dQ walks q tiles in reverse for the same reason.
//  * GQA: a dK/dV block loops over the q heads of its group and all of
//    them accumulate into the same registers, which fuses the TPU
//    launcher's group sum with no f32 (b, h, sk, d) intermediate.
//  * measured alternatives, both kept out (H100, each against this
//    design's 0.357-0.358 ms a pair in other calls): blocks of two
//    warpgroups over 128-row resident tiles (half the streamed loads,
//    one block an SM) took 0.371 ms; Q and dO held as register A
//    operands in dQ (240 registers) took 0.351 ms, 2% less, not worth
//    a second RS form. Loads by TMA from a producer warp, with an
//    mbarrier ring, are the next step; the cp.async ring is the first.
// Why two kernels and not FlashAttention-2/3's one: the fused kernel
// computes dQ with f32 atomics into a (b, h, s, d) f32 buffer (33.5 MB
// at the training shape) plus a convert pass. It would save the S and dP
// products the dQ kernel recomputes, lowering the bound from 0.122 to
// 0.087 ms, but atomics make dQ differ from run to run and the GQA sum
// could no longer stay fused. Two kernels are deterministic bit for bit.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;
using namespace hopper;

namespace {

constexpr int kB = 64;          // rows of every tile (wgmma M, q and k)
constexpr int kThreads = 128;   // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kTile = kB * D * 2;          // a swizzled bf16 tile
  static constexpr int kFixed = 0;                  // two resident tiles
  static constexpr int kStage = 2 * kTile;          // two per stage, x2
  static constexpr int kStats = kStage + 4 * kTile; // lse, delta x2 stages
  static constexpr int kBytes = kStats + 4 * kB * 4 + 1024;  // + alignment
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

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The dynamic shared memory, rounded up to a 1024-byte swizzle atom.
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// Write a thread's part of a 64 x D f32 accumulator as bf16: rows r and
// r + 8 of `dst`, columns col + 8j and the one after; rows at or past
// `limit` are skipped.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, long long stride,
                                          const float (&acc)[D / 2], int r,
                                          int limit, int col) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= limit) continue;
    bf16* out = dst + row * stride + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_base(smem);
  const float* stats =
      reinterpret_cast<const float*>(smem + (base - smem_u32(smem)) +
                                     L::kStats);
  const uint32_t sK = base + L::kFixed, sV = sK + L::kTile;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.kvh;
  const int hk = blockIdx.x % p.kvh;
  const int k0 = blockIdx.y * kB;
  const int warp = tid >> 5, lane = tid & 31;
  const int krow = k0 + warp * 16 + (lane >> 2);  // and krow + 8
  const int col = 2 * (lane & 3);   // first column of each 8-column chunk

  // Causal: q tile i runs iff i * 64 + 63 >= k0, the TPU kernel's test.
  const int nq = (p.sq + kB - 1) / kB;
  const int i0 = p.causal ? k0 / kB : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_iters = p.group * per_head;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // Load the q tile of iteration `it` (its Q, dO, lse, delta) into stage
  // it % 2.
  auto load_stage = [&](int it) {
    const int hq = hk * p.group + it / per_head;
    const int q0 = (i0 + it % per_head) * kB;
    const uint32_t stage = base + L::kStage + (it & 1) * 2 * L::kTile;
    load_tile<kB, D>(stage, p.q + b * p.q_sb + hq * p.q_sh, p.q_ss, q0,
                     p.sq, tid, kThreads);
    load_tile<kB, D>(stage + L::kTile, p.dout + b * p.do_sb + hq * p.do_sh,
                     p.do_ss, q0, p.sq, tid, kThreads);
    const long long stat0 = (static_cast<long long>(b) * p.h + hq) * p.sq;
    const int r = tid % kB;
    const bool in = q0 + r < p.sq;
    const float* src = (tid < kB ? p.lse : p.delta) + stat0;
    cp_async_4(base + L::kStats + ((it & 1) * 2 + tid / kB) * kB * 4 + 4 * r,
               in ? src + q0 + r : src, in ? 4 : 0);
  };

  if (n_iters > 0) {
    load_tile<kB, D>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.sk,
                     tid, kThreads);
    load_tile<kB, D>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.sk,
                     tid, kThreads);
    load_stage(0);
    cp_async_commit();
  }
  const float sl = p.scale * kLog2e;

  for (int it = 0; it < n_iters; ++it) {
    if (it + 1 < n_iters) {
      load_stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const int q0 = (i0 + it % per_head) * kB;
    const uint32_t sQ = base + L::kStage + (it & 1) * 2 * L::kTile;
    const uint32_t sDO = sQ + L::kTile;
    const float* lse = stats + (it & 1) * 2 * kB;
    const float* delta = lse + kB;

    // S^T = K Q^T and dP^T = V dO^T: 64 k rows x 64 q columns each.
    float s[kB / 2], dp[kB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kB>(s, desc_k_major(sK, kB, 16 * kk),
                   desc_k_major(sQ, kB, 16 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kB>(dp, desc_k_major(sV, kB, 16 * kk),
                   desc_k_major(sDO, kB, 16 * kk), kk);
    wgmma_commit();

    // Only tiles on the diagonal or the ragged edge need the mask.
    const bool edge = q0 + kB > p.sq || (p.causal && k0 + kB - 1 > q0);
    wgmma_wait<1>();
    fence_regs(s);
    // P^T = exp(S^T * scale - lse), 0 where masked.
#pragma unroll
    for (int j = 0; j < kB / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + col);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * j + r;
        s[i] = exp2_approx(s[i] * sl - (r & 1 ? l2.y : l2.x) * kLog2e);
        if (edge) {
          const int qi = q0 + 8 * j + col + (r & 1);
          const int ki = krow + 8 * (r >> 1);
          if (qi >= p.sq || (p.causal && ki > qi)) s[i] = 0.f;
        }
      }
    }
    uint32_t pa[kB / 16][4];
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) acc_to_a(pa[kk], s, kk);
    // dV += P^T dO, running while dS^T is computed.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk)
      wgmma_rs_tb<D>(dv, pa[kk], desc_mn_major(sDO, kB, 16 * kk), 1);
    wgmma_commit();

    wgmma_wait<1>();
    fence_regs(dp);
    // dS^T = P^T (dP^T - delta) * scale; P^T is already 0 where masked.
#pragma unroll
    for (int j = 0; j < kB / 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(delta + 8 * j + col);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * j + r;
        dp[i] = s[i] * (dp[i] - (r & 1 ? d2.y : d2.x)) * p.scale;
      }
    }
    uint32_t da[kB / 16][4];
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) acc_to_a(da[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk)
      wgmma_rs_tb<D>(dk, da[kk], desc_mn_major(sQ, kB, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    __syncthreads();  // every warp is done with this stage's tiles
  }

  store_acc<D>(p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, dk, krow, p.sk,
               col);
  store_acc<D>(p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, dv, krow, p.sk,
               col);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_base(smem);
  const uint32_t sQ = base + L::kFixed, sDO = sQ + L::kTile;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.h;
  const int hq = blockIdx.x % p.h;
  const int hk = hq / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;
  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int warp = tid >> 5, lane = tid & 31;
  const int qrow = q0 + warp * 16 + (lane >> 2);  // and qrow + 8
  const int col = 2 * (lane & 3);

  // This thread's two rows' lse (times log2 e) and delta; 0 past sq.
  float lse[2], delta[2];
  const long long stat = static_cast<long long>(blockIdx.x) * p.sq + qrow;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow + 8 * r < p.sq;
    lse[r] = in ? p.lse[stat + 8 * r] * kLog2e : 0.f;
    delta[r] = in ? p.delta[stat + 8 * r] : 0.f;
  }

  // Causal: tile t runs iff t * 64 <= q0 + 63, as the TPU kernel's test.
  const int k_end = p.causal ? min(p.sk, q0 + kB) : p.sk;
  const int n_tiles = (k_end + kB - 1) / kB;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  auto load_stage = [&](int t) {   // K/V tile t into stage t % 2
    const uint32_t stage = base + L::kStage + (t & 1) * 2 * L::kTile;
    load_tile<kB, D>(stage, kb, p.k_ss, t * kB, p.sk, tid, kThreads);
    load_tile<kB, D>(stage + L::kTile, vb, p.v_ss, t * kB, p.sk, tid,
                     kThreads);
  };
  if (n_tiles > 0) {
    load_tile<kB, D>(sQ, p.q + b * p.q_sb + hq * p.q_sh, p.q_ss, q0, p.sq,
                     tid, kThreads);
    load_tile<kB, D>(sDO, p.dout + b * p.do_sb + hq * p.do_sh, p.do_ss, q0,
                     p.sq, tid, kThreads);
    load_stage(0);
    cp_async_commit();
  }
  const float sl = p.scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const int k0 = t * kB;
    const uint32_t sK = base + L::kStage + (t & 1) * 2 * L::kTile;
    const uint32_t sV = sK + L::kTile;

    // S = Q K^T and dP = dO V^T: 64 q rows x 64 k columns each.
    float s[kB / 2], dp[kB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kB>(s, desc_k_major(sQ, kB, 16 * kk),
                   desc_k_major(sK, kB, 16 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kB>(dp, desc_k_major(sDO, kB, 16 * kk),
                   desc_k_major(sV, kB, 16 * kk), kk);
    wgmma_commit();

    const bool edge = k0 + kB > p.sk || (p.causal && k0 + kB - 1 > q0);
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < kB / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * j + r;
        s[i] = exp2_approx(s[i] * sl - lse[r >> 1]);
        if (edge) {
          const int ki = k0 + 8 * j + col + (r & 1);
          const int qi = qrow + 8 * (r >> 1);
          if (ki >= p.sk || (p.causal && ki > qi)) s[i] = 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta) * scale, as bf16 A fragments for dQ += dS K.
    uint32_t da[kB / 16][4];
#pragma unroll
    for (int i = 0; i < kB / 2; ++i)
      dp[i] = s[i] * (dp[i] - delta[(i >> 1) & 1]) * p.scale;
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) acc_to_a(da[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk)
      wgmma_rs_tb<D>(dq, da[kk], desc_mn_major(sK, kB, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) fence_regs(da[kk]);
    __syncthreads();  // every warp is done with this stage's tiles
  }

  store_acc<D>(p.dq + b * p.dq_sb + hq * p.dq_sh, p.dq_ss, dq, qrow, p.sq,
               col);
}

// Lets `kernel` take its dynamic shared memory (above the 48 KB default).
template <int D>
cudaError_t allow_smem(void (*kernel)(Params)) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytes);
}

template <int D>
cudaError_t launch_dkdv(const Params& p, int b, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem<D>(flash_bwd_dkdv_kernel<D>);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(b * p.kvh, (p.sk + kB - 1) / kB);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, Layout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int b, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem<D>(flash_bwd_dq_kernel<D>);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(b * p.h, (p.sq + kB - 1) / kB);
  flash_bwd_dq_kernel<D><<<grid, kThreads, Layout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(bool dq, int* smem_bytes, int* blocks_per_sm) {
  void (*kernel)(Params) =
      dq ? flash_bwd_dq_kernel<D> : flash_bwd_dkdv_kernel<D>;
  const cudaError_t attr = allow_smem<D>(kernel);
  if (attr != cudaSuccess) return attr;
  *smem_bytes = Layout<D>::kBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, Layout<D>::kBytes);
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

// The dynamic shared memory a block of one backward kernel takes (`dq` 0:
// dK/dV, 1: dQ) and how many of its blocks fit on one SM of this card.
extern "C" int rtt_flash_bwd_occupancy(int dq, int d, int* smem_bytes,
                                       int* blocks_per_sm) {
  if (d == 128) return static_cast<int>(occupancy<128>(dq, smem_bytes,
                                                       blocks_per_sm));
  if (d == 64) return static_cast<int>(occupancy<64>(dq, smem_bytes,
                                                     blocks_per_sm));
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
