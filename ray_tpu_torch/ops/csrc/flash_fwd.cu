// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: ray_tpu/ops/attention.py, _flash_fwd_kernel (launched by
// _flash_fwd). Same function: online-softmax attention over K/V tiles,
// causal tiles above the diagonal skipped, GQA by mapping q head h to kv
// head h / group (no repeat), K/V rows past sk never loaded (zero-filled)
// and columns past sk or above the diagonal masked with
// DEFAULT_MASK_VALUE = -0.7 * FLT_MAX, an empty row guarded by l == 0.
// Writes O in bf16 and the row log-sum-exp as (b, h, sq) f32; the TPU's
// (b, h, 8, sq) lse layout and 128-lane m/l scratch are Mosaic tiling
// artifacts and are not carried over.
//
// Bound on this card: operations. At the serving path's prefill shape
// (llama3-8b: 32 q heads, 8 kv heads, head_dim 128, s_pad 2048, causal)
// the needed work is 2 * d * h * s * (s + 1) = 34.4 GFLOP on the tensor
// cores against 42 MB of q/k/v/o/lse traffic: about 35 us at the bf16
// peak against about 13 us of bytes.
//
// Design (simple first; wgmma, TMA and warp specialisation come later):
//  * grid (ceil(sq / 64), b * h), one 128-thread block per (q tile, head);
//    the q tiles are walked in reverse so the longest causal tiles start
//    first. A loop over K/V tiles inside the block replaces the TPU's
//    sequential grid axis.
//  * Q, K and V tiles are staged in shared memory with 16-byte loads;
//    rows are padded by 16 bytes against bank conflicts.
//  * each warp owns 16 query rows. S = Q K^T and O += P V run on the
//    tensor cores through nvcuda::wmma bf16 16x16x16 with f32
//    accumulators; Q's fragments stay in registers for the whole loop.
//  * the row max and sum live in f32 registers, two lanes per row. The
//    O accumulator lives in shared memory in f32 (wmma's register layout
//    is opaque, so the per-row rescale by exp(m_old - m_new) is done
//    there before the P V product accumulates onto it).
// Shared memory: 110 KB for head_dim 128 (dynamic), two blocks per SM.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kWarps = 4;      // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -0.7f * FLT_MAX;

template <int D>
struct Layout {
  static constexpr int kLdQ = D + 8;    // bf16 pitch of the Q/K/V tiles
  static constexpr int kLdS = kBK + 4;  // f32 pitch of the scores
  static constexpr int kLdP = kBK + 8;  // bf16 pitch of the probabilities
  static constexpr int kLdO = D + 4;    // f32 pitch of the O accumulator
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLdQ * 2;
  static constexpr int kV = kK + kBK * kLdQ * 2;
  static constexpr int kS = kV + kBK * kLdQ * 2;
  static constexpr int kP = kS + kBQ * kLdS * 4;
  static constexpr int kO = kP + kBQ * kLdP * 2;
  static constexpr int kBytes = kO + kBQ * kLdO * 4;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, seq
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int h, group, sq, sk;
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
  for (int i = threadIdx.x; i < kBK * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::kLdQ + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::kP);
  float* sO = reinterpret_cast<float*>(smem + L::kO);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hq = bh % p.h;
  const int hk = hq / p.group;
  const bf16* qb = p.q + b * p.q_sb + hq * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);  // the row this lane pair owns
  const int half = lane & 1;                // which half of its columns
  const int qi = q0 + row;

  load_tile<D>(sQ, qb, p.q_ss, q0, p.sq);
  for (int i = threadIdx.x; i < kBQ * L::kLdO; i += kThreads) sO[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * L::kLdQ + kk * 16,
                           L::kLdQ);

  // Causal: tile t runs iff t * 64 <= q0 + 63, as the TPU kernel's test.
  const int k_end = p.causal ? min(p.sk, q0 + kBQ) : p.sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, p.k_ss, k0, p.sk);
    load_tile<D>(sV, vb, p.v_ss, k0, p.sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (K row-major is K^T col-major).
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * L::kLdQ + kk * 16, L::kLdQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sS + warp * 16 * L::kLdS + n * 16, sf, L::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this tile; two lanes per row, 32 columns each.
    {
      const float* srow = sS + row * L::kLdS + half * 32;
      float s[32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int ki = k0 + half * 32 + j;
        float x = srow[j] * p.scale;
        if (ki >= p.sk || (p.causal && qi < ki)) x = kMaskValue;
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = __expf(m_i - m_new);  // 0 on the first tile
      float sum = 0.f;
      bf16* prow = sP + row * L::kLdP + half * 32;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float e = __expf(s[j] - m_new);
        sum += e;
        prow[j] = __float2bfloat16(e);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_i = alpha * l_i + sum;
      m_i = m_new;
      float* orow = sO + row * L::kLdO + half * (D / 2);
#pragma unroll 8
      for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows, accumulating onto the rescaled O.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
        pf[kBK / 16];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], sP + warp * 16 * L::kLdP + kk * 16,
                             L::kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float* optr = sO + warp * 16 * L::kLdO + n * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, optr, L::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sV + kk * 16 * L::kLdQ + n * 16, L::kLdQ);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(optr, of, L::kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qi < p.sq) {
    const float safe_l = (l_i == 0.f) ? 1.f : l_i;
    const float* orow = sO + row * L::kLdO + half * (D / 2);
    bf16* dst = p.o + b * p.o_sb + hq * p.o_sh + qi * p.o_ss + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; j += 8) {
      uint4 packed;
      bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(orow[j + u] / safe_l);
      *reinterpret_cast<uint4*>(dst + j) = packed;
    }
    if (half == 0)
      p.lse[static_cast<long long>(bh) * p.sq + qi] = m_i + logf(safe_l);
  }
}

template <int D>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  flash_fwd_kernel<D><<<grid, kThreads, Layout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/o strides are in elements, head_dim stride 1; the wrapper
// guarantees bf16, 16-byte alignment, kvh | h and b * h <= 65535.
extern "C" int rtt_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int kvh, int sq, int sk, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh || sq < 0 || sk < 0)
    return cudaErrorInvalidValue;
  if (sq == 0) return 0;
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<bf16*>(o),
           static_cast<float*>(lse), q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, h, h / kvh, sq, sk, scale,
           causal};
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return static_cast<int>(launch<128>(p, grid, s));
  if (d == 64) return static_cast<int>(launch<64>(p, grid, s));
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
