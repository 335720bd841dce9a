// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate,
// every product on wgmma with its accumulator in registers.
//
// Replaces: ray_tpu/ops/attention.py, _flash_fwd_kernel (launched by
// _flash_fwd). Same function: online-softmax attention over K/V tiles,
// causal tiles above the diagonal skipped (top-left alignment, q row i
// sees keys j <= i, also when sq != sk), GQA by mapping q head h to kv
// head h / group (no repeat), K/V rows past sk never read (zero-filled)
// and columns past sk or above the diagonal masked with
// DEFAULT_MASK_VALUE = -0.7 * FLT_MAX, an empty row guarded by l == 0.
// Writes O in bf16 and the row log-sum-exp as (b, h, sq) f32 in natural
// log (m + log l of the scaled scores, as the backward kernels read it);
// the TPU's (b, h, 8, sq) lse layout and 128-lane m/l scratch are Mosaic
// tiling artifacts and are not carried over.
//
// Bound on this card: operations. At the serving path's prefill shape
// (llama3-8b: 32 q heads, 8 kv heads, head_dim 128, s_pad 2048, causal)
// the needed work is 2 * d * h * s * (s + 1) = 34.4 GFLOP on the tensor
// cores against 42 MB of q/k/v/o/lse traffic: 0.0348 ms at the bf16 peak
// (989 TF/s) against about 0.013 ms of bytes.
//
// Design (helpers in hopper.cuh), against the five faults of the first
// (wmma) version of this kernel:
//  * products: S = Q K^T is SS wgmma (m64n128k16, Q and K K-major in
//    128-byte-swizzled shared memory); O += P V is RS wgmma, P packed to
//    bf16 in place from the S accumulator (`acc_to_a`) and V read MN-major
//    through the trans-b flag. No mma.sync.
//  * scores: S stays in the accumulator's registers and the online
//    softmax runs on the fragment: each thread holds parts of two rows,
//    the row max is reduced over the 4 lanes of a quad with two shuffles,
//    the row sum is kept per thread and reduced once at the end. exp2 with
//    scale * log2(e) folded into one FMA; the stored lse is natural. Masks
//    are applied only on tiles that cross the diagonal or sk.
//  * the O accumulator lives in registers (64 f32 a thread at head_dim
//    128) and is rescaled there; no S, P or O tile goes to shared memory.
//  * loads: TMA, issued by one thread. Q is loaded once a block; K and V
//    tiles (128 rows) stream through two rings of three stages, each slot
//    guarded by a full mbarrier (the copy's bytes) and an empty one (every
//    warp has read it). The issuer runs in warpgroup 1, which trails
//    warpgroup 0 under the ping-pong below, so the slots it refills have
//    been released already; K_{t+2} and V_{t+1} are in flight while tile
//    t is computed. No thread spends instructions on copies, and no
//    block-wide barrier is left in the loop.
//  * occupancy and the chain (wgmma, wait, exp, wgmma): one block an SM,
//    two warpgroups of 64 q rows sharing each K/V tile. Inside a
//    warpgroup, tile t's S and tile t - 1's P V are issued together, and
//    tile t's softmax runs while P V is on the tensor cores
//    (wgmma_wait<1>). Across the two, named barriers make them take turns
//    to issue (ping-pong), so one's softmax overlaps the other's products.
//  * work order: one block per (128-row q tile, batch x head), q tiles
//    walked from the last (the longest under causal) to the first across
//    every head, so the long blocks are scheduled first.
// Resources (ptxas, H100): 194 registers and 230,496 bytes of dynamic
// shared memory a block at head_dim 128, one block an SM, no spills.
// Measured alternatives (H100 80GB HBM3, 700 W, at the llama3-8b prefill
// shape, against 0.081-0.082 ms for this design): every thread loading
// with cp.async and a block barrier a tile, 0.125 ms (0.121 ms three
// stages deep; one warpgroup a block at two blocks an SM, 0.153 ms); a
// producer warpgroup or warp with setmaxnreg spills (ptxas keeps the
// whole kernel at 168 registers for 288 or 384 threads), 0.113-0.20 ms;
// without the ping-pong, 0.084 ms; two stages, 0.081 ms here but 0.087 ms
// at the training shape (b 2, 16 heads) against 0.083 ms.
//
// The tensor maps are built on the host for every call (the seq, head and
// batch axes sorted by stride, so a (b, s, h, d) view maps as it is);
// cuTensorMapEncodeTiled is looked up through the runtime, so nothing
// links against the driver library.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;
using namespace hopper;

namespace {

constexpr int kM = 64;                  // q rows of a warpgroup
constexpr int kWarpgroups = 2;          // warpgroups a block
constexpr int kBQ = kM * kWarpgroups;    // q rows of a block
constexpr int kBK = 128;                // rows of a K/V tile
constexpr int kStages = 3;              // K tiles in flight, and V tiles
constexpr int kThreads = 128 * kWarpgroups;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -0.7f * FLT_MAX;

// Shared memory: the warpgroups' Q tiles, a ring of kStages K tiles, a
// ring of kStages V tiles, then the rings' mbarriers (full and empty, for
// K and for V).
template <int D>
struct Layout {
  static constexpr int S = kStages;
  static constexpr int kQTile = kM * D * 2;
  static constexpr int kKVTile = kBK * D * 2;
  static constexpr int kK = kWarpgroups * kQTile;
  static constexpr int kV = kK + S * kKVTile;
  static constexpr int kBar = kV + S * kKVTile;
  static constexpr int kBytes = kBar + 4 * S * 8 + 1024;  // + alignment
};

// A TMA view of q, k or v: dims (head_dim, then the seq, head and batch
// axes in order of stride); `dim` says where seq, head and batch went.
struct TensorView {
  CUtensorMap map;
  int dim[3];   // tensor-map dimension (1-3) of seq, head, batch
};

struct Params {
  TensorView q, k, v;
  bf16* o;
  float* lse;
  long long o_sb, o_sh, o_ss;  // element strides of batch, head, seq
  int bh, h, group, sq, sk;    // bh = batch * q heads
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

// Rows [r0, r0 + ROWS) of (batch, head) of a view into a swizzled tile of
// D columns, as D / 64 boxes of 64 columns; rows past the sequence are
// zero-filled. Completes on `bar`.
template <int ROWS, int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const TensorView& t,
                                         int r0, int head, int batch,
                                         uint32_t bar) {
  int c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 1; i < 4; ++i)
    c[i] = t.dim[0] == i ? r0 : t.dim[1] == i ? head : batch;
  const uint64_t map = reinterpret_cast<uint64_t>(&t.map);
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            dst + cb * ROWS * 128),
        "l"(map), "r"(bar), "r"(64 * cb), "r"(c[1]), "r"(c[2]), "r"(c[3])
        : "memory");
}

// Online softmax of one tile's scores, in place on the accumulator
// fragment: mask (only where the tile crosses the diagonal or sk), the
// new row max m, alpha = exp(m_old - m), s = exp(s * scale - m * scale)
// unrounded, and this thread's part of the row sum l rescaled and added
// to. `row` is the thread's first row (the other is row + 8).
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Params& p, int k0,
                                             int q0w, int row, int col,
                                             float sl) {
  if (k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > q0w)) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ki = k0 + 8 * j + col + (r & 1);
        const int qi = row + 8 * (r >> 1);
        if (ki >= p.sk || (p.causal && ki > qi)) s[4 * j + r] = kMaskValue;
      }
    }
  }
  float mx[2] = {m[0], m[1]}, ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2_approx((m[h] - mx[h]) * sl);  // 0 on the first tile
    m[h] = mx[h];
    ms[h] = mx[h] * sl;
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    s[i] = exp2_approx(fmaf(s[i], sl, -ms[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

template <int D>
__device__ __forceinline__ void issue_s(float (&s)[kBK / 2], uint32_t sQ,
                                        uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kBK>(s, desc_k_major(sQ, kM, 16 * kk),
                  desc_k_major(sK, kBK, 16 * kk), kk);
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs_tb<D>(o, pa[kk], desc_mn_major(sV, kBK, 16 * kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ Params p) {
  using L = Layout<D>;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_base(smem);

  const int tid = threadIdx.x;
  const int c = tid >> 7;           // this warpgroup's 64 q rows
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  // Every head's last q tile first, then the one before it, ...
  const int n_q = (p.sq + kBQ - 1) / kBQ;
  const int bh = static_cast<int>(blockIdx.x % p.bh);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x / p.bh)) * kBQ;
  const int b = bh / p.h, hq = bh % p.h, hk = hq / p.group;
  auto sK = [&](int t) { return base + L::kK + (t % S) * L::kKVTile; };
  auto sV = [&](int t) { return base + L::kV + (t % S) * L::kKVTile; };
  auto full_k = [&](int t) { return base + L::kBar + 8 * (t % S); };
  auto full_v = [&](int t) { return full_k(t) + 8 * S; };
  auto empty_k = [&](int t) { return full_k(t) + 16 * S; };
  auto empty_v = [&](int t) { return full_k(t) + 24 * S; };

  // Causal: tile t runs iff t * kBK <= q0 + kBQ - 1, as the TPU kernel's
  // test.
  const int k_end = p.causal ? min(p.sk, q0 + kBQ) : p.sk;
  const int n = (k_end + kBK - 1) / kBK;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full_k(i), 1);                  // the issuer, + bytes
      mbar_init(full_v(i), 1);
      mbar_init(empty_k(i), 4 * kWarpgroups);    // every warp
      mbar_init(empty_v(i), 4 * kWarpgroups);
    }
  }
  __syncthreads();

  // One thread of warpgroup 1 issues every load (TMA). It loads K_j once
  // both warpgroups have released K_{j-S} (their S product landed) and V_j
  // once they have released V_{j-S} (their P V product landed); under the
  // ping-pong warpgroup 1 runs behind warpgroup 0, so it never waits long.
  const bool issuer = tid == 128;
  auto load_k = [&](int j) {
    if (!issuer || j >= n) return;
    mbar_wait(empty_k(j), ((j / S) & 1) ^ 1);
    mbar_expect_tx(full_k(j), L::kKVTile);
    tma_tile<kBK, D>(sK(j), p.k, j * kBK, hk, b, full_k(j));
  };
  auto load_v = [&](int j) {
    if (!issuer || j >= n) return;
    mbar_wait(empty_v(j), ((j / S) & 1) ^ 1);
    mbar_expect_tx(full_v(j), L::kKVTile);
    tma_tile<kBK, D>(sV(j), p.v, j * kBK, hk, b, full_v(j));
  };
  if (issuer && n > 0) {
    mbar_expect_tx(full_k(0), kWarpgroups * L::kQTile + L::kKVTile);
#pragma unroll
    for (int w = 0; w < kWarpgroups; ++w)
      tma_tile<kM, D>(base + w * L::kQTile, p.q, q0 + kM * w, hq, b,
                      full_k(0));
    tma_tile<kBK, D>(sK(0), p.k, 0, hk, b, full_k(0));
    for (int j = 1; j < S - 1; ++j) load_k(j);
    for (int j = 0; j < S - 2; ++j) load_v(j);
  }

  const int q0w = q0 + kM * c;
  const int row = q0w + 16 * warp + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // first column of each 8-column chunk
  const uint32_t sQ = base + c * L::kQTile;
  const float sl = p.scale * kLog2e;
  // Ping-pong: the two warpgroups take turns to issue their products, so
  // one's softmax runs while the other's products are on the tensor cores.
  auto my_turn = [&] { named_sync(1 + c, 256); };
  auto your_turn = [&] { named_arrive(2 - c, 256); };
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float alpha[2];
  uint32_t pa[kBK / 16][4];             // P of the previous tile, bf16

  if (n > 0) {
    if (c == 1) your_turn();            // warpgroup 0 goes first
    mbar_wait(full_k(0), 0);
    float s[kBK / 2];
    my_turn();
    wgmma_fence();
    issue_s<D>(s, sQ, sK(0));
    your_turn();
    load_k(S - 1);
    load_v(S - 2);
    wgmma_wait<0>();
    fence_regs(s);
    release(empty_k(0));
    softmax_tile(s, m, l, alpha, p, 0, q0w, row, col, sl);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(pa[kk], s, kk);
  }

  // Tile t: S = Q K_t^T and O += P_{t-1} V_{t-1} are issued together; the
  // softmax of tile t runs while the P V product is on the tensor cores.
  for (int t = 1; t < n; ++t) {
    mbar_wait(full_k(t), (t / S) & 1);
    mbar_wait(full_v(t - 1), ((t - 1) / S) & 1);
    float s[kBK / 2];
    my_turn();
    wgmma_fence();
    issue_s<D>(s, sQ, sK(t));
    issue_pv<D>(o, pa, sV(t - 1));
    your_turn();
    load_k(t + S - 1);
    load_v(t + S - 2);
    wgmma_wait<1>();     // S landed; the P V product may still run
    fence_regs(s);
    release(empty_k(t));
    softmax_tile(s, m, l, alpha, p, t * kBK, q0w, row, col, sl);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
    release(empty_v(t - 1));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(pa[kk], s, kk);
  }

  if (n > 0) {       // the last tile's P V
    mbar_wait(full_v(n - 1), ((n - 1) / S) & 1);
    my_turn();
    wgmma_fence();
    issue_pv<D>(o, pa, sV(n - 1));
    if (c == 0) your_turn();   // warpgroup 1 went first: nobody is left
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
  }

  bf16* ob = p.o + b * p.o_sb + hq * p.o_sh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row + 8 * h;
    if (r >= p.sq) continue;
    const float safe_l = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / safe_l;
    bf16* out = ob + r * p.o_ss + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    if ((lane & 3) == 0)
      p.lse[static_cast<long long>(bh) * p.sq + r] =
          m[h] * p.scale + logf(safe_l);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The view of a (batch, heads, seq, d) bf16 tensor with element strides
// (sb, sh, ss) and unit stride along d, read in boxes of `rows` rows x 64
// columns, 128-byte swizzled. Returns 0 or a CUDA error.
int make_view(TensorView* t, const void* ptr, int batch, int heads,
              int seq, int d, long long sb, long long sh, long long ss,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the seq, head and batch axes, by stride (an axis of size 1 last)
  const long long size[3] = {seq, heads, batch};
  long long stride[3] = {ss, sh, sb};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = 1LL << 35;
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) {
        const int tmp = order[i];
        order[i] = order[j];
        order[j] = tmp;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d)};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int axis = order[i];
    t->dim[axis] = i + 1;
    dims[i + 1] = static_cast<cuuint64_t>(size[axis]);
    strides[i] = static_cast<cuuint64_t>(stride[axis] * 2);
    if (axis == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
  }
  const CUresult r = encode(
      &t->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

template <int D>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_fwd_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<D>::kBytes);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem<D>();
  if (attr != cudaSuccess) return attr;
  const long long blocks =
      static_cast<long long>((p.sq + kBQ - 1) / kBQ) * p.bh;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_kernel<D><<<static_cast<unsigned>(blocks), kThreads,
                        Layout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t attr = allow_smem<D>();
  if (attr != cudaSuccess) return attr;
  *smem_bytes = Layout<D>::kBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_kernel<D>, kThreads, Layout<D>::kBytes);
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
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if (sq == 0) return 0;
  Params p;
  int err = make_view(&p.q, q, b, h, sq, d, q_sb, q_sh, q_ss, kM);
  if (!err && sk > 0)
    err = make_view(&p.k, k, b, kvh, sk, d, k_sb, k_sh, k_ss, kBK);
  if (!err && sk > 0)
    err = make_view(&p.v, v, b, kvh, sk, d, v_sb, v_sh, v_ss, kBK);
  if (err) return err;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.bh = b * h;
  p.h = h;
  p.group = h / kvh;
  p.sq = sq;
  p.sk = sk;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return static_cast<int>(launch<128>(p, s));
  return static_cast<int>(launch<64>(p, s));
}

// The dynamic shared memory a block of the forward kernel takes at head
// dim `d` and how many of its blocks fit on one SM of this card.
extern "C" int rtt_flash_fwd_occupancy(int d, int* smem_bytes,
                                       int* blocks_per_sm) {
  if (d == 128) return static_cast<int>(occupancy<128>(smem_bytes,
                                                        blocks_per_sm));
  if (d == 64) return static_cast<int>(occupancy<64>(smem_bytes,
                                                      blocks_per_sm));
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
