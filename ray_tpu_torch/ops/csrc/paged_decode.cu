// Paged decode attention for Hopper (sm_90a): one new token a row against
// the row's own K/V pages, read in place through its page table, with the
// new token's K/V written into its slot on the way.
//
// Replaces no TPU kernel. The JAX package's `decode_step`
// (ray_tpu/models/decode.py) gathers every row's `max_pages * page_size`
// positions and runs plain einsums, which XLA fuses on the TPU. On the card
// the same plain code (kept as `paged_decode_attention_reference`, the CPU
// path) gathers 4,096 positions a row into new bf16 tensors, casts them to
// f32 and multiplies them there: ~30 GB of traffic a layer at 256 rows,
// where the rows' own K/V is ~1.1 GB. This kernel reads only that.
//
// Bound on this card: bytes. GQA shares each K/V position among G q heads:
// 2 * G * head_dim FLOPs for QK and as many for PV, per 4 * head_dim bytes
// of K and V (G = 4: 2 FLOP a byte). At 3.35 TB/s that is ~13 TF/s of f32
// FMA at G = 4, about a fifth of the card's 67 TF/s on CUDA cores, so the
// arithmetic stays f32 on CUDA cores: bf16 operands exactly widened, f32
// scores, an f32 online softmax, P kept in f32 and PV accumulated in f32,
// as the plain path computes them.
//
// Design:
//  * a block of 4 warps handles one (row, kv head, chunk of the row's
//    pages); its warps take the chunk's pages in turn (warp w: w, w + 4,
//    ...), each with a ring of kStages pages in shared memory filled by
//    16-byte cp.async copies, so a warp's next pages are in flight while
//    it computes on the current one. Nothing is shared between warps until
//    the end: no block barrier inside the loop.
//  * a warp reads a (page_size x head_dim) K or V tile as rows of
//    head_dim / 8 16-byte vectors; a lane owns one vector (8 dims) of one
//    position, and holds the G q heads' matching 8 dims in f32 registers.
//    A score is the lane's 8-term dot product summed over the row's lanes
//    by xor shuffles. PV uses the same ownership: each lane accumulates its
//    8 dims of the G outputs over its own positions, and the position
//    groups of a warp are summed once, after the loop.
//  * the online softmax runs in base 2 (scores times scale * log2 e), its
//    running max rescaling the accumulators once a sub-tile of a page, not
//    once a position.
//  * a block stops at its row's position: chunks past it, inactive rows and
//    page ids below 0 (or past the pool) read nothing.
//  * the block whose chunk holds the row's position writes the new k / v
//    into its slot (active row, assigned page) and puts them into its
//    shared tile in place of what it loaded, so that position's score and
//    value come from the new token.
//  * a block's 4 warps merge their (max, sum, acc) in shared memory and
//    write the chunk's normalised output and log-sum-exp in f32; a second,
//    small kernel (a warp a (row, q head)) merges the chunks by their
//    log-sum-exp in f32 and rounds to bf16 once. A row of one chunk passes
//    through unchanged.
//  * the chunk length follows the shape (`ops/paged_decode.py`): at 256
//    rows x 8 kv heads it only evens out ragged contexts; at 8 rows it
//    splits the rows' contexts over the card's SMs.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;            // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;           // pages in a warp's ring
constexpr int kMaxChunkPages = 64;   // pages a block reads at most: the
                                     // wrapper's 512 positions at page 8

struct Params {
  const __nv_bfloat16* q;    // (B, H, D)
  __nv_bfloat16* kc;         // (num_pages, PS, KVH, D), one layer
  __nv_bfloat16* vc;
  const __nv_bfloat16* kn;   // (B, KVH, D): this step's k, v
  const __nv_bfloat16* vn;
  const int* pt;             // (B, max_pages)
  const int* pos;            // (B,)
  const uint8_t* active;     // (B,)
  float* part_o;             // (B, H, chunks, D): a chunk's output
  float* part_lse;           // (B, H, chunks): its log-sum-exp, base 2
  __nv_bfloat16* out;        // (B, H, D)
  int B, H, KVH, num_pages, max_pages, chunk_pages, chunks;
  float scale_log2;          // softmax scale * log2(e)
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// The 8 bf16 of a 16-byte vector, widened exactly to f32.
__device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Passes a sub-tile between two updates of the running max: the most (a
// power of two dividing the page's passes) that keep a lane's scores, NT x
// G of them, within 32 registers.
__host__ __device__ constexpr int sub_tile(int passes, int group) {
  int t = passes;
  while (t > 1 && t * group > 32) t /= 2;
  return t;
}

// One (row b, kv head g, chunk c) a block. G q heads a kv head, head_dim
// D, page size PS.
template <int G, int D, int PS>
__global__ void __launch_bounds__(kThreads)
    rtt_paged_decode_attn(const Params p) {
  constexpr int VR = D / 8;            // 16-byte vectors a position row
  constexpr int PP = 32 / VR;          // positions a warp reads at once
  constexpr int NP = PS / PP;          // such passes a page
  constexpr int NT = sub_tile(NP, G);
  static_assert(NP % NT == 0, "sub-tiles must divide a page");
  constexpr int TILE = PS * D;         // bf16 of a K (or V) page tile
  constexpr int VPL = TILE / 8 / 32;   // 16-byte copies a lane a tile
  static_assert(VPL * 8 * 32 == TILE, "a tile is whole copies a lane");
  constexpr int kRingBytes = kStages * 2 * TILE * 2;
  static_assert((G * D + 2 * G) * 4 <= kRingBytes,
                "the warps' merge fits in a warp's ring");

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!p.active[b]) return;
  const int pos = p.pos[b];
  const int last = pos / PS;           // the page index holding pos
  const int first = c * p.chunk_pages;
  if (pos < 0 || first > last) return;  // past the row: the merge skips it
  const int end = min(min(first + p.chunk_pages, last + 1), p.max_pages);
  const int n = end - first;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int pid[kMaxChunkPages];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int id = p.pt[static_cast<long long>(b) * p.max_pages + first + i];
    pid[i] = (id >= 0 && id < p.num_pages) ? id : -1;
  }
  __syncthreads();
  // the page (index in the chunk) whose slot takes this step's k / v
  const int own = (last < end && pid[last - first] >= 0) ? last - first : -1;

  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem + warp * kRingBytes);
  const uint32_t ring_s = hopper::smem_u32(ring);
  const long long row_stride = static_cast<long long>(p.KVH) * D;
  const int vec = lane % VR, sub = lane / VR;

  // q's 8 dims under this lane's vector, for each of the G heads
  float q[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        p.q + (static_cast<long long>(b) * p.H + g * G + j) * D + vec * 8);
    widen(v, q[j]);
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = neg_inf();
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  auto next = [&](int i) {
    while (i < n && pid[i] < 0) i += kWarps;
    return i;
  };
  auto fetch = [&](int i, int stage) {
    const long long base =
        static_cast<long long>(pid[i]) * PS * row_stride + g * D;
    const uint32_t ks = ring_s + stage * 2 * TILE * 2;
    const uint32_t vs = ks + TILE * 2;
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
      const int idx = lane + 32 * t, r = idx / VR, c8 = idx % VR;
      const long long off = base + r * row_stride + c8 * 8;
      hopper::cp_async_16(ks + (r * D + c8 * 8) * 2, p.kc + off, 16);
      hopper::cp_async_16(vs + (r * D + c8 * 8) * 2, p.vc + off, 16);
    }
  };

  int load = next(warp);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (load < n) {
      fetch(load, s);
      load = next(load + kWarps);
    }
    hopper::cp_async_commit();
  }
  int stage = 0;
  for (int i = next(warp); i < n; i = next(i + kWarps)) {
    if (load < n) {
      fetch(load, (stage + kStages - 1) % kStages);
      load = next(load + kWarps);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<kStages - 1>();
    __syncwarp();
    __nv_bfloat16* sk = ring + stage * 2 * TILE;
    __nv_bfloat16* sv = sk + TILE;
    if (i == own) {
      // this step's k / v: into the cache slot, and into the tile in
      // place of what the slot held
      const int slot = pos % PS;
      const long long src = (static_cast<long long>(b) * p.KVH + g) * D;
      const long long dst =
          static_cast<long long>(pid[i]) * PS * row_stride +
          slot * row_stride + g * D;
      for (int v = lane; v < 2 * VR; v += 32) {
        const bool is_v = v >= VR;
        const int c8 = is_v ? v - VR : v;
        const uint4 x = *reinterpret_cast<const uint4*>(
            (is_v ? p.vn : p.kn) + src + c8 * 8);
        *reinterpret_cast<uint4*>((is_v ? p.vc : p.kc) + dst + c8 * 8) = x;
        *reinterpret_cast<uint4*>((is_v ? sv : sk) + slot * D + c8 * 8) = x;
      }
      __syncwarp();
    }
    const int base_pos = (first + i) * PS;
#pragma unroll
    for (int t0 = 0; t0 < NP; t0 += NT) {
      float s[NT][G];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int r = (t0 + t) * PP + sub;
        float kf[8];
        widen(*reinterpret_cast<const uint4*>(sk + r * D + vec * 8), kf);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(q[j][e], kf[e], d);
          s[t][j] = d;
        }
#pragma unroll
        for (int off = VR / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int j = 0; j < G; ++j)
            s[t][j] += __shfl_xor_sync(0xffffffffu, s[t][j], off);
        }
        const bool seen = base_pos + r <= pos;
#pragma unroll
        for (int j = 0; j < G; ++j)
          s[t][j] = seen ? s[t][j] * p.scale_log2 : neg_inf();
      }
      // the sub-tile's max over the warp's positions; slot 0 of a page
      // read is always seen, so the first sub-tile's max is finite
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float mx = s[0][j];
#pragma unroll
        for (int t = 1; t < NT; ++t) mx = fmaxf(mx, s[t][j]);
#pragma unroll
        for (int off = VR; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[j], mx);
        if (mn != m[j]) {
          const float corr = exp2f(m[j] - mn);
          l[j] *= corr;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[j][e] *= corr;
          m[j] = mn;
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int r = (t0 + t) * PP + sub;
        float vf[8];
        widen(*reinterpret_cast<const uint4*>(sv + r * D + vec * 8), vf);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float pj = exp2f(s[t][j] - m[j]);
          l[j] += pj;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(pj, vf[e], acc[j][e]);
        }
      }
    }
    __syncwarp();
    stage = (stage + 1) % kStages;
  }
  hopper::cp_async_wait<0>();

  // the warp's position groups, summed (m is the same on every lane)
#pragma unroll
  for (int off = VR; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
    }
  }
  __syncwarp();
  // each warp's (acc, m, l) into its own ring, then the block's merge
  float* red = reinterpret_cast<float*>(smem + warp * kRingBytes);
  if (lane < VR) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float4* dst = reinterpret_cast<float4*>(red + j * D + vec * 8);
      dst[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      dst[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      red[G * D + j] = m[j];
      red[G * D + G + j] = l[j];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    float mw[kWarps], mm = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = reinterpret_cast<const float*>(smem + w * kRingBytes)[G * D + j];
      mm = fmaxf(mm, mw[w]);
    }
    float o = 0.f, lse = neg_inf();
    if (mm != neg_inf()) {
      float sum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* rw =
            reinterpret_cast<const float*>(smem + w * kRingBytes);
        const float f = exp2f(mw[w] - mm);   // 0 for a warp that read nothing
        sum = fmaf(rw[G * D + G + j], f, sum);
        a = fmaf(rw[j * D + d], f, a);
      }
      o = a / sum;
      lse = mm + log2f(sum);
    }
    const long long row = static_cast<long long>(b) * p.H + g * G + j;
    p.part_o[(row * p.chunks + c) * D + d] = o;
    if (d == 0) p.part_lse[row * p.chunks + c] = lse;
  }
}

// One (row, q head) a warp: the row's chunks merged by their log-sum-exp,
// the output rounded to bf16 once. Inactive rows, and rows that saw no
// position, get zeros.
template <int D, int PS>
__global__ void __launch_bounds__(kThreads)
    rtt_paged_decode_merge(const Params p) {
  constexpr int E = D / 32;            // dims a lane
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.H) return;
  const int b = static_cast<int>(row / p.H);
  float o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
  const int pos = p.pos[b];
  if (p.active[b] && pos >= 0) {
    const int valid = min(p.chunks, pos / PS / p.chunk_pages + 1);
    const float* lse = p.part_lse + row * p.chunks;
    float mm = neg_inf();
    for (int c = lane; c < valid; c += 32) mm = fmaxf(mm, lse[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    if (mm != neg_inf()) {
      float sum = 0.f;
      for (int c = 0; c < valid; ++c) {
        const float w = exp2f(lse[c] - mm);
        sum += w;
        const float* src = p.part_o + (row * p.chunks + c) * D + lane * E;
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = fmaf(w, src[e], o[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] /= sum;
    }
  }
  __nv_bfloat16* dst = p.out + row * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = __float2bfloat16(o[e]);
}

template <int G, int D, int PS>
constexpr int attn_smem() {
  return kWarps * kStages * 2 * PS * D * 2;
}

template <int G, int D, int PS>
int launch_gdp(const Params& p, cudaStream_t s) {
  auto attn = rtt_paged_decode_attn<G, D, PS>;
  constexpr int smem = attn_smem<G, D, PS>();
  int dev = 0;
  cudaGetDevice(&dev);
  static bool ready[64] = {};
  if (dev < 64 && !ready[dev]) {
    cudaFuncSetAttribute(attn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    ready[dev] = true;
  }
  const dim3 grid(p.chunks, p.KVH, p.B);
  attn<<<grid, kThreads, smem, s>>>(p);
  const long long rows = static_cast<long long>(p.B) * p.H;
  rtt_paged_decode_merge<D, PS>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
         s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int PS>
int launch_dp(int group, const Params& p, cudaStream_t s) {
  switch (group) {
    case 1: return launch_gdp<1, D, PS>(p, s);
    case 2: return launch_gdp<2, D, PS>(p, s);
    case 3: return launch_gdp<3, D, PS>(p, s);
    case 4: return launch_gdp<4, D, PS>(p, s);
    case 5: return launch_gdp<5, D, PS>(p, s);
    case 6: return launch_gdp<6, D, PS>(p, s);
    case 7: return launch_gdp<7, D, PS>(p, s);
    case 8: return launch_gdp<8, D, PS>(p, s);
  }
  return cudaErrorInvalidValue;
}

template <int G, int D, int PS>
int occupancy_gdp(int* smem_bytes, int* blocks_per_sm) {
  constexpr int smem = attn_smem<G, D, PS>();
  auto attn = rtt_paged_decode_attn<G, D, PS>;
  cudaFuncSetAttribute(attn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  *smem_bytes = smem;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, attn,
                                                kThreads, smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (ops/paged_decode.py) guarantees: bf16 q, caches and new
// k / v, contiguous; int32 page tables and positions, bool `active`;
// heads = group * kv_heads with group in 1..8; head_dim 64 or 128; page
// size 8 or 16; chunks * chunk_pages >= max_pages, chunk_pages at most
// kMaxChunkPages; f32 scratch of (B, heads, chunks, head_dim) and
// (B, heads, chunks).
extern "C" int rtt_paged_decode(
    const void* q, void* k_cache, void* v_cache, const void* k_new,
    const void* v_new, const void* page_tables, const void* positions,
    const void* active, void* part_o, void* part_lse, void* out, int batch,
    int heads, int kv_heads, int head_dim, int page_size, int num_pages,
    int max_pages, int chunk_pages, int chunks, float scale_log2,
    void* stream) {
  if (batch <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || chunk_pages <= 0 ||
      chunk_pages > kMaxChunkPages || chunks <= 0 ||
      static_cast<long long>(chunks) * chunk_pages < max_pages ||
      batch > 65535 || kv_heads > 65535)
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kc = static_cast<__nv_bfloat16*>(k_cache);
  p.vc = static_cast<__nv_bfloat16*>(v_cache);
  p.kn = static_cast<const __nv_bfloat16*>(k_new);
  p.vn = static_cast<const __nv_bfloat16*>(v_new);
  p.pt = static_cast<const int*>(page_tables);
  p.pos = static_cast<const int*>(positions);
  p.active = static_cast<const uint8_t*>(active);
  p.part_o = static_cast<float*>(part_o);
  p.part_lse = static_cast<float*>(part_lse);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = batch;
  p.H = heads;
  p.KVH = kv_heads;
  p.num_pages = num_pages;
  p.max_pages = max_pages;
  p.chunk_pages = chunk_pages;
  p.chunks = chunks;
  p.scale_log2 = scale_log2;
  const int group = heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128 && page_size == 16)
    return launch_dp<128, 16>(group, p, s);
  if (head_dim == 128 && page_size == 8)
    return launch_dp<128, 8>(group, p, s);
  if (head_dim == 64 && page_size == 16)
    return launch_dp<64, 16>(group, p, s);
  if (head_dim == 64 && page_size == 8)
    return launch_dp<64, 8>(group, p, s);
  return cudaErrorInvalidValue;
}

// The attention kernel's dynamic shared memory and resident blocks an SM
// at (group, head_dim, page_size) = (4, 128, 16), the main path's shape.
extern "C" int rtt_paged_decode_occupancy(int* smem_bytes,
                                          int* blocks_per_sm) {
  return occupancy_gdp<4, 128, 16>(smem_bytes, blocks_per_sm);
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
