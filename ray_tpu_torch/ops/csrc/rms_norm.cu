// RMSNorm forward for Hopper (sm_90a):
//   y = x * rsqrt(mean(x^2) + eps) * (1 + w), f32 math, y in x's dtype.
//
// Replaces: ray_tpu/ops/norms.py, _rms_kernel (launched by
// _rms_fwd_pallas), which normalises 256-row blocks in VMEM and leaves
// ragged row counts to the XLA reference. This kernel takes any row count,
// and a weight in bf16 or f32 that it reads in f32, as the JAX kernel casts
// `w_ref[:]` to f32 whatever its dtype.
//
// Bound on this card: bytes. Each element is read once and written once
// with four f32 operations in between, far below the ~295 operations per
// byte at which the tensor cores, let alone the f32 units, become the
// limit. At the main paths' shapes (bf16 x):
//   decode, 8 x 4096:       147 KB moved, a bound well under a microsecond,
//                           so latency is what costs;
//   prefill, 2048 x 4096:   33.6 MB moved, 0.0100 ms at 3.35 TB/s;
//   training, 4096 x 2048:  33.6 MB moved, the same.
//
// Design:
//  * a row belongs to a block of `group` warps, the fewest (up to 4) that
//    leave each thread at most 4 16-byte vectors of x: 4 warps at d = 4096
//    bf16, 2 at d = 2048. The sum of squares is reduced with warp shuffles,
//    then, across the group's warps, with one pass through shared memory
//    and one barrier (none when a warp holds the row).
//  * each thread issues all of its loads at once, the weights under its
//    vectors with the first row's x, so their latency overlaps; x is read
//    once into registers and y written once with 16-byte stores.
//  * the grid holds only as many blocks as fit on the card at once; each
//    walks rows blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its
//    weights in registers across them, so w is read once a block, not
//    once a row.
// Measured alternatives (H100 80GB HBM3, 700 W, chip_smoke.time_rms in
// one call): one warp a row (shuffles only) took 0.0036 ms at 8 x 4096 and
// 0.0094 ms at 2048 x 4096 (0.0110 ms without the resident grid), against
// 0.0029 and 0.0085 ms for this design.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 4;   // warps a row at most
constexpr int kVecs = 4;       // 16-byte vectors of x a thread, if it can
constexpr int kMaxVecs = 16;   // 16-byte vectors of x a thread at most
constexpr int kMaxRowVecs = kMaxGroup * 32 * kMaxVecs;  // d <= 16384 bf16

__device__ __forceinline__ uint32_t word(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Element j of 16-byte words `raw`, holding elements of type E, in f32.
template <typename E, int N>
__device__ __forceinline__ float elem(const uint4 (&raw)[N], int j) {
  if constexpr (sizeof(E) == 4) {
    return __uint_as_float(word(raw[j / 4], j % 4));
  } else {
    const uint32_t u = word(raw[j / 8], (j / 2) % 4);
    return __uint_as_float(j % 2 ? u & 0xffff0000u : u << 16);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// A block of `group` warps (blockDim.x = 32 * group) normalises rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; thread i holds vectors i,
// i + blockDim.x, ... of a row, at most V of them.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(32 * kMaxGroup)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ y, long long rows, int d, float eps) {
  constexpr int kElems = 16 / sizeof(T);            // per vector of x
  constexpr int kWBytes = kElems * sizeof(W);       // its weights' bytes
  constexpr int kWWords = (kWBytes + 15) / 16;
  const int nvec = d / kElems;
  const int group = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first_row = blockIdx.x;

  // The weights under this thread's vectors, loaded once for every row,
  // in the same breath as the first row's x.
  uint4 wv[V][kWWords];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    if (vi < nvec) {
      const W* src = w + vi * kElems;
      if constexpr (kWBytes >= 16) {
#pragma unroll
        for (int k = 0; k < kWWords; ++k)
          wv[i][k] = reinterpret_cast<const uint4*>(src)[k];
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
        wv[i][0] = make_uint4(u.x, u.y, 0u, 0u);
      }
    }
  }

  __shared__ float red[2][kMaxGroup];
  int parity = 0;
  for (long long row = first_row; row < rows; row += gridDim.x) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
    uint4 xv[V][1];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = threadIdx.x + i * blockDim.x;
      xv[i][0] = vi < nvec ? xr[vi] : make_uint4(0u, 0u, 0u, 0u);
    }

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        const float f = elem<T>(xv[i], j);
        ss += f * f;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (group > 1) {   // a row over several warps: one pass through shared
      if (lane == 0) red[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < group; ++k) ss += red[parity][k];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = threadIdx.x + i * blockDim.x;
      if (vi < nvec) {
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kElems; ++j)
          o[j] = from_float<T>((elem<T>(xv[i], j) * r) *
                               (1.f + elem<W>(wv[i], j)));
        yr[vi] = out;
      }
    }
  }
}

// Blocks of `threads` threads of `kernel` that fit on the card at once.
template <typename K>
long long resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
}

template <typename T, typename W, int V>
void launch_v(const T* x, const W* w, T* y, long long rows, int d,
              int group, float eps, cudaStream_t s) {
  static long long resident[kMaxGroup + 1] = {};
  auto kernel = rms_norm_kernel<T, W, V>;
  if (resident[group] == 0)
    resident[group] = resident_blocks(kernel, 32 * group);
  const long long blocks = rows < resident[group] ? rows : resident[group];
  kernel<<<static_cast<unsigned>(blocks), 32 * group, 0, s>>>(x, w, y, rows,
                                                               d, eps);
}

template <typename T, typename W>
int launch_w(const void* x, const void* w, void* y, long long rows, int d,
             float eps, cudaStream_t s) {
  const int nvec = d / (16 / static_cast<int>(sizeof(T)));
  // the fewest warps (up to kMaxGroup) that give each thread at most
  // kVecs vectors, then the fewest vectors a thread
  int group = 1;
  while (group < kMaxGroup && nvec > 32 * group * kVecs) group *= 2;
  const int per_thread = (nvec + 32 * group - 1) / (32 * group);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  if (per_thread <= 4) {
    launch_v<T, W, 4>(xp, wp, yp, rows, d, group, eps, s);
  } else if (per_thread <= 8) {
    launch_v<T, W, 8>(xp, wp, yp, rows, d, group, eps, s);
  } else {
    launch_v<T, W, 16>(xp, wp, yp, rows, d, group, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, int w_dtype, cudaStream_t s) {
  if (d / (16 / static_cast<int>(sizeof(T))) > kMaxRowVecs)
    return cudaErrorInvalidValue;
  if (w_dtype == 0)
    return launch_w<T, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  if (w_dtype == 1) return launch_w<T, float>(x, w, y, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype and w_dtype: 0 = bf16, 1 = f32. The wrapper guarantees d % 8 == 0,
// d / (16 / sizeof(T)) <= kMaxRowVecs, 16-byte aligned rows and w.
extern "C" int rtt_rms_norm(const void* x, const void* w, void* y,
                            long long rows, int d, float eps, int dtype,
                            int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL || d <= 0 || d % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, w, y, rows, d, eps, w_dtype, s);
  if (dtype == 1) return launch<float>(x, w, y, rows, d, eps, w_dtype, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
