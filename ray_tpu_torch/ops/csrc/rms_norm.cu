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
// limit. At the serving path's shapes (llama3-8b, d = 4096, bf16):
//   decode, 8 rows:       147 KB moved, a bound well under a microsecond,
//                         so the launch itself is what costs;
//   prefill, 2048 rows:   33.6 MB moved, bandwidth-bound.
//
// Design: one 256-thread block per row. Each thread reads its share of
// the row once, as 16-byte vectors kept in registers (at most kMaxVecs of
// them), sums the squares in f32 with warp shuffles and one pass through
// shared memory across the warps, then scales the registers and writes
// the row with 16-byte stores. x never makes a second trip through
// device memory. The launch cost of the decode shape is left to a later
// change (fusing the norm into its neighbours, or a CUDA graph).
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecs = 8;  // 16-byte vectors per thread: d <= 16384 bf16

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

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

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The N weights starting at w, in f32; N is 4 or 8 (one 16-byte vector
// of x), so an f32 weight is one or two float4 loads and a bf16 weight one
// 8- or 16-byte load.
template <int N>
__device__ __forceinline__ void load_weights(const float* w, float* out) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 f = reinterpret_cast<const float4*>(w)[j];
    out[4 * j + 0] = f.x;
    out[4 * j + 1] = f.y;
    out[4 * j + 2] = f.z;
    out[4 * j + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void load_weights(const __nv_bfloat16* w,
                                             float* out) {
  __align__(16) __nv_bfloat16 buf[N];
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(w);
  } else {
    *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(w);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = __bfloat162float(buf[j]);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ y, int d, float eps) {
  constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte vector
  const int nvec = d / kElems;
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);

  uint4 buf[kMaxVecs];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = threadIdx.x + i * kThreads;
    if (vi < nvec) {
      buf[i] = xr[vi];
      const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        const float f = to_float(e[j]);
        ss += f * f;
      }
    }
  }
  __shared__ float red[kThreads / 32];
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = threadIdx.x + i * kThreads;
    if (vi < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[i]);
      float ws[kElems];
      load_weights<kElems>(w + vi * kElems, ws);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < kElems; ++j)
        o[j] = from_float<T>((to_float(e[j]) * r) * (1.f + ws[j]));
      yr[vi] = out;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, int w_dtype, cudaStream_t s) {
  if (d / (16 / static_cast<int>(sizeof(T))) > kThreads * kMaxVecs)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rows));
  if (w_dtype == 0) {
    rms_norm_kernel<T, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<T*>(y), d, eps);
  } else if (w_dtype == 1) {
    rms_norm_kernel<T, float><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(y), d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype and w_dtype: 0 = bf16, 1 = f32. The wrapper guarantees d % 8 == 0,
// d / (16 / sizeof(T)) <= kThreads * kMaxVecs, 16-byte aligned rows and w.
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
