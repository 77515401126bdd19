// Shared pieces of the segment-reduction kernels: launch geometry, warp
// reductions and float atomics that the CUDA runtime does not provide.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gtpu {

constexpr int kThreads = 256;              // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Privatized accumulators stay under the 48 KB a block may take without
// the dynamic-shared-memory opt-in, so several blocks still share an SM.
constexpr size_t kSmemBytes = 48 * 1024;

// Each warp owns one contiguous tile of rows, at least `min_rows` of them
// (rounded up to 32), and as few as spread the call over every SM's
// `blocks_per_sm` blocks. Contiguous tiles keep warps that run at the same
// moment on different parts of a time-major scan, so they rarely hit the
// same group's accumulator at once.
struct Geometry {
  int blocks;
  long long rows_per_warp;
};

inline Geometry geometry(long long n, int blocks_per_sm, long long min_rows) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  long long max_warps = (long long)sms * blocks_per_sm * kWarps;
  long long per = (n + max_warps - 1) / max_warps;
  if (per < min_rows) per = min_rows;
  per = (per + 31) / 32 * 32;
  long long warps = (n + per - 1) / per;
  Geometry g;
  g.blocks = (int)((warps + kWarps - 1) / kWarps);
  if (g.blocks < 1) g.blocks = 1;
  g.rows_per_warp = per;
  return g;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// NaN never enters: callers feed the identity (+inf) for NULL lanes.
template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    T u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    T u = __shfl_xor_sync(kFull, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// min/max by compare-and-swap on the value's bits. The loop only runs
// while `v` would still improve the cell, so an extreme that is already
// in place costs one read. NaN never reaches these (callers skip it).
__device__ __forceinline__ void atomic_min(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *a;
  while (v < __int_as_float(old)) {
    int seen = atomicCAS(a, old, __float_as_int(v));
    if (seen == old) break;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *a;
  while (v > __int_as_float(old)) {
    int seen = atomicCAS(a, old, __float_as_int(v));
    if (seen == old) break;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_min(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (v < __longlong_as_double((long long)old)) {
    unsigned long long seen =
        atomicCAS(a, old, (unsigned long long)__double_as_longlong(v));
    if (seen == old) break;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_max(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (v > __longlong_as_double((long long)old)) {
    unsigned long long seen =
        atomicCAS(a, old, (unsigned long long)__double_as_longlong(v));
    if (seen == old) break;
    old = seen;
  }
}

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

}  // namespace gtpu
