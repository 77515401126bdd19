// Fused masked segment aggregation over raw field values, in one pass:
// per group g and field f, the sum and count of non-NaN values, the rows of
// the group, and on request min, max (NaN skipped) and the sum of squares.
// NaN is SQL NULL.
//
// Replaces greptimedb_tpu/ops/pallas_segment.py::pallas_fused_segment_agg
// (kernel body _fused_kernel), the reduction of the dense_fused aggregation
// path (query/physical.py::_agg_scan_fused). The TPU kernel assembles a
// [vals | valid | rows | squares] plane in VMEM and multiplies it by a
// one-hot group matrix on the MXU, with min/max as masked row reductions;
// that shape caps G at 4096 and F at 56 (40 with sumsq) and needs finite
// values. Here each row updates its group directly, so none of those caps
// or contracts apply to the kernel itself.
//
// Bound on an H100 (3.35 TB/s): ids read once (4 B a row), the value rows of
// live groups once (F * sizeof(T)), the outputs written once. The
// contention case of the kernel check (8,388,608 rows, F = 1, f32) moves
// 67 MB, at least 20 us. The main path's launches are small (360, 23,040
// and about 120 k live rows); launch overhead, not bandwidth, bounds them.
// The design:
//  - Rows in the dead segment G-1 (WHERE-masked rows, padding) and ids
//    outside [0, G-1) are skipped without reading their values; the output
//    keeps segment G-1 at zero counts and +-inf extremes, since every
//    caller slices it away. The ragged tail is masked in the kernel.
//  - Each warp walks a contiguous tile, 32 rows at a time, one row a lane.
//    NaN masks, sums, counts and squares are built in registers. When all
//    32 rows share a group (time-major rows put ~24,000 consecutive rows in
//    one minute bucket), the warp reduces with shuffles and one lane issues
//    one atomic per output cell; otherwise each lane updates its own group.
//  - min and max use a compare-and-swap loop on the value's bits that only
//    runs while the value would improve the cell. Empty groups stay at
//    +inf / -inf.
//  - When the accumulators of all G groups fit in 48 KB of shared memory,
//    each block privatizes them and flushes touched cells once.
// Counts and rows are exact int32. Atomics change the order of the float
// additions from run to run, so sums agree with a sequential sum to a
// tolerance, while counts, rows, min and max agree exactly.
#include "segment_common.cuh"

namespace gtpu {

template <typename T>
struct Planes {
  T* sum;    // [g, f]
  int* cnt;  // [g, f]
  int* rows; // [g]
  T* mn;     // [g, f] or null
  T* mx;     // [g, f] or null
  T* sq;     // [g, f] or null
};

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
fused_agg_kernel(const T* __restrict__ vals, const int* __restrict__ ids,
                 long long n, int f, int g, Planes<T> out,
                 long long rows_per_warp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cells = g * f;
  const bool want_min = out.mn != nullptr;
  const bool want_max = out.mx != nullptr;
  const bool want_sq = out.sq != nullptr;
  Planes<T> acc = out;
  if (kShared) {
    // layout: sum | sq | mn | mx (T, cells each) | cnt (cells) | rows (g)
    T* t = reinterpret_cast<T*>(smem_raw);
    acc.sum = t;
    acc.sq = want_sq ? t + cells : nullptr;
    acc.mn = want_min ? t + 2 * cells : nullptr;
    acc.mx = want_max ? t + 3 * cells : nullptr;
    acc.cnt = reinterpret_cast<int*>(t + 4 * cells);
    acc.rows = acc.cnt + cells;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      acc.sum[i] = T(0);
      acc.cnt[i] = 0;
      if (want_sq) acc.sq[i] = T(0);
      if (want_min) acc.mn[i] = pos_inf<T>();
      if (want_max) acc.mx[i] = -pos_inf<T>();
    }
    for (int i = threadIdx.x; i < g; i += blockDim.x) acc.rows[i] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long t0 = warp * rows_per_warp;
  const long long t1 = min(t0 + rows_per_warp, n);
  const unsigned dead = (unsigned)(g - 1);
  const T inf = pos_inf<T>();
  for (long long base = t0; base < t1; base += 32) {
    const long long r = base + lane;
    const int id = r < t1 ? ids[r] : -1;
    const bool live = (unsigned)id < dead;
    const int id0 = __shfl_sync(kFull, id, 0);
    if (__all_sync(kFull, id == id0)) {
      if (!live) continue;  // the whole warp sits in the dead segment
      if (lane == 0) atomicAdd(acc.rows + id0, 32);
      const T* row = vals + r * f;
      const long long cell0 = (long long)id0 * f;
      for (int c = 0; c < f; ++c) {
        const T v = row[c];
        const bool ok = !isnan(v);
        const T z = ok ? v : T(0);
        const T s = warp_sum(z);
        const int k = __popc(__ballot_sync(kFull, ok));
        T q = T(0), lo = inf, hi = -inf;
        if (want_sq) q = warp_sum(z * z);
        if (want_min) lo = warp_min(ok ? v : inf);
        if (want_max) hi = warp_max(ok ? v : -inf);
        if (lane == 0 && k > 0) {
          const long long cell = cell0 + c;
          atomicAdd(acc.sum + cell, s);
          atomicAdd(acc.cnt + cell, k);
          if (want_sq) atomicAdd(acc.sq + cell, q);
          if (want_min) atomic_min(acc.mn + cell, lo);
          if (want_max) atomic_max(acc.mx + cell, hi);
        }
      }
    } else if (live) {
      atomicAdd(acc.rows + id, 1);
      const T* row = vals + r * f;
      const long long cell0 = (long long)id * f;
      for (int c = 0; c < f; ++c) {
        const T v = row[c];
        if (isnan(v)) continue;
        const long long cell = cell0 + c;
        atomicAdd(acc.sum + cell, v);
        atomicAdd(acc.cnt + cell, 1);
        if (want_sq) atomicAdd(acc.sq + cell, v * v);
        if (want_min) atomic_min(acc.mn + cell, v);
        if (want_max) atomic_max(acc.mx + cell, v);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      if (acc.cnt[i] == 0) continue;
      atomicAdd(out.sum + i, acc.sum[i]);
      atomicAdd(out.cnt + i, acc.cnt[i]);
      if (want_sq) atomicAdd(out.sq + i, acc.sq[i]);
      if (want_min) atomic_min(out.mn + i, acc.mn[i]);
      if (want_max) atomic_max(out.mx + i, acc.mx[i]);
    }
    for (int i = threadIdx.x; i < g; i += blockDim.x) {
      if (acc.rows[i] != 0) atomicAdd(out.rows + i, acc.rows[i]);
    }
  }
}

template <typename T>
cudaError_t launch_fused(const void* vals, const void* ids, long long n, int f,
                         int g, Planes<T> out, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const size_t cells = (size_t)g * f;
  const size_t smem = cells * (4 * sizeof(T) + sizeof(int)) + g * sizeof(int);
  const bool shared = smem <= kSmemBytes;
  const Geometry geo = geometry(n, shared ? 4 : 8);
  if (shared) {
    fused_agg_kernel<T, true><<<geo.blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(vals), static_cast<const int*>(ids), n, f, g,
        out, geo.rows_per_warp);
  } else {
    fused_agg_kernel<T, false><<<geo.blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(vals), static_cast<const int*>(ids), n, f, g,
        out, geo.rows_per_warp);
  }
  return cudaGetLastError();
}

}  // namespace gtpu

// C entry, bound with ctypes. On entry sum/sq hold zeros, cnt/rows zeros,
// mn +inf and mx -inf; mn, mx and sq may be null when not wanted.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gtpu_fused_segment_agg(const void* vals, const void* ids,
                                      long long n, int f, int g, int is_double,
                                      void* sum, void* cnt, void* rows,
                                      void* mn, void* mx, void* sq,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_double) {
    gtpu::Planes<double> p{static_cast<double*>(sum), static_cast<int*>(cnt),
                           static_cast<int*>(rows), static_cast<double*>(mn),
                           static_cast<double*>(mx), static_cast<double*>(sq)};
    err = gtpu::launch_fused<double>(vals, ids, n, f, g, p, s);
  } else {
    gtpu::Planes<float> p{static_cast<float*>(sum), static_cast<int*>(cnt),
                          static_cast<int*>(rows), static_cast<float*>(mn),
                          static_cast<float*>(mx), static_cast<float*>(sq)};
    err = gtpu::launch_fused<float>(vals, ids, n, f, g, p, s);
  }
  return (int)err;
}
