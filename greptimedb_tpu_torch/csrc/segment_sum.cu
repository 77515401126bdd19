// Dense segment sum: out[g, :] = sum of plane[i, :] over rows with ids[i] == g.
//
// Replaces greptimedb_tpu/ops/pallas_segment.py::pallas_dense_segment_sum
// (kernel body _kernel), the reduction of the dense prepared aggregation
// path (query/physical.py::_agg_scan_prepared). The TPU kernel is a one-hot
// [G, Nb] @ plane[Nb, W] matmul because that is the shape the MXU runs; it
// brings a VMEM cap of G <= 4096, an f32 multi-pass at HIGHEST precision and
// a finite-values contract (0 * inf poisons every group). None of that is
// carried over: this kernel adds each row straight into its group.
//
// Bound on an H100 (3.35 TB/s): the ids are read once (4 B a row), the plane
// rows of live groups once (W * sizeof(T) a row), the output written once.
// The headline double_groupby_all shape (17.28 M rows, W = 11, f32) moves
// about 829 MB, so no kernel can take less than about 0.25 ms. The design
// keeps to that bound as follows:
//  - Rows in the dead segment G-1 (masked by WHERE, padding) are skipped
//    without reading their plane row; every caller slices that segment
//    away, so the output keeps it at zero. Ids outside [0, G-1) are skipped
//    the same way, and the ragged tail is masked in the kernel.
//  - Each warp walks a contiguous tile of rows, 32 at a time, one row a
//    lane. When all 32 rows fall in one group (time-major scans put long
//    runs of rows in one time bucket), the warp sums each column with
//    shuffles and issues one atomic per column instead of 32.
//  - When G * W accumulators fit in 48 KB of shared memory, each block
//    privatizes them and flushes non-zero cells with one global atomic
//    each; otherwise the adds go straight to the output, which stays
//    resident in the 50 MB L2 (48,013 x 11 x 4 B is 2.1 MB).
// Atomics make the order of the additions change from run to run, so f32
// sums agree with a sequential sum to a tolerance, not bit for bit.
#include "segment_common.cuh"

namespace gtpu {

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ plane, const int* __restrict__ ids,
                   T* __restrict__ out, long long n, int w, int g,
                   long long rows_per_warp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = kShared ? reinterpret_cast<T*>(smem_raw) : out;
  const int cells = g * w;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = T(0);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long t0 = warp * rows_per_warp;
  const long long t1 = min(t0 + rows_per_warp, n);
  const unsigned dead = (unsigned)(g - 1);
  for (long long base = t0; base < t1; base += 32) {
    const long long r = base + lane;
    const int id = r < t1 ? ids[r] : -1;
    const bool live = (unsigned)id < dead;
    const int id0 = __shfl_sync(kFull, id, 0);
    if (__all_sync(kFull, id == id0)) {
      if (!live) continue;  // the whole warp sits in the dead segment
      const T* row = plane + r * w;
      T* cell = acc + (long long)id0 * w;
      for (int c = 0; c < w; ++c) {
        const T s = warp_sum(row[c]);
        if (lane == 0) atomicAdd(cell + c, s);
      }
    } else if (live) {
      const T* row = plane + r * w;
      T* cell = acc + (long long)id * w;
      for (int c = 0; c < w; ++c) atomicAdd(cell + c, row[c]);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const T v = acc[i];
      if (v != T(0)) atomicAdd(out + i, v);
    }
  }
}

template <typename T>
cudaError_t launch_segment_sum(const void* plane, const void* ids, void* out,
                               long long n, int w, int g,
                               cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = (size_t)g * w * sizeof(T);
  const bool shared = smem <= kSmemBytes;
  const Geometry geo = geometry(n, shared ? 4 : 8);
  if (shared) {
    segment_sum_kernel<T, true><<<geo.blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(plane), static_cast<const int*>(ids),
        static_cast<T*>(out), n, w, g, geo.rows_per_warp);
  } else {
    segment_sum_kernel<T, false><<<geo.blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(plane), static_cast<const int*>(ids),
        static_cast<T*>(out), n, w, g, geo.rows_per_warp);
  }
  return cudaGetLastError();
}

}  // namespace gtpu

// C entry, bound with ctypes. `out` must hold g * w zeros on entry.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gtpu_segment_sum(const void* plane, const void* ids, void* out,
                                long long n, int w, int g, int is_double,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double ? gtpu::launch_segment_sum<double>(plane, ids, out, n, w, g, s)
                : gtpu::launch_segment_sum<float>(plane, ids, out, n, w, g, s);
  return (int)err;
}
