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
// 67 MB, at least 20 us. The main path's launches are small (1,024 to
// 131,072 rows a block); launch and host overhead, not bandwidth, bounds
// them. The design:
//  - One call is one output buffer (carve() below) and two launches on the
//    caller's stream: fused_init_kernel writes the identities, then
//    fused_agg_kernel aggregates. The caller allocates and fills nothing.
//  - A lane is live when its row lies in the warp's tile and its id in
//    [0, G-1). Dead lanes (the dead segment G-1 of WHERE-masked rows and
//    padding, ids out of range, the ragged tail) read no values and enter
//    the reductions as identities; a warp with no live lane skips.
//  - Each warp walks a contiguous tile, 32 rows at a time, one row a lane.
//    When every live lane holds one id (time-major rows put ~24,000
//    consecutive rows in one minute bucket), the warp reduces with
//    butterfly shuffles and issues one atomic per output cell: with F > 1
//    lane j issues field j's, so the fields' atomics run side by side
//    rather than as one lane's chain; with F = 1 the first live lane
//    issues them. Otherwise the lanes group by id (__match_any_sync) and
//    each group reduces among its lanes in at most five shuffle rounds
//    (E. Westphal, "Voting and Shuffling to Optimize Atomic Operations",
//    NVIDIA Developer Blog, 2015); the group's lowest lane issues the
//    atomics. So a warp issues distinct ids x F x planes atomics, not live
//    lanes x F x planes: on sm_90 a float atomicAdd into shared memory is a
//    compare-and-swap loop, and lanes of one id race for one cell.
//  - min and max use a compare-and-swap loop on the value's bits that only
//    runs while the value would improve the cell.
//  - When the accumulators of all G groups fit in 48 KB of shared memory,
//    each block privatizes them and flushes touched cells once with global
//    atomics; otherwise every group's atomics go to global memory. Both
//    rely on the identities written by fused_init_kernel.
//  - Tiles are sized so that small calls spread over the SMs (geometry() in
//    segment_common.cuh), while a block's rows stay at least 4x its
//    privatized cells, so init and flush stay a small share of its work.
// Counts and rows are exact int32. Atomics change the order of the float
// additions from run to run, so sums agree with a sequential sum to a
// tolerance, while counts, rows, min and max agree exactly.
#include <atomic>

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

constexpr int kWantMin = 1, kWantMax = 2, kWantSumsq = 4;

// Each group of peer lanes (lanes with one id) reduces its partial sums,
// squares and extremes into its lowest lane, after Westphal's reduce_peers:
// in round k, the lanes of even rank in the group add the partial of the
// next lane still in the group; lanes of odd rank are then done. At most
// five rounds for 32 lanes. Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ void peer_reduce(unsigned peers, int lane, T& s,
                                            T& q, T& lo, T& hi, bool want_sq,
                                            bool want_min, bool want_max) {
  unsigned rank = __popc(peers & ((1u << lane) - 1));
  unsigned rest = peers & (0xfffffffeu << lane);  // peers above this lane
  while (__any_sync(kFull, rest)) {
    const int next = __ffs(rest);  // 1 + the next peer's lane; 0 when none
    const T ts = __shfl_sync(kFull, s, next - 1);
    const T tq = want_sq ? __shfl_sync(kFull, q, next - 1) : T(0);
    const T tlo = want_min ? __shfl_sync(kFull, lo, next - 1) : T(0);
    const T thi = want_max ? __shfl_sync(kFull, hi, next - 1) : T(0);
    if (next) {
      s += ts;
      if (want_sq) q += tq;
      if (want_min) lo = tlo < lo ? tlo : lo;
      if (want_max) hi = thi > hi ? thi : hi;
    }
    rest &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

template <typename T>
__device__ __forceinline__ void add_cell(const Planes<T>& acc, long long cell,
                                         T s, int k, T q, T lo, T hi) {
  atomicAdd(acc.sum + cell, s);
  atomicAdd(acc.cnt + cell, k);
  if (acc.sq) atomicAdd(acc.sq + cell, q);
  if (acc.mn) atomic_min(acc.mn + cell, lo);
  if (acc.mx) atomic_max(acc.mx + cell, hi);
}

// kShared: accumulators privatized in shared memory. kFieldLanes (F > 1):
// in the uniform branch lane j issues field j's atomics, so the fields'
// atomics run side by side; with F = 1 the first live lane issues them.
template <typename T, bool kShared, bool kFieldLanes>
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
    // layout: sum | sq? | mn? | mx? (T, cells each) | cnt (cells) | rows (g)
    T* t = reinterpret_cast<T*>(smem_raw);
    acc.sum = t;
    t += cells;
    if (want_sq) {
      acc.sq = t;
      t += cells;
    }
    if (want_min) {
      acc.mn = t;
      t += cells;
    }
    if (want_max) {
      acc.mx = t;
      t += cells;
    }
    acc.cnt = reinterpret_cast<int*>(t);
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
  const unsigned below = (1u << lane) - 1;  // the lanes under this one
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long t0 = warp * rows_per_warp;
  const long long t1 = min(t0 + rows_per_warp, n);
  const unsigned dead = (unsigned)(g - 1);
  const T inf = pos_inf<T>();
  for (long long base = t0; base < t1; base += 32) {
    const long long r = base + lane;
    const int id = r < t1 ? ids[r] : -1;
    const bool live = (unsigned)id < dead;
    const unsigned live_mask = __ballot_sync(kFull, live);
    if (live_mask == 0) continue;  // every row masked, or past the tile
    const int first = __ffs(live_mask) - 1;
    const int id0 = __shfl_sync(kFull, id, first);
    const T* row = vals + r * f;
    if (__all_sync(kFull, !live || id == id0)) {
      // one group holds every live lane: butterfly reductions, which leave
      // each field's totals in every lane
      if (lane == first) atomicAdd(acc.rows + id0, __popc(live_mask));
      const long long cell0 = (long long)id0 * f;
      if (kFieldLanes) {
        // lane j keeps field c0 + j's totals and issues its atomics
        for (int c0 = 0; c0 < f; c0 += 32) {
          const int width = min(32, f - c0);
          T ms = T(0), mq = T(0), mlo = inf, mhi = -inf;
          int mk = 0;
          for (int j = 0; j < width; ++j) {
            const T v = live ? row[c0 + j] : T(0);
            const bool ok = live && !isnan(v);
            const T z = ok ? v : T(0);
            const T s = warp_sum(z);
            const int k = __popc(__ballot_sync(kFull, ok));
            T q = T(0), lo = inf, hi = -inf;
            if (want_sq) q = warp_sum(z * z);
            if (want_min) lo = warp_min(ok ? v : inf);
            if (want_max) hi = warp_max(ok ? v : -inf);
            if (lane == j) {
              ms = s;
              mk = k;
              mq = q;
              mlo = lo;
              mhi = hi;
            }
          }
          if (lane < width && mk > 0)
            add_cell(acc, cell0 + c0 + lane, ms, mk, mq, mlo, mhi);
        }
      } else {
        for (int c = 0; c < f; ++c) {
          const T v = live ? row[c] : T(0);
          const bool ok = live && !isnan(v);
          const T z = ok ? v : T(0);
          const T s = warp_sum(z);
          const int k = __popc(__ballot_sync(kFull, ok));
          T q = T(0), lo = inf, hi = -inf;
          if (want_sq) q = warp_sum(z * z);
          if (want_min) lo = warp_min(ok ? v : inf);
          if (want_max) hi = warp_max(ok ? v : -inf);
          if (lane == first && k > 0)
            add_cell(acc, cell0 + c, s, k, q, lo, hi);
        }
      }
    } else {
      // mixed ids: each group of peers reduces into its lowest lane
      const unsigned peers = __match_any_sync(kFull, live ? id : -1);
      const bool leader = live && (peers & below) == 0;
      if (leader) atomicAdd(acc.rows + id, __popc(peers));
      const long long cell0 = (long long)id * f;
      for (int c = 0; c < f; ++c) {
        const T v = live ? row[c] : T(0);
        const bool ok = live && !isnan(v);
        const unsigned okm = __ballot_sync(kFull, ok) & peers;
        T s = ok ? v : T(0);
        T q = s * s, lo = ok ? v : inf, hi = ok ? v : -inf;
        peer_reduce(peers, lane, s, q, lo, hi, want_sq, want_min, want_max);
        if (leader && okm) add_cell(acc, cell0 + c, s, __popc(okm), q, lo, hi);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      if (acc.cnt[i] == 0) continue;
      add_cell(out, i, acc.sum[i], acc.cnt[i], want_sq ? acc.sq[i] : T(0),
               want_min ? acc.mn[i] : T(0), want_max ? acc.mx[i] : T(0));
    }
    for (int i = threadIdx.x; i < g; i += blockDim.x) {
      if (acc.rows[i] != 0) atomicAdd(out.rows + i, acc.rows[i]);
    }
  }
}

// The identities: 0 sums, counts and rows, +inf min, -inf max, over all G
// rows, the dead segment included. Both branches of fused_agg_kernel add
// into these with global atomics, so this runs first on the same stream.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_init_kernel(Planes<T> out, long long cells, int g) {
  const T inf = pos_inf<T>();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cells; i += step) {
    out.sum[i] = T(0);
    out.cnt[i] = 0;
    if (out.sq) out.sq[i] = T(0);
    if (out.mn) out.mn[i] = inf;
    if (out.mx) out.mx[i] = -inf;
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < g;
       i += step)
    out.rows[i] = 0;
}

inline size_t align16(size_t nbytes) { return (nbytes + 15) & ~size_t(15); }

// The planes of the caller's one output buffer (the same rule as
// ops/segment_kernels.py::_layout): first the value-typed planes, in the
// order sum | sumsq? | min? | max?, g*f each; then the int32 planes, count
// (g*f) and rows (g). Every plane starts 16-byte aligned.
template <typename T>
Planes<T> carve(void* out, int f, int g, int flags) {
  const size_t cells = (size_t)g * f;
  const size_t vplane = align16(cells * sizeof(T));
  char* p = static_cast<char*>(out);
  Planes<T> o;
  o.sum = reinterpret_cast<T*>(p);
  p += vplane;
  o.sq = (flags & kWantSumsq) ? reinterpret_cast<T*>(p) : nullptr;
  if (o.sq) p += vplane;
  o.mn = (flags & kWantMin) ? reinterpret_cast<T*>(p) : nullptr;
  if (o.mn) p += vplane;
  o.mx = (flags & kWantMax) ? reinterpret_cast<T*>(p) : nullptr;
  if (o.mx) p += vplane;
  o.cnt = reinterpret_cast<int*>(p);
  o.rows = reinterpret_cast<int*>(p + align16(cells * sizeof(int)));
  return o;
}

// The least rows a warp's tile holds (a multiple of 32), chosen by
// measurement on the main path's shapes (PERF.md, K2 geometry).
constexpr long long kMinRowsPerWarp = 64;
// At most 8 blocks an SM: 8 x 256 threads fill an SM's 2,048. Fewer where
// the kernel's shared memory or registers allow fewer, so that a call's
// blocks are all resident at once. Each warp's 32-row steps form a
// dependent chain (ids, values, shuffles, one lane's atomics), so more,
// shorter tiles finish sooner (PERF.md, K2 geometry).
constexpr int kBlocksPerSm = 8;
// Shared memory is allocated to a block in 128-byte units, so launches
// round their dynamic size up to one, and occupancy is cached per unit.
constexpr size_t kSmemUnit = 128;

template <typename T>
using AggKernel = void (*)(const T*, const int*, long long, int, int,
                           Planes<T>, long long);

template <typename T>
struct Plan {
  AggKernel<T> kernel;
  Geometry geo;
  size_t smem;       // privatized accumulators, bytes
  bool shared;       // privatized: smem fits in kSmemBytes
  size_t dyn_smem;   // dynamic shared memory of the launch
  int blocks_an_sm;  // resident blocks an SM the tiles are sized for
  cudaError_t err;   // of the occupancy query
};

// The kernel instance and its resident blocks an SM (<= kBlocksPerSm) at
// `dyn_smem` bytes, a multiple of kSmemUnit. The runtime is asked once for
// each instance and size; the answer is kept for the process (one card).
template <typename T, bool kShared, bool kFieldLanes>
void select_kernel(Plan<T>& p) {
  static std::atomic<int> cache[kSmemBytes / kSmemUnit + 1];
  p.kernel = fused_agg_kernel<T, kShared, kFieldLanes>;
  p.err = cudaSuccess;
  std::atomic<int>& slot = cache[p.dyn_smem / kSmemUnit];
  int blocks = slot.load(std::memory_order_relaxed);
  if (blocks == 0) {
    int per_sm = 0;
    p.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, p.kernel, kThreads, p.dyn_smem);
    if (p.err != cudaSuccess) return;
    blocks = per_sm < 1 ? 1 : per_sm > kBlocksPerSm ? kBlocksPerSm : per_sm;
    slot.store(blocks, std::memory_order_relaxed);
  }
  p.blocks_an_sm = blocks;
}

template <typename T>
Plan<T> plan_fused(long long n, int f, int g, int flags) {
  const size_t cells = (size_t)g * f;
  const int planes = 1 + !!(flags & kWantSumsq) + !!(flags & kWantMin) +
                     !!(flags & kWantMax);
  Plan<T> p;
  p.smem = cells * (planes * sizeof(T) + sizeof(int)) + g * sizeof(int);
  p.shared = p.smem <= kSmemBytes;
  p.dyn_smem = p.shared ? (p.smem + kSmemUnit - 1) / kSmemUnit * kSmemUnit
                        : 0;
  p.blocks_an_sm = 1;
  const bool lanes = f > 1;
  if (p.shared && lanes)
    select_kernel<T, true, true>(p);
  else if (p.shared)
    select_kernel<T, true, false>(p);
  else if (lanes)
    select_kernel<T, false, true>(p);
  else
    select_kernel<T, false, false>(p);
  // a block's rows at least 4x its privatized cells
  long long floor_rows = kMinRowsPerWarp;
  if (p.shared) {
    const long long need = (4 * (long long)(cells + g) + kWarps - 1) / kWarps;
    if (need > floor_rows) floor_rows = need;
  }
  p.geo = geometry(n, p.blocks_an_sm, floor_rows);
  return p;
}

// Two launches on the caller's stream: the identities, then the
// aggregation (none for n = 0). Returns the first error of the two.
template <typename T>
cudaError_t launch_fused(const void* vals, const void* ids, long long n, int f,
                         int g, int flags, void* buf, cudaStream_t stream) {
  const Planes<T> out = carve<T>(buf, f, g, flags);
  const long long cells = (long long)g * f;
  const long long span = cells > g ? cells : g;
  long long init_blocks = (span + kThreads - 1) / kThreads;
  if (init_blocks > 1024) init_blocks = 1024;
  fused_init_kernel<T><<<(int)init_blocks, kThreads, 0, stream>>>(out, cells,
                                                                  g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return err;
  const Plan<T> p = plan_fused<T>(n, f, g, flags);
  if (p.err != cudaSuccess) return p.err;
  p.kernel<<<p.geo.blocks, kThreads, p.dyn_smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(ids), n, f, g, out,
      p.geo.rows_per_warp);
  return cudaGetLastError();
}

}  // namespace gtpu

// C entry, bound with ctypes. `out` is the base of one uninitialized
// buffer in carve()'s layout; flags: bit 0 min, bit 1 max, bit 2 sumsq.
// Returns the cudaError_t of the first failing launch (0 on success).
extern "C" int gtpu_fused_segment_agg(const void* vals, const void* ids,
                                      long long n, int f, int g, int is_double,
                                      int flags, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_double
                   ? gtpu::launch_fused<double>(vals, ids, n, f, g, flags, out,
                                                s)
                   : gtpu::launch_fused<float>(vals, ids, n, f, g, flags, out,
                                               s));
}

// Inspection entry for chip_smoke.py; the port never calls it.
// The launch plan of a call: blocks, rows a warp, privatized bytes,
// whether the accumulators are privatized (1) or global (0), and the
// resident blocks an SM the tiles are sized for.
extern "C" int gtpu_fused_segment_agg_plan(long long n, int f, int g,
                                           int is_double, int flags,
                                           long long* out) {
  const auto fill = [&](const auto& p) {
    out[0] = p.geo.blocks;
    out[1] = p.geo.rows_per_warp;
    out[2] = (long long)p.smem;
    out[3] = p.shared;
    out[4] = p.blocks_an_sm;
    return (int)p.err;
  };
  return is_double ? fill(gtpu::plan_fused<double>(n, f, g, flags))
                   : fill(gtpu::plan_fused<float>(n, f, g, flags));
}
