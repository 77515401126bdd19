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
// The headline double_groupby_all block ([8.4 M x 11] f32, G = 48,013) moves
// about 370 MB, so no kernel can take less than about 0.11 ms. Per-row
// global atomics cannot get near that: a time-major scan puts a different
// group on every row, and 11 atomics a row run at the pace of L2's atomic
// units. The design keeps the adds on the SM instead:
//  - Windows. Each block privatizes the accumulators of a window of ids
//    [lo, lo + cap) in shared memory, sized to the card's opt-in limit
//    (227 KB a block on an H100, read from the device, not hard-coded), so
//    one hour bucket of 4,000 hosts x 11 columns fits. Persistent blocks,
//    one an SM when the window is large, each walk one long contiguous tile
//    of rows chunk by chunk. The block knows each chunk's live-id min and
//    max before it adds the chunk; when they leave the window, the block
//    flushes the cells it touched (one global atomic per non-zero cell) and
//    re-bases lo at the chunk's min. A chunk whose ids span more than the
//    window (host-major ids) keeps the window where its min lies and adds
//    the rows above it straight to global memory: the same kernel, right
//    for any id order. Where W * sizeof(T) leaves room for fewer than
//    kWindowIds ids, the columns split into groups over gridDim.y; each
//    group stages whole rows (L2 serves the groups after the first) and
//    adds only its own columns.
//  - Staging. A chunk of rows is one contiguous run of bytes, and so are its
//    ids. One thread copies each with a TMA bulk copy (cp.async.bulk) that
//    completes on an mbarrier, into a ring of kStages chunks, so that three
//    chunks are in flight while one is added; the ids run one chunk ahead.
//    With one block an SM, every instruction that all warps repeat per
//    chunk costs as much as the adds, so the per-chunk bookkeeping is kept
//    to one barrier, one bulk copy and a summary reduced across lanes.
//  - Runs. The summary also says whether a chunk's live ids strictly
//    increase row by row, as a time-major scan's do: then no two rows share
//    a cell, and each thread adds its row's columns to the window with
//    plain loads and stores. Any other chunk goes to threads that each walk
//    kRun consecutive rows of one column and keep a running sum in a
//    register while the id stays the same, across chunks too; they add to
//    the window (with an atomic) only when the id changes. Run-major ids
//    (a date_bin-major scan) give a handful of adds a chunk.
// Rows in the dead segment G-1 and ids outside [0, G-1) are staged with
// their chunk but never added, so the output keeps them at zero. A plane or
// id array that is not 16-byte aligned, or rows too wide for the ring, take
// the same kernel without staging: it reads rows and ids from global
// memory where it would read them from the ring.
// Atomics make the order of the additions change from run to run, so f32
// sums agree with a sequential sum to a tolerance, not bit for bit.
#include <algorithm>
#include <climits>
#include <cstdint>

#include "segment_common.cuh"

namespace gtpu {
namespace k1 {

constexpr int kBlockThreads = 512;  // 16 warps a block
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kMaxRows = 256;       // rows in a chunk, at most
constexpr int kGoodRows = 128;      // rows a chunk should have
constexpr int kMinRows = 32;        // and must have
constexpr int kStages = 4;          // chunks of plane rows in the ring
constexpr int kIdSlots = kStages + 1;  // ids run one chunk ahead
constexpr int kRun = 8;             // consecutive rows a thread sums
// ids the window aims to hold: one hour bucket of a 4,000-host fleet
// (double_groupby_all's id range per hour is 4,001)
constexpr int kWindowIds = 4096;
// mbarriers, then the two chunk summaries ([2][3][kBlockWarps] ints)
constexpr size_t kHeadBytes = 128 + 2 * 3 * kBlockWarps * sizeof(int);
static_assert(kMaxRows <= kBlockThreads, "one row a thread in the summary");
static_assert(kBlockWarps < 32 && (kBlockWarps & (kBlockWarps - 1)) == 0,
              "a warp's lanes reduce the per-warp summaries");
static_assert((kStages + kIdSlots) * 8 <= 128, "mbarriers fit the head");

// What the launches did, summed over blocks: window re-bases, global
// atomics that flushed window cells, sums added straight to global memory
// because their id lay outside the window, chunks with a live row, and
// those of them whose ids strictly increased (added without atomics).
__device__ unsigned long long stats[5];

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive once and expect `bytes` from the bulk copies that follow.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared memory a block needs besides its window: the mbarriers and chunk
// summaries, and, when it stages, the rings of plane rows and ids.
__host__ __device__ inline size_t ring_bytes(int rows, int w, size_t es,
                                             bool staged) {
  if (!staged) return kHeadBytes;
  return kHeadBytes + (size_t)kStages * rows * w * es +
         (size_t)kIdSlots * rows * sizeof(int);
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kBlockThreads)
window_sum_kernel(const T* __restrict__ plane, const int* __restrict__ ids,
                  T* __restrict__ out, long long n, int w, int g, int wc_max,
                  int cap, int rows, long long tile_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* plane_bar = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* id_bar = plane_bar + kStages;
  int* red = reinterpret_cast<int*>(smem_raw + 128);
  T* win = reinterpret_cast<T*>(smem_raw + kHeadBytes);
  T* stage = reinterpret_cast<T*>(
      smem_raw + kHeadBytes + align16((size_t)cap * wc_max * sizeof(T)));
  int* sids = reinterpret_cast<int*>(stage + (size_t)kStages * rows * w);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c0 = blockIdx.y * wc_max;
  const int wc = min(wc_max, w - c0);
  const unsigned dead = (unsigned)(g - 1);
  const long long r_begin = (long long)blockIdx.x * tile_rows;
  const long long r_end = min(r_begin + tile_rows, n);
  const int nchunks =
      r_end > r_begin ? (int)((r_end - r_begin + rows - 1) / rows) : 0;
  // this thread's share of a chunk, fixed for the whole tile: in a sorted
  // chunk, row s_row's columns s_col, s_col + s_step, ...; otherwise rows
  // [run_row, run_row + kRun) of column run_col
  const int rows_log2 = __ffs(rows) - 1;
  const int s_row = tid & (rows - 1);
  const int s_col = tid >> rows_log2;
  const int s_step = kBlockThreads >> rows_log2;
  const int run_row = tid / wc * kRun;
  const int run_col = tid % wc;
  auto chunk_rows = [&](int k) {
    return k < nchunks
               ? (int)min((long long)rows, r_end - r_begin - (long long)k * rows)
               : 0;
  };

  for (int i = tid; i < cap * wc; i += kBlockThreads) win[i] = T(0);
  if (tid < 2 * 3 * kBlockWarps) {  // groups past rows / 32 stay empty
    const int f = tid % (3 * kBlockWarps) / kBlockWarps;
    red[tid] = f == 0 ? INT_MAX : (f == 1 ? INT_MIN : 0);
  }
  if (kStaged && tid == 0) {
    for (int i = 0; i < kStages + kIdSlots; ++i) mbar_init(plane_bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Copy `count` values of a chunk's rows or ids into `dst`: one bulk copy
  // of the 16-byte multiple, the few values left by threads (seen by all
  // after the next barrier).
  auto stage_copy = [&](auto* dst, const auto* src, int count, uint64_t* bar) {
    const unsigned bytes = (unsigned)count * sizeof(*src);
    const unsigned bulk = bytes & ~15u;
    if (tid == 0) {
      mbar_expect(bar, bulk);
      if (bulk) bulk_copy(dst, src, bulk, bar);
    }
    const int done = (int)(bulk / sizeof(*src));
    if (tid < count - done) dst[done + tid] = src[done + tid];
  };
  // plane rows of chunk k and the ids of chunk k + 1
  auto fetch = [&](int k) {
    if (!kStaged) return;
    if (k < nchunks)
      stage_copy(stage + (size_t)(k % kStages) * rows * w,
                 plane + (r_begin + (long long)k * rows) * w, chunk_rows(k) * w,
                 plane_bar + k % kStages);
    const int q = k + 1;
    if (q < nchunks)
      stage_copy(sids + (q % kIdSlots) * rows, ids + r_begin + (long long)q * rows,
                 chunk_rows(q), id_bar + q % kIdSlots);
  };
  auto chunk_ids = [&](int k) -> const int* {
    return kStaged ? sids + (k % kIdSlots) * rows
                   : ids + r_begin + (long long)k * rows;
  };
  // Chunk k's live-id min and max, and whether its live ids strictly
  // increase row by row, into red[k & 1] by 32-row group; the next barrier
  // publishes them. Each live row is held against the nearest live row
  // before it. The last rows / 32 warps do this, one row a thread, while
  // warp 0 starts the copies.
  const int sum_row = tid - (kBlockThreads - rows);  // < 0: none
  auto summarize = [&](int k) {
    if (sum_row < 0) return;  // warp-uniform: rows is a multiple of 32
    const int nr = chunk_rows(k);
    if (kStaged && nr > 0) mbar_wait(id_bar + k % kIdSlots, (k / kIdSlots) & 1);
    int* r = red + (k & 1) * 3 * kBlockWarps + (sum_row >> 5);
    const int id = sum_row < nr ? chunk_ids(k)[sum_row] : -1;
    const bool live = (unsigned)id < dead;
    const unsigned before = __ballot_sync(kFull, live) & ((1u << lane) - 1);
    const int prev = __shfl_sync(kFull, id, before ? 31 - __clz(before) : lane);
    const bool unsorted = __any_sync(kFull, live && before && prev >= id);
    const int wmn = __reduce_min_sync(kFull, live ? id : INT_MAX);
    const int wmx = __reduce_max_sync(kFull, live ? id : INT_MIN);
    if (lane == 0) {
      r[0] = wmn;
      r[kBlockWarps] = wmx;
      r[2 * kBlockWarps] = unsorted;
    }
  };

  int lo = 0;
  bool have = false;               // a window has been placed
  int top = 0;                     // the window's last id, lo + cap - 1
  int t_lo = INT_MAX, t_hi = INT_MIN;  // ids touched in the window
  unsigned long long rebases = 0, flushed = 0, direct = 0;
  unsigned long long sorted_chunks = 0, live_chunks = 0;  // thread 0's count
  // this thread's run: its id and sum, carried from chunk to chunk
  int cur = -1;
  T acc = T(0);

  // add every non-zero touched cell to global memory and zero it
  auto flush = [&]() {
    if (t_hi < t_lo) return;
    T* base = win + (size_t)(t_lo - lo) * wc;
    const int cells = (int)(t_hi - t_lo + 1) * wc;
    for (int i = tid; i < cells; i += kBlockThreads) {
      const T v = base[i];
      if (v != T(0)) {
        const int q = i / wc;
        atomicAdd(out + (long long)(t_lo + q) * w + c0 + (i - q * wc), v);
        base[i] = T(0);
        ++flushed;
      }
    }
  };

  if (kStaged && nchunks > 0)  // the ids of chunk 0 go first
    stage_copy(sids, ids + r_begin, chunk_rows(0), id_bar);
  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  __syncthreads();  // the values that threads copied are seen by all
  summarize(0);
  for (int k = 0; k < nchunks; ++k) {
    __syncthreads();  // chunk k's summary is out; chunk k-1's slots are free
    fetch(k + kStages - 1);
    const int nr = chunk_rows(k);
    const long long r0 = r_begin + (long long)k * rows;
    const int* si = chunk_ids(k);
    const T* sv = kStaged ? stage + (size_t)(k % kStages) * rows * w
                          : plane + r0 * w;

    // the block's summary of chunk k, reduced across a warp's lanes
    int mn, mx;
    bool sorted;
    {
      const int* sm = red + (k & 1) * 3 * kBlockWarps;
      const int i = lane & (kBlockWarps - 1);
      const int wmn = sm[i], wmx = sm[kBlockWarps + i];
      const bool has = wmx != INT_MIN;
      const unsigned before = __ballot_sync(kFull, has) &
                              ((1u << kBlockWarps) - 1) & ((1u << i) - 1);
      const int prev =
          __shfl_sync(kFull, wmx, before ? 31 - __clz(before) : i);
      mn = __reduce_min_sync(kFull, wmn);
      mx = __reduce_max_sync(kFull, wmx);
      sorted = !__any_sync(kFull, has && (sm[2 * kBlockWarps + i] ||
                                          (before && prev >= wmn)));
    }
    // every chunk's copy is waited for, so a slot's next copy never
    // overlaps it
    if (kStaged) mbar_wait(plane_bar + k % kStages, (k / kStages) & 1);

    if (mx >= mn) {  // some row of the chunk is live (block-uniform)
      ++live_chunks;
      const bool mn_in = have && (unsigned)(mn - lo) < (unsigned)cap;
      const bool mx_in = have && (unsigned)(mx - lo) < (unsigned)cap;
      if (!(mn_in && mx_in) && (!mn_in || mx - mn < cap)) {
        flush();
        __syncthreads();  // the window is zero before this chunk adds to it
        lo = mn;
        top = mn > INT_MAX - (cap - 1) ? INT_MAX : mn + cap - 1;
        have = true;
        t_lo = INT_MAX;
        t_hi = INT_MIN;
        ++rebases;
      }

      if (sorted) {  // distinct ids: plain adds
        const int id = s_row < nr ? si[s_row] : -1;
        if ((unsigned)id < dead) {
          const T* v = sv + (size_t)s_row * w + c0;
          const unsigned off = (unsigned)(id - lo);
          if (off < (unsigned)cap) {
            T* cell = win + (size_t)off * wc;
            for (int c = s_col; c < wc; c += s_step) cell[c] += v[c];
          } else {
            for (int c = s_col; c < wc; c += s_step) {
              atomicAdd(out + (long long)id * w + c0 + c, v[c]);
              ++direct;
            }
          }
        }
        ++sorted_chunks;
      } else if (run_row < nr) {  // runs: one add per id change
        int idr[kRun];
        T vr[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int r = run_row + i;
          idr[i] = r < nr ? si[r] : -1;
          vr[i] = (unsigned)idr[i] < dead ? sv[(size_t)r * w + c0 + run_col]
                                          : T(0);  // staged, never added
        }
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          if ((unsigned)idr[i] >= dead) continue;
          if (idr[i] == cur) {
            acc += vr[i];
            continue;
          }
          if (cur >= 0) {
            // The carried run may come from an earlier chunk; only ids of
            // this chunk are sure to lie in the range the next flush scans.
            const unsigned off = (unsigned)(cur - lo);
            if (off < (unsigned)cap && cur >= mn && cur <= mx) {
              atomicAdd(win + (size_t)off * wc + run_col, acc);
            } else {
              atomicAdd(out + (long long)cur * w + c0 + run_col, acc);
              ++direct;
            }
          }
          cur = idr[i];
          acc = vr[i];
        }
      }
      const int a = max(mn, lo), b = min(mx, top);
      if (a <= b) {
        t_lo = min(t_lo, a);
        t_hi = max(t_hi, b);
      }
    }
    summarize(k + 1);
  }
  if (cur >= 0) {  // the last carried run
    atomicAdd(out + (long long)cur * w + c0 + run_col, acc);
    ++direct;
  }
  __syncthreads();
  flush();

  flushed = warp_sum(flushed);
  direct = warp_sum(direct);
  if (lane == 0 && (flushed | direct)) {
    atomicAdd(&stats[1], flushed);
    atomicAdd(&stats[2], direct);
  }
  if (tid == 0) {
    atomicAdd(&stats[0], rebases);
    atomicAdd(&stats[3], live_chunks);
    atomicAdd(&stats[4], sorted_chunks);
  }
}

struct Limits {
  int sms;
  int optin;  // shared memory a block may opt in to
};

inline Limits limits() {
  static Limits cache[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  Limits& l = cache[dev & 63];
  if (l.sms == 0) {
    cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&l.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return l;
}

struct Plan {
  int optin, cap, wc, ncg, rows, staged, blocks_x, occupancy;
  size_t smem;
  long long tile_rows;
};

template <typename T>
const void* kernel_of(bool staged) {
  return staged ? reinterpret_cast<const void*>(window_sum_kernel<T, true>)
                : reinterpret_cast<const void*>(window_sum_kernel<T, false>);
}

// The window, column groups, chunk and grid for one call: the window holds
// kWindowIds ids (or every live id, when there are fewer). `aligned` says
// whether the plane and the ids start 16-byte aligned, as the bulk copies
// need. Sets the kernels' dynamic shared memory limit to the card's opt-in
// maximum first, which the occupancy query reads.
template <typename T>
cudaError_t plan_for(long long n, int w, int g, bool aligned, Plan* p) {
  const Limits lim = limits();
  static bool opted_in = false;
  if (!opted_in) {
    for (bool s : {false, true}) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel_of<T>(s), cudaFuncAttributeMaxDynamicSharedMemorySize,
          lim.optin);
      if (err != cudaSuccess) return err;
    }
    opted_in = true;
  }
  const size_t es = sizeof(T);
  // no more ids than there are live groups, or rows to touch them
  const int live = (int)std::min<long long>(g > 1 ? g - 1 : 1,
                                            std::max(n, (long long)kMaxRows));
  const int want = std::min(live, kWindowIds);
  p->optin = lim.optin;
  p->staged =
      aligned && (size_t)kStages * kMinRows * w * es <= (size_t)lim.optin / 2;
  // Per-chunk work (a barrier, the summary) costs as much as a few hundred
  // rows' adds, so chunks of kGoodRows rows or more come before fewer
  // column groups; smaller chunks only for rows too wide for those.
  p->cap = 0;
  const int max_cols = kBlockThreads / (kMinRows / kRun);
  for (int min_rows = kGoodRows; min_rows >= kMinRows && !p->cap; min_rows /= 2) {
    for (int ncg = (w + max_cols - 1) / max_cols; ncg <= w && !p->cap; ++ncg) {
      const int wc = (w + ncg - 1) / ncg;
      for (int rows = kMaxRows; rows >= min_rows; rows /= 2) {
        const size_t ring = ring_bytes(rows, w, es, p->staged);
        if (rows / kRun * wc > kBlockThreads || ring >= (size_t)lim.optin)
          continue;
        const long long capmax =
            (long long)((lim.optin - ring) / 16 * 16 / (wc * es));
        if (capmax >= want) {
          p->wc = wc;
          p->rows = rows;
          p->cap = (int)std::min<long long>(live, capmax);
          break;
        }
      }
    }
  }
  if (!p->cap) return cudaErrorInvalidConfiguration;
  p->ncg = (w + p->wc - 1) / p->wc;
  p->smem = ring_bytes(p->rows, w, es, p->staged) +
            align16((size_t)p->cap * p->wc * es);
  static size_t last_smem[2] = {0, 0};  // the last query, by staged
  static int last_occ[2] = {0, 0};
  if (last_smem[p->staged] != p->smem) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_occ[p->staged], kernel_of<T>(p->staged), kBlockThreads, p->smem);
    if (err != cudaSuccess) return err;
    last_smem[p->staged] = p->smem;
  }
  p->occupancy = last_occ[p->staged];
  const long long chunks = std::max((n + p->rows - 1) / p->rows, 1LL);
  const long long slots = std::min(
      chunks,
      std::max(1LL, (long long)lim.sms * std::max(p->occupancy, 1) / p->ncg));
  const long long per = (chunks + slots - 1) / slots;
  p->blocks_x = (int)((chunks + per - 1) / per);
  p->tile_rows = per * p->rows;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_segment_sum(const void* plane, const void* ids, void* out,
                               long long n, int w, int g,
                               cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  Plan p;
  const bool aligned = (reinterpret_cast<uintptr_t>(plane) |
                        reinterpret_cast<uintptr_t>(ids)) % 16 == 0;
  cudaError_t err = plan_for<T>(n, w, g, aligned, &p);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.blocks_x, p.ncg);
  auto* pl = static_cast<const T*>(plane);
  auto* id = static_cast<const int*>(ids);
  auto* o = static_cast<T*>(out);
  if (p.staged)
    window_sum_kernel<T, true><<<grid, kBlockThreads, p.smem, stream>>>(
        pl, id, o, n, w, g, p.wc, p.cap, p.rows, p.tile_rows);
  else
    window_sum_kernel<T, false><<<grid, kBlockThreads, p.smem, stream>>>(
        pl, id, o, n, w, g, p.wc, p.cap, p.rows, p.tile_rows);
  return cudaGetLastError();
}

}  // namespace k1
}  // namespace gtpu

// C entry, bound with ctypes. `out` must hold g * w zeros on entry.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gtpu_segment_sum(const void* plane, const void* ids, void* out,
                                long long n, int w, int g, int is_double,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double
          ? gtpu::k1::launch_segment_sum<double>(plane, ids, out, n, w, g, s)
          : gtpu::k1::launch_segment_sum<float>(plane, ids, out, n, w, g, s);
  return (int)err;
}

// The plan a gtpu_segment_sum call with these arguments launches, for
// inspection: out9 = {opt-in shared memory a block, window ids, columns a
// group, column groups, rows a chunk, staged (1) or not (0), blocks along
// x, blocks an SM, dynamic shared memory a block}. `aligned` says whether
// the plane and ids start 16-byte aligned. Returns a cudaError_t.
extern "C" int gtpu_segment_sum_plan(long long n, int w, int g, int is_double,
                                     int aligned, long long* out9) {
  gtpu::k1::Plan p;
  cudaError_t err =
      is_double ? gtpu::k1::plan_for<double>(n, w, g, aligned != 0, &p)
                : gtpu::k1::plan_for<float>(n, w, g, aligned != 0, &p);
  if (err != cudaSuccess) return (int)err;
  const long long v[9] = {p.optin,  p.cap,      p.wc,       p.ncg,
                          p.rows,   p.staged,   p.blocks_x, p.occupancy,
                          (long long)p.smem};
  for (int i = 0; i < 9; ++i) out9[i] = v[i];
  return 0;
}

// The kernel's counters, summed over every launch since the last reset:
// out5 = {window re-bases, window cells flushed by global atomics, sums
// added straight to global memory, chunks with a live row, chunks added
// without atomics}. Read after the device's work is done; reset != 0
// zeroes them after reading. Returns a cudaError_t.
extern "C" int gtpu_segment_sum_stats(unsigned long long* out5, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out5, gtpu::k1::stats,
                                         sizeof(gtpu::k1::stats));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(gtpu::k1::stats, zero, sizeof(zero));
  }
  return (int)err;
}
