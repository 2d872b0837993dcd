// K2: fused raw-key leaf sort + dense collapse, 1-3 key planes, payloads.
//
// Replaces the Pallas kernel _counts_sort_collapse_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles_counts_collapsed.  One CTA owns one
// leaf tile of K slots (not a power of two: a final segment of 12,288 at
// 2^28, 15,360 on the skew tier) and writes its valid slots, sorted, to
// their dense place.  It has two bodies, one __global__ (a template flag),
// and the wrapper picks one from the call's shape alone
// (kernels/bitonic.py:leaf_merge_geometry):
//
// * the merge body (csrc/merge_runs.cuh), wherever the tile arrives as
//   sorted runs (sorted_run > 0: the last K1 or K1b pass's emitted runs):
//   only the runs' valid prefixes are read, compacted into shared memory,
//   cut where their order breaks, and merged pairwise level by level,
//   each thread's outputs found by a merge-path search; no sentinel and no
//   pad slot is sorted.  See that file for the design.
// * the network body, where the runs are not sorted (sorted_run 0: the
//   wide leaf after K1c) or the merge's registers or shared memory do not
//   fit: the tile padded virtually to P = 2^ceil(log2 K) slots and sorted
//   by K9's body (csrc/sort_tiles.cu: sort_tiles_valid_kernel) on the
//   register network of reg_sort.cuh, laid out by
//   kernels/bitonic.py:tile_sort_geometry (threads x E slots a thread x
//   chunks = P):
//   1. load_row: slot i is valid iff i % q < counts[t, i / q]; invalid and
//      pad slots become 0xFFFFFFFF in every key plane; with payloads a
//      16-bit slot index rides under the last plane, 0xFFFF on invalid and
//      pad slots (reg_sort.cuh:kPadIndex);
//   2. reg_block_sort merges the tile from its ascending runs of
//      sorted_run slots, or sorts it whole when sorted_run is 0,
//      lexicographically over the planes; with payloads equal keys compare
//      by slot index, so the order is the stable one (the plain
//      version's), and an invalid or pad slot sorts after every valid
//      slot, a valid all-ones key included, so it never reaches the valid
//      prefix.
//
// Both end in the same dense epilogue: the first c_t = offsets[t+1] -
// offsets[t] slots (the valid prefix), bounded by K and by n_out, go to
// out[offsets[t] + i]: key planes from the tile, each payload word staged
// in shared memory over plane 0 and gathered there by the slot index
// (clamped to K - 1).  The offsets are arbitrary, so the stores
// (reg_sort.cuh:store_words) take a scalar head and tail around a 16-byte
// body; consecutive threads store consecutive words.  A tile with c_t <= 0
// returns at once.  Both give the (key, slot) order, so their outputs are
// the same bit for bit.
//
// The Pallas kernel writes whole rows past each tile's end and relies on the
// next in-order grid step to overwrite them; CTAs run concurrently here, so
// each writes exactly its own range.  The offsets (exclusive cumsum of the
// tiles' valid counts) are computed by the wrapper before the launch.
//
// Bound: the valid slots read once and written once (0.641 ms for 2^28
// keys, 1.283 for key + value, 1.924 for 2 planes + value at 3.35 TB/s).
// The network body is bound by its instructions: from runs of 512 a
// keys-only tile of 24,576 slots (two segments, P = 32768) took 75 steps,
// half of its slots sentinels, 75 compare-exchanges a valid key (9.0 ms,
// 14x the bound, on an H100).  The merge body moves a valid key once a
// level (5 levels for 24 runs) and is bound by the instructions and
// latency of its serial merges and of its tile's load and store phases,
// which the CTAs on an SM overlap.  On an H100 at 2^28 it takes 2.8 ms for
// keys (4.4x the bound), 4.5 for key + value (3.5x) and 9.8 for 2 planes +
// value on the skew tier (5.1x), where the tile's buffer (190 KB) leaves
// one CTA an SM; without its merge levels the same launches take 1.6, 2.4
// and 3.6.  Shared memory: the network body P * (4 * planes + 2 if
// payloads) bytes (at most 229,376 B, 3 planes + payloads at P = 16384),
// the merge body (K + K / 32) * (4 * planes + 4 if payloads) bytes and the
// runs' starts; no static shared memory.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "merge_runs.cuh"
#include "operands.cuh"
#include "reg_sort.cuh"

namespace tpusort {

// The threads an instance is built for: the network's, or the merge's.
__host__ __device__ constexpr int leaf_threads(int nk, bool idx, int e,
                                               bool merge) {
  return merge ? kMergeThreads : max_threads(nk, idx, e);
}

template <int NK, bool IDX, int E, bool MERGE>
__global__ void __launch_bounds__(leaf_threads(NK, IDX, E, MERGE))
leaf_collapse_kernel(Planes planes, Values vals,
                     const int32_t* __restrict__ counts, int q,
                     const long long* __restrict__ offsets, long long n_out,
                     int K, int log_p, int log_run, int chunks) {
  extern __shared__ uint32_t smem[];
  const int t = blockIdx.x;
  const long long off = offsets[t];
  long long c = offsets[t + 1] - off;
  if (c > K) c = K;
  if (c > n_out - off) c = n_out - off;
  if (c <= 0) return;                       // nothing of it is written
  const size_t first = (size_t)t * K;
  const int32_t* cnt = counts + (size_t)t * (K / q);
  if constexpr (MERGE) {                    // log_run: the merge run's log2
    merge_leaf<E, NK, IDX>(smem, planes, vals, cnt, q, K, log_run, chunks,
                           first, (size_t)off, (int)c);
    return;
  } else {
    const RegTile<NK, IDX> tile(smem, 1 << log_p);
    if ((q & (q - 1)) == 0) {          // the path's q: shifts, no division
      const int qs = __ffs(q) - 1;
      load_row<E>(tile, planes.in, first, K, chunks,
                  [=](int i) { return (i & (q - 1)) < cnt[i >> qs]; });
    } else {
      load_row<E>(tile, planes.in, first, K, chunks,
                  [=](int i) { return (i % q) < cnt[i / q]; });
    }
    __syncthreads();
    reg_block_sort<E>(tile, log_p, log_run, chunks);
    store_row(tile, planes.out, (size_t)off, (int)c);
    if constexpr (IDX) {
      gather_payloads<E>(tile, vals, first, K, chunks, (size_t)off, (int)c);
    }
  }
}

template <int NK, bool IDX, int E, bool MERGE>
int launch_leaf(const Planes& planes, const Values& vals,
                const int32_t* counts, int q, const long long* offsets,
                long long n_out, int T, int K, int log_p, int log_run,
                int threads, int chunks, size_t smem, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  const int cap = MERGE ? (int)MergeTile<NK, IDX>::bytes(32768, kMergeMaxRuns)
                        : smem_cap<NK, IDX>();
  cudaError_t err =
      allow_smem_once((const void*)leaf_collapse_kernel<NK, IDX, E, MERGE>,
                      cap < kMaxSmem ? cap : kMaxSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  leaf_collapse_kernel<NK, IDX, E, MERGE><<<T, threads, smem, stream>>>(
      planes, vals, counts, q, offsets, n_out, K, log_p, log_run, chunks);
  return (int)cudaGetLastError();
}

}  // namespace tpusort

// keys_in/keys_out: n_planes (1-3) device pointers each, the inputs (T, K)
// row-major and the outputs (n_out,); vals_in/vals_out: n_vals (0-8), the
// same shapes.  counts: (T, K / q) int32; offsets: (T + 1,) int64, the
// exclusive cumsum of the tiles' valid counts.  merge_run 0 runs the
// network body: P is the power of two >= K, sorted_run 0 or a power of
// two dividing K and P - K, and threads, slots and smem the geometry of
// kernels/bitonic.py:tile_sort_geometry.  merge_run > 0 runs the merge
// body on runs of merge_run slots (a power of two from 128, dividing q,
// at most 256 runs a tile), with the geometry of
// kernels/bitonic.py:leaf_merge_geometry (slots merge_slots(n_planes),
// at most kMergeThreads threads, threads * slots >= K; P and sorted_run
// unused).  Returns a cudaError_t (cudaErrorInvalidValue for a
// geometry no instance takes).
extern "C" int tpusort_leaf_collapse(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts, int q, const void* offsets, long long n_out, int T,
    int K, int P, int sorted_run, int merge_run, int threads, int slots,
    int smem, void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  if (!make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals) ||
      q <= 0 || K <= 0 || K % q) {
    return (int)cudaErrorInvalidValue;
  }
  if (merge_run > 0) {
    if (!merge_geometry_ok(K, q, merge_run, n_planes, n_vals > 0, threads,
                           slots, (size_t)smem, 0)) {
      return (int)cudaErrorInvalidValue;
    }
    if (T == 0) return (int)cudaSuccess;
    const int log_l = 31 - __builtin_clz(merge_run);
    return dispatch_mode(n_planes, n_vals > 0, [&](auto nk, auto idx) {
      constexpr int kNk = decltype(nk)::value;
      return launch_leaf<kNk, decltype(idx)::value, merge_slots(kNk), true>(
          planes, vals, (const int32_t*)counts, q, (const long long*)offsets,
          n_out, T, K, 0, log_l, threads, 1, (size_t)smem,
          (cudaStream_t)stream);
    });
  }
  int chunks = 0;
  if (K > P ||
      !reg_geometry_ok(P, threads, slots, (size_t)smem,
                       (size_t)P * (4 * n_planes + (n_vals > 0 ? 2 : 0)),
                       &chunks)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
  const int log_p = 31 - __builtin_clz(P);
  const int log_run = sorted_run > 0 ? 31 - __builtin_clz(sorted_run) : 0;
  return dispatch_slots(slots, [&](auto e) {
    return dispatch_mode(n_planes, n_vals > 0, [&](auto nk, auto idx) {
      constexpr int kNk = decltype(nk)::value;
      constexpr bool kIdx = decltype(idx)::value;
      constexpr int kE = decltype(e)::value;
      if constexpr (!fits_registers(kNk, kIdx, kE)) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (threads > max_threads(kNk, kIdx, kE)) {
          return (int)cudaErrorInvalidValue;
        }
        return launch_leaf<kNk, kIdx, kE, false>(
            planes, vals, (const int32_t*)counts, q,
            (const long long*)offsets, n_out, T, K, log_p, log_run, threads,
            chunks, (size_t)smem, (cudaStream_t)stream);
      }
    });
  });
}
