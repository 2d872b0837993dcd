// K2: fused raw-key leaf sort + dense collapse, 1-3 key planes, payloads.
//
// Replaces the Pallas kernel _counts_sort_collapse_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles_counts_collapsed.  One CTA owns one
// leaf tile of K slots (K = 24576 = 2 segments of 12288 at 2^28 keys-only,
// 12288 with more planes or payloads; not a power of two), padded virtually
// to P = 2^ceil(log2 K) slots.  The body is K9's (csrc/sort_tiles.cu:
// sort_tiles_valid_kernel) on the register network of reg_sort.cuh, laid
// out by kernels/bitonic.py:tile_sort_geometry (threads x E slots a thread
// x chunks = P); only the epilogue differs:
//
//   1. load_row: slot i is valid iff i % q < counts[t, i / q]; invalid and
//      pad slots become 0xFFFFFFFF in every key plane; with payloads a
//      16-bit slot index rides under the last plane, 0xFFFF on invalid and
//      pad slots (reg_sort.cuh:kPadIndex);
//   2. reg_block_sort merges the tile from its ascending runs of
//      sorted_run slots (the last pass's emitted runs), or sorts it whole
//      when sorted_run is 0, lexicographically over the planes; with
//      payloads equal keys compare by slot index, so the order is the
//      stable one (the plain version's), and an invalid or pad slot sorts
//      after every valid slot, a valid all-ones key included, so it never
//      reaches the valid prefix;
//   3. the dense epilogue: the first c_t = offsets[t+1] - offsets[t] slots
//      (the valid prefix), bounded by K and by n_out, go to
//      out[offsets[t] + i]: key planes from the swizzled tile, each payload
//      word staged in shared memory over plane 0 and gathered there by the
//      slot index (clamped to K - 1).  The offsets are arbitrary, so the
//      stores (reg_sort.cuh:store_words) take a scalar head and tail around
//      a 16-byte body; consecutive threads store consecutive words.  A tile
//      with c_t <= 0 returns at once.
//
// The Pallas kernel writes whole rows past each tile's end and relies on the
// next in-order grid step to overwrite them; CTAs run concurrently here, so
// each writes exactly its own range.  The offsets (exclusive cumsum of the
// tiles' valid counts) are computed by the wrapper before the launch.
//
// Bound: reads the leaf layout once (1.5x the operands at 2^28) and writes
// the operands once; the network's instructions bound it.  From runs of
// 512, keys-only 2^28 (P = 32768, 1024 threads x 32 slots) takes 75 steps,
// 15 of them through shared memory with a barrier each, the rest in
// registers and shuffles; half of the padded slots it sorts are sentinels
// (a tile holds 16,384 valid slots on average).  Shared memory: P * (4 *
// planes + 2 if payloads) bytes, as the first version's (at most 229,376 B,
// 3 planes + payloads at P = 16384), and no static shared memory.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "reg_sort.cuh"
#include "operands.cuh"

namespace tpusort {

template <int NK, bool IDX, int E>
__global__ void __launch_bounds__(max_threads(NK, IDX, E))
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
  const RegTile<NK, IDX> tile(smem, 1 << log_p);
  const size_t first = (size_t)t * K;
  const int32_t* cnt = counts + (size_t)t * (K / q);
  if ((q & (q - 1)) == 0) {            // the path's q: shifts, no division
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

template <int NK, bool IDX, int E>
int launch_leaf(const Planes& planes, const Values& vals,
                const int32_t* counts, int q, const long long* offsets,
                long long n_out, int T, int K, int P, int log_run,
                int threads, int chunks, size_t smem, cudaStream_t stream) {
  const int log_p = 31 - __builtin_clz(P);
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err =
      allow_smem_once((const void*)leaf_collapse_kernel<NK, IDX, E>,
                      smem_cap<NK, IDX>(), smem_set);
  if (err != cudaSuccess) return (int)err;
  leaf_collapse_kernel<NK, IDX, E><<<T, threads, smem, stream>>>(
      planes, vals, counts, q, offsets, n_out, K, log_p, log_run, chunks);
  return (int)cudaGetLastError();
}

}  // namespace tpusort

// keys_in/keys_out: n_planes (1-3) device pointers each, the inputs (T, K)
// row-major and the outputs (n_out,); vals_in/vals_out: n_vals (0-8), the
// same shapes.  counts: (T, K / q) int32; offsets: (T + 1,) int64, the
// exclusive cumsum of the tiles' valid counts.  P is the power of two >= K;
// sorted_run 0 or a power of two dividing K and P - K; threads, slots and
// smem the geometry of kernels/bitonic.py:tile_sort_geometry.  Returns a
// cudaError_t (cudaErrorInvalidValue for a geometry no instance takes).
extern "C" int tpusort_leaf_collapse(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts, int q, const void* offsets, long long n_out, int T,
    int K, int P, int sorted_run, int threads, int slots, int smem,
    void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  int chunks = 0;
  if (!make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals) ||
      q <= 0 || K <= 0 || K > P || K % q ||
      !reg_geometry_ok(P, threads, slots, (size_t)smem,
                       (size_t)P * (4 * n_planes + (n_vals > 0 ? 2 : 0)),
                       &chunks)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
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
        return launch_leaf<kNk, kIdx, kE>(
            planes, vals, (const int32_t*)counts, q,
            (const long long*)offsets, n_out, T, K, P, log_run, threads,
            chunks, (size_t)smem, (cudaStream_t)stream);
      }
    });
  });
}
