// K2: fused raw-key leaf sort + dense collapse, 1-3 key planes, payloads
// unstable.
//
// Replaces the Pallas kernel _counts_sort_collapse_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles_counts_collapsed.  One CTA owns one
// leaf tile of K slots (K = 24576 = 2 segments of 12288 at 2^28 keys-only,
// 12288 with more planes or payloads; not a power of two).  The tile is
// padded virtually to P = 2^ceil(log2 K) with 0xFFFFFFFF in shared memory so
// one power-of-two network sorts it:
//
//   1. slot i is valid iff i % q < counts[t, i / q]; invalid slots become
//      0xFFFFFFFF in every key plane;
//   2. the tile is merged from its ascending runs of sorted_run slots (the
//      last pass's emitted runs), or fully sorted when sorted_run is 0,
//      lexicographically over the planes; with payloads a 16-bit slot index
//      rides the network;
//   3. the first c_t = offsets[t+1] - offsets[t] slots (the valid prefix) go
//      to out[offsets[t] + i], bounded by n_out: key planes from shared
//      memory, payload words gathered from the tile's input by the index.
//
// The Pallas kernel writes whole rows past each tile's end and relies on the
// next in-order grid step to overwrite them; CTAs run concurrently here, so
// each writes exactly its own range.  The offsets (exclusive cumsum of the
// tiles' valid counts) are computed by the wrapper before the launch.
//
// Bound: reads the leaf layout once (1.5x the operands at 2^28) and writes
// them once; like K1 this first version is bound by the shared-memory merge
// network (75 stages over 32768 slots from 512-runs keys-only, 66 over
// 16384 with more planes).  Shared memory: P * (4 * planes + 2 if payloads)
// bytes, 128 KB keys-only and 160 KB for the composite (key, position)
// pairs at 2^28.
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_sort.cuh"

namespace tpusort {

template <int NK, bool IDX>
__global__ void __launch_bounds__(kThreads)
leaf_collapse_kernel(Planes planes, Values vals,
                     const int32_t* __restrict__ counts, int q,
                     const long long* __restrict__ offsets, long long n_out,
                     int K, int log_p, int log_run) {
  extern __shared__ uint32_t smem[];
  const int t = blockIdx.x;
  const int P = 1 << log_p;
  const SmemTile<NK, IDX> tile(smem, P);
  const size_t first = (size_t)t * K;
  const int32_t* cnt = counts + (size_t)t * (K / q);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    tile.load(i, planes.in, first, i < K && (i % q) < cnt[i / q]);
  }
  __syncthreads();

  block_sort(tile, log_p, log_run);

  const long long off = offsets[t];
  long long c = offsets[t + 1] - off;
  if (c > K) c = K;
  if (c > n_out - off) c = n_out - off;
  for (long long i = threadIdx.x; i < c; i += blockDim.x) {
#pragma unroll
    for (int p = 0; p < NK; ++p) planes.out[p][off + i] = tile.key[p][i];
    if (IDX) {
      // a pad slot's index (>= K) reaches the prefix only when a valid key
      // ties the all-ones sentinel, which the engine's overflow check
      // discards; clamp it so the gather stays inside the tile
      const size_t src = first + min((int)tile.idx[i], K - 1);
      for (int v = 0; v < vals.count; ++v) {
        vals.out[v][off + i] = vals.in[v][src];
      }
    }
  }
}

template <int NK, bool IDX>
int launch_leaf(const Planes& planes, const Values& vals,
                const int32_t* counts, int q, const long long* offsets,
                long long n_out, int T, int K, int P, int log_run,
                cudaStream_t stream) {
  const int log_p = 31 - __builtin_clz(P);
  const size_t smem = SmemTile<NK, IDX>::bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      leaf_collapse_kernel<NK, IDX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  leaf_collapse_kernel<NK, IDX><<<T, kThreads, smem, stream>>>(
      planes, vals, counts, q, offsets, n_out, K, log_p, log_run);
  return (int)cudaGetLastError();
}

}  // namespace tpusort

// keys_in/keys_out: n_planes (1-3) device pointers each; vals_in/vals_out:
// n_vals (0-8) device pointers each.  Returns a cudaError_t.
extern "C" int tpusort_leaf_collapse(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts, int q, const void* offsets, long long n_out, int T,
    int K, int P, int sorted_run, void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  if (!make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals)) {
    return (int)cudaErrorInvalidValue;
  }
  const int log_run = sorted_run > 0 ? 31 - __builtin_clz(sorted_run) : 0;
  return dispatch_mode(n_planes, n_vals > 0, [&](auto nk, auto idx) {
    return launch_leaf<decltype(nk)::value, decltype(idx)::value>(
        planes, vals, (const int32_t*)counts, q, (const long long*)offsets,
        n_out, T, K, P, log_run, (cudaStream_t)stream);
  });
}
