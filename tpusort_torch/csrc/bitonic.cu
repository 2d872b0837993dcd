// K2: fused raw-key leaf sort + dense collapse.
//
// Replaces the Pallas kernel _counts_sort_collapse_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles_counts_collapsed.  One CTA owns one
// leaf tile of K keys (K = 24576 = 2 segments of 12288 at 2^28, not a power
// of two).  The tile is padded virtually to P = 2^ceil(log2 K) with
// 0xFFFFFFFF in shared memory (128 KB at P = 32768) so one power-of-two
// network sorts it:
//
//   1. slot i is valid iff i % q < counts[t, i / q]; invalid keys become
//      0xFFFFFFFF;
//   2. the tile is merged from its ascending runs of sorted_run keys (the
//      last pass's emitted runs), or fully sorted when sorted_run is 0;
//   3. the first c_t = offsets[t+1] - offsets[t] keys (the valid prefix) go
//      to out[offsets[t] + i], bounded by n_out.
//
// The Pallas kernel writes whole rows past each tile's end and relies on the
// next in-order grid step to overwrite them; CTAs run concurrently here, so
// each writes exactly its own range.  The offsets (exclusive cumsum of the
// tiles' valid counts) are computed by the wrapper before the launch.
//
// Bound: reads the leaf layout once (1.5x the keys at 2^28) and writes the
// keys once; like K1 this first version is bound by the shared-memory
// merge network (75 stages over 32768 slots from 512-runs).
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_sort.cuh"

namespace tpusort {

__global__ void __launch_bounds__(kThreads)
leaf_collapse_kernel(const uint32_t* __restrict__ keys,
                     const int32_t* __restrict__ counts, int q,
                     const long long* __restrict__ offsets, long long n_out,
                     int K, int log_p, int log_run,
                     uint32_t* __restrict__ out) {
  extern __shared__ uint32_t tile[];
  const int t = blockIdx.x;
  const int P = 1 << log_p;
  const uint32_t* src = keys + (size_t)t * K;
  const int32_t* cnt = counts + (size_t)t * (K / q);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    tile[i] = (i < K && (i % q) < cnt[i / q]) ? src[i] : 0xFFFFFFFFu;
  }
  __syncthreads();

  block_sort(tile, log_p, log_run);

  const long long off = offsets[t];
  long long c = offsets[t + 1] - off;
  if (c > K) c = K;
  if (c > n_out - off) c = n_out - off;
  for (long long i = threadIdx.x; i < c; i += blockDim.x) {
    out[off + i] = tile[i];
  }
}

}  // namespace tpusort

extern "C" int tpusort_leaf_collapse(const void* keys, const void* counts,
                                     int q, const void* offsets,
                                     long long n_out, int T, int K, int P,
                                     int sorted_run, void* out, void* stream) {
  const int log_p = 31 - __builtin_clz(P);
  const int log_run = sorted_run > 0 ? 31 - __builtin_clz(sorted_run) : 0;
  const int smem = P * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(tpusort::leaf_collapse_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tpusort::leaf_collapse_kernel<<<T, tpusort::kThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (const int32_t*)counts, q,
      (const long long*)offsets, n_out, K, log_p, log_run, (uint32_t*)out);
  return (int)cudaGetLastError();
}
