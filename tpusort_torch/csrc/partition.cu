// K1: one fused MSD partition pass, raw-key keys-only mode.
//
// Replaces the raw-key branch of the Pallas kernel _fused_kernel behind
// tpusort/kernels/partition.py:partition_pass_fused.  One CTA owns one
// K-element tile (K = 16384 on the main path, 64 KB of dynamic shared memory):
//
//   1. load the tile; a slot is valid iff its global index < n (pass 0) or
//      slot % q_in < counts_in[t, slot / q_in] (later passes); invalid keys
//      become 0xFFFFFFFF, which sorts last and ties only equal keys, so the
//      keys-only multiset stays exact;
//   2. sort the tile ascending (merge levels above sorted_run only);
//   3. histogram the digit bits [lo_bit, lo_bit + width) of the sorted tile
//      (warp-aggregated shared atomics; sorted input gives ~one atomic per
//      warp step); start[d] = #(digit < d), count[d] = start[d+1] - start[d]
//      and, for the top digit, n_valid - start[R-1];
//   4. write run d of tile t = seg * t_seg + j to
//      out[((seg * R + d) * t_seg + j) * S + [0, min(count, S))], the
//      digit-major layout of the next pass (the fused exchange), and the
//      unclamped counts to counts_out[t, :].  Slots past a run's count are
//      left unwritten.
//
// Bound: a pass reads the keys once and writes 1.5x (S1 = 1.5 K / R) or 1x
// of them, 2.5 bytes moved per key byte, so at HBM speed the pass is
// memory-bound; this first version is bound instead by the shared-memory
// sort network (105 stages for a full 16384 sort, 69 for a merge from
// 256-runs), which later work moves into registers and warp shuffles.
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_sort.cuh"

namespace tpusort {

constexpr int kMaxRadix = 256;

__global__ void __launch_bounds__(kThreads)
partition_raw_kernel(const uint32_t* __restrict__ keys,
                     const int32_t* __restrict__ counts_in, int q_in,
                     long long n, int K, int log_k, int R, int S, int lo_bit,
                     int width, int t_seg, int log_run,
                     uint32_t* __restrict__ out,
                     int32_t* __restrict__ counts_out) {
  extern __shared__ uint32_t tile[];
  __shared__ int hist[kMaxRadix];
  __shared__ int start[kMaxRadix];
  __shared__ int n_valid;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int d = tid; d < R; d += blockDim.x) hist[d] = 0;
  if (tid == 0) n_valid = 0;
  __syncthreads();

  const uint32_t* src = keys + (size_t)t * K;
  const long long first = (long long)t * K;
  const int32_t* cin = counts_in ? counts_in + (size_t)t * (K / q_in) : nullptr;
  int mine = 0;
  for (int i = tid; i < K; i += blockDim.x) {
    const bool v = cin ? (i % q_in) < cin[i / q_in] : first + i < n;
    tile[i] = v ? src[i] : 0xFFFFFFFFu;
    mine += v;
  }
  mine = __reduce_add_sync(0xFFFFFFFFu, mine);
  if ((tid & 31) == 0) atomicAdd(&n_valid, mine);
  __syncthreads();

  block_sort(tile, log_k, log_run);

  const uint32_t dmask = (1u << width) - 1u;
  for (int i = tid; i < K; i += blockDim.x) {
    const int d = (int)((tile[i] >> lo_bit) & dmask);
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if ((tid & 31) == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int d = 0; d < R; ++d) {
      start[d] = acc;
      acc += hist[d];
    }
  }
  __syncthreads();
  for (int d = tid; d < R; d += blockDim.x) {
    const int c = d < R - 1 ? hist[d] : n_valid - start[R - 1];
    counts_out[(size_t)t * R + d] = c;
    hist[d] = c;  // each thread rewrites only its own digit
  }
  __syncthreads();

  const int seg = t / t_seg;
  const int j = t - seg * t_seg;
  for (int e = tid; e < R * S; e += blockDim.x) {
    const int d = e / S;
    const int i = e - d * S;
    if (i < hist[d]) {
      out[((size_t)(seg * R + d) * t_seg + j) * S + i] = tile[start[d] + i];
    }
  }
}

}  // namespace tpusort

extern "C" int tpusort_partition_raw(const void* keys, const void* counts_in,
                                     int q_in, long long n, int T, int K,
                                     int R, int S, int lo_bit, int width,
                                     int t_seg, int sorted_run, void* out,
                                     void* counts_out, void* stream) {
  const int log_k = 31 - __builtin_clz(K);
  const int log_run = sorted_run > 0 ? 31 - __builtin_clz(sorted_run) : 0;
  const int smem = K * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(tpusort::partition_raw_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tpusort::partition_raw_kernel<<<T, tpusort::kThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (const int32_t*)counts_in, q_in, n, K, log_k, R,
      S, lo_bit, width, t_seg, log_run, (uint32_t*)out, (int32_t*)counts_out);
  return (int)cudaGetLastError();
}

extern "C" const char* tpusort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
