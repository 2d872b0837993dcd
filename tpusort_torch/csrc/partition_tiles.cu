// K8: sort each tile by the caller's sortkey, then emit its data operands as
// R runs of S slots from the caller's run starts.
//
// Replaces the Pallas kernel _partition_kernel behind
// tpusort/kernels/partition.py:partition_tiles, which the per-phase profiler
// of the MSD engine runs once a partition pass (tpusort/ops/msd.py
// _partition_pass with use_pallas).  The caller computes the digit
// histogram, the run starts and a sortkey (digit, or R where invalid) <<
// log2(K) | slot, which is unique, so the order is the stable order by digit.
//
// Contract: ops = [sortkey, data...], each (T, K) 32-bit words, the sortkey
// compared as unsigned; starts (T, R) int32.  For each data operand,
// out[t, d * S + j] = sorted[t, clamp(starts[t, d] + j, 0, K - 1)].  The
// sortkey is not emitted.  Slots past a run's count are unspecified; the
// clamp keeps them inside the tile (the Pallas kernel leaves them garbage
// and never reads past the tile either).  Ties in the sortkey leave their
// order unspecified; the only caller's sortkey has none.
//
// One CTA a tile:
//   1. load the sortkey into shared memory with a 16-bit slot index;
//   2. sort the K slots (tile_sort.cuh's shared-memory network);
//   3. write each run's S slots of every data operand, gathered from the
//      tile's input in global memory through the sorted slot index.
//
// Bound: the shared-memory network (105 stages at K = 16384, each a pass
// over the tile with a __syncthreads()), not the words moved: the sortkey
// and each data word are read once and each output word written once.  The
// writes are contiguous; the gathers stay inside one tile (64 KB a data
// operand at K = 16384), which L2 holds.  A radix rank over the digit field
// (K1c's, partition_general.cu) would skip the network, but it depends on
// how the caller built the sortkey.  Shared memory: K * 6 bytes, 96 KB at
// K = 16384, 192 KB at the largest K, 32768.
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_sort.cuh"

namespace tpusort {

constexpr int kMaxRuns = 128;   // R: the Pallas kernel's one lane row

__global__ void __launch_bounds__(kThreads)
partition_tiles_kernel(const uint32_t* __restrict__ sortkey, Values vals,
                       const int32_t* __restrict__ starts, int K, int log_k,
                       int R, int S) {
  extern __shared__ uint32_t smem[];
  __shared__ int32_t start[kMaxRuns];
  const SmemTile tile(smem, K);
  const size_t first = (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    tile.load(i, sortkey, first);
  }
  for (int d = threadIdx.x; d < R; d += blockDim.x) {
    start[d] = starts[(size_t)blockIdx.x * R + d];
  }
  __syncthreads();

  block_sort(tile, log_k, 0);

  const int runs = R * S;
  const size_t out0 = (size_t)blockIdx.x * runs;
  for (int o = threadIdx.x; o < runs; o += blockDim.x) {
    const int d = o / S;
    const int pos = min(max(start[d] + (o - d * S), 0), K - 1);
    const size_t from = first + tile.idx[pos];
    for (int v = 0; v < vals.count; ++v) {
      vals.out[v][out0 + o] = vals.in[v][from];
    }
  }
}

}  // namespace tpusort

// sortkey: (T, K) row-major; vals_in: n_vals (1-8) device pointers, (T, K)
// each; vals_out: n_vals device pointers, (T, R * S) each; starts: (T, R)
// int32.  K a power of two in [128, 32768], R in [1, 128], S > 0.  Returns a
// cudaError_t.
extern "C" int tpusort_partition_tiles(const void* sortkey,
                                       const void* const* vals_in,
                                       void* const* vals_out, int n_vals,
                                       const void* starts, int T, int K,
                                       int R, int S, void* stream) {
  using namespace tpusort;
  if (n_vals < 1 || n_vals > kMaxValues || R < 1 || R > kMaxRuns || S < 1 ||
      K < 128 || K > 32768 || (K & (K - 1)) || T < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
  Values vals{};
  vals.count = n_vals;
  for (int v = 0; v < n_vals; ++v) {
    vals.in[v] = static_cast<const uint32_t*>(vals_in[v]);
    vals.out[v] = static_cast<uint32_t*>(vals_out[v]);
  }
  const int log_k = 31 - __builtin_clz(K);
  const size_t smem = SmemTile::bytes(K);
  const int threads = K / 2 < kThreads ? K / 2 : kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      partition_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  partition_tiles_kernel<<<T, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(sortkey), vals,
      static_cast<const int32_t*>(starts), K, log_k, R, S);
  return (int)cudaGetLastError();
}
