// K3: sort each row of (T, K) operands by operand 0, unsigned, unstable.
//
// Replaces the Pallas kernel _sort_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles, which the single-tile path
// (ops/small.py, inputs of up to 2^14 keys) runs.  One CTA owns one row:
//
//   1. load the row's keys into shared memory and pad them virtually to
//      P = 2^ceil(log2 K) with 0xFFFFFFFF; with payloads a 16-bit slot index
//      rides the network;
//   2. sort the P slots ascending (tile_sort.cuh); with payloads equal keys
//      compare by slot index, so a pad slot (index >= K) sorts after every
//      genuine 0xFFFFFFFF key and never lands inside [0, K);
//   3. write slots [0, K) of the keys, and each payload word gathered from
//      the row's input by the index.  The payloads written are then always
//      a permutation of the row's own.
//
// Bound: a row is read and written once; for the single-tile path (one row
// of up to 16,384 keys) one CTA does all the work, so the launch is bound by
// the 105-stage shared-memory network on one SM, not by memory.  Batched
// rows (T in the thousands) fill the card.  Rows of up to 2,048 slots use
// P / 2 threads, one compare-exchange each per stage.  Shared memory:
// P * (4 + 2 if payloads) bytes, at most 192 KB at P = 32768.
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_sort.cuh"

namespace tpusort {

template <bool IDX>
__global__ void __launch_bounds__(kThreads)
sort_tiles_kernel(Planes keys, Values vals, int K, int log_p) {
  extern __shared__ uint32_t smem[];
  const int P = 1 << log_p;
  const SmemTile<1, IDX, IDX> tile(smem, P);
  const size_t first = (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    tile.load(i, keys.in, first, i < K);
  }
  __syncthreads();

  block_sort(tile, log_p, 0);

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    keys.out[0][first + i] = tile.key[0][i];
    if (IDX) {
      const int src = tile.idx[i];
      for (int v = 0; v < vals.count; ++v) {
        vals.out[v][first + i] = vals.in[v][first + src];
      }
    }
  }
}

template <bool IDX>
int launch_sort_tiles(const Planes& keys, const Values& vals, int T, int K,
                      int P, cudaStream_t stream) {
  const int log_p = 31 - __builtin_clz(P);
  const size_t smem = SmemTile<1, IDX, IDX>::bytes(P);
  const int threads = P / 2 < kThreads ? P / 2 : kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      sort_tiles_kernel<IDX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_tiles_kernel<IDX><<<T, threads, smem, stream>>>(keys, vals, K, log_p);
  return (int)cudaGetLastError();
}

}  // namespace tpusort

// keys_in/keys_out: (T, K) row-major; vals_in/vals_out: n_vals (0-8) device
// pointers each, same shape.  P is the power of two >= K.  Returns a
// cudaError_t.
extern "C" int tpusort_sort_tiles(const void* keys_in, void* keys_out,
                                  const void* const* vals_in,
                                  void* const* vals_out, int n_vals, int T,
                                  int K, int P, void* stream) {
  using namespace tpusort;
  Planes keys;
  Values vals;
  if (!make_operands(&keys_in, &keys_out, 1, vals_in, vals_out, n_vals,
                     &keys, &vals)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_mode(1, n_vals > 0, [&](auto, auto idx) {
    return launch_sort_tiles<decltype(idx)::value>(keys, vals, T, K, P,
                                                   (cudaStream_t)stream);
  });
}
