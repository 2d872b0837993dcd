// K3: sort each row of (T, K) operands by operand 0, unsigned, unstable.
// K9, K10: the same row sort over 1-3 key planes with a validity source.
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
//
// K9 and K10 replace _counts_sort_kernel and _masked_sort_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles_counts and sort_tiles_masked: one
// kernel, sort_tiles_valid_kernel, whose load takes a slot's validity from
// a (T, K / q) counts table (slot i valid iff i % q < counts[t, i / q]; K9)
// or from a (T, K) byte mask (K10).  Invalid and pad slots become
// 0xFFFFFFFF in every key plane, the P slots are sorted lexicographically
// over the planes (merged from ascending runs of sorted_run slots where the
// caller says so), and all K slots are written back: the valid keys sorted
// at the head, all-ones behind them.  Payload words are gathered by the
// 16-bit slot index as in K2; behind the valid prefix they are unspecified.
// It is K2's load and network without the collapse, so the same bound: the
// network's shared-memory stages, not the 2 * K words a row moves.
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

template <int NK, bool IDX>
__global__ void __launch_bounds__(kThreads)
sort_tiles_valid_kernel(Planes planes, Values vals,
                        const int32_t* __restrict__ counts, int q,
                        const uint8_t* __restrict__ mask, int K, int log_p,
                        int log_run) {
  extern __shared__ uint32_t smem[];
  const int P = 1 << log_p;
  const SmemTile<NK, IDX> tile(smem, P);
  const size_t first = (size_t)blockIdx.x * K;
  const int32_t* cnt =
      counts != nullptr ? counts + (size_t)blockIdx.x * (K / q) : nullptr;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const bool valid =
        i < K && (cnt != nullptr ? (i % q) < cnt[i / q] : mask[first + i] != 0);
    tile.load(i, planes.in, first, valid);
  }
  __syncthreads();

  block_sort(tile, log_p, log_run);

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
#pragma unroll
    for (int p = 0; p < NK; ++p) planes.out[p][first + i] = tile.key[p][i];
    if (IDX) {
      // behind the valid prefix a slot may hold a pad's index (>= K)
      const size_t src = first + min((int)tile.idx[i], K - 1);
      for (int v = 0; v < vals.count; ++v) {
        vals.out[v][first + i] = vals.in[v][src];
      }
    }
  }
}

template <int NK, bool IDX>
int launch_sort_tiles_valid(const Planes& planes, const Values& vals,
                            const int32_t* counts, int q, const uint8_t* mask,
                            int T, int K, int P, int log_run,
                            cudaStream_t stream) {
  const int log_p = 31 - __builtin_clz(P);
  const size_t smem = SmemTile<NK, IDX>::bytes(P);
  const int threads = P / 2 < kThreads ? P / 2 : kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      sort_tiles_valid_kernel<NK, IDX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_tiles_valid_kernel<NK, IDX><<<T, threads, smem, stream>>>(
      planes, vals, counts, q, mask, K, log_p, log_run);
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

// K9 (counts != NULL: a (T, K / q) int32 table) and K10 (counts NULL: mask,
// (T, K) bytes, non-zero = valid).  keys_in/keys_out: n_planes (1-3) device
// pointers each, (T, K) row-major; vals_in/vals_out: n_vals (0-8).  P is
// the power of two >= K; sorted_run 0 or a power of two dividing K and
// P - K.  Returns a cudaError_t.
extern "C" int tpusort_sort_tiles_valid(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts, int q, const void* mask, int T, int K, int P,
    int sorted_run, void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  if (!make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals) ||
      (counts == nullptr) == (mask == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int log_run = sorted_run > 0 ? 31 - __builtin_clz(sorted_run) : 0;
  return dispatch_mode(n_planes, n_vals > 0, [&](auto nk, auto idx) {
    return launch_sort_tiles_valid<decltype(nk)::value, decltype(idx)::value>(
        planes, vals, (const int32_t*)counts, q, (const uint8_t*)mask, T, K,
        P, log_run, (cudaStream_t)stream);
  });
}
