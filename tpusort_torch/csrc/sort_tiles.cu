// K3: sort each row of (T, K) operands by operand 0, unsigned.
// K9, K10: the same row sort over 1-3 key planes with a validity source.
//
// Replaces the Pallas kernel _sort_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles, which the single-tile path
// (ops/small.py, inputs of up to 2^14 keys), sort_batched and the packed
// leaf run.  One CTA owns one row:
//
//   1. load the row's keys into shared memory, coalesced (16-byte loads
//      where the operand is aligned), and pad them virtually to
//      P = 2^ceil(log2 K) with 0xFFFFFFFF; with payloads a 16-bit slot
//      index rides the network;
//   2. sort the P slots ascending (reg_sort.cuh: the steps whose pairs lie
//      within a thread's E slots in registers, within a warp's 32 E slots
//      on shuffles, only the longer ones in shared memory); with payloads
//      equal keys compare by slot index, so the order is the stable one
//      and a pad slot (index 0xFFFF, reg_sort.cuh:kPadIndex) sorts after
//      every genuine 0xFFFFFFFF key and never lands inside [0, K);
//   3. write slots [0, K) of the keys; then each payload word: the row's
//      K words staged in shared memory (over the keys, now written),
//      gathered from there by the index and stored coalesced.  The payloads
//      written are always a permutation of the row's own.
//
// Bound: a row is read and written once, so batched rows are bound by the
// network's instructions (about log2(P)^2 / 2 compare-exchanges a slot),
// not by memory; the single-tile path (one row of up to 16,384 keys) runs
// on one SM, bound by its instructions too and by the chain of 105
// dependent steps.  The design answers both: most steps need no barrier
// and no shared memory (10 of 105 at P = 16384 with one or two words a
// slot), and the geometry (threads, slots a thread E, chunks; the
// wrapper's tile_sort_geometry) gives a 2,048-slot row 64-128 threads, so
// many rows share an SM.  Shared memory: P * (4 + 2 if payloads) bytes, at most
// 192 KB at P = 32768.
//
// K9 and K10 replace _counts_sort_kernel and _masked_sort_kernel behind
// tpusort/kernels/bitonic.py:sort_tiles_counts and sort_tiles_masked: one
// kernel, sort_tiles_valid_kernel, whose load takes a slot's validity from
// a (T, K / q) counts table (slot i valid iff i % q < counts[t, i / q]; K9)
// or from a (T, K) byte mask (K10).  Invalid and pad slots become
// 0xFFFFFFFF in every key plane, the P slots are sorted lexicographically
// over the planes, ties by slot index, an invalid slot's 0xFFFF (so it
// sorts after a valid all-ones key; merged from ascending runs of
// sorted_run slots where the caller says so; the index keeps a run
// ascending), and all K slots are written back: the valid keys sorted at
// the head, all-ones behind them.  Payload words are gathered by the
// index, clamped to K - 1, as in K3; behind the valid prefix they are
// unspecified.  The same network, so the same bound.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "reg_sort.cuh"
#include "operands.cuh"

namespace tpusort {

template <bool IDX, int E>
__global__ void __launch_bounds__(max_threads(1, IDX, E))
sort_tiles_kernel(Planes keys, Values vals, int K, int log_p, int chunks) {
  extern __shared__ uint32_t smem[];
  const int P = 1 << log_p;
  const RegTile<1, IDX> tile(smem, P);
  const size_t first = (size_t)blockIdx.x * K;
  load_row<E>(tile, keys.in, first, K, chunks, [](int) { return true; });
  __syncthreads();
  reg_block_sort<E>(tile, log_p, 0, chunks);
  store_row(tile, keys.out, first, K);
  if constexpr (IDX) {
    gather_payloads<E>(tile, vals, first, K, chunks, first, K);
  }
}

template <bool IDX, int E>
int launch_sort_tiles(const Planes& keys, const Values& vals, int T, int K,
                      int P, int threads, int chunks, size_t smem,
                      cudaStream_t stream) {
  const int log_p = 31 - __builtin_clz(P);
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err =
      allow_smem_once((const void*)sort_tiles_kernel<IDX, E>,
                      smem_cap<1, IDX>(), smem_set);
  if (err != cudaSuccess) return (int)err;
  sort_tiles_kernel<IDX, E><<<T, threads, smem, stream>>>(keys, vals, K,
                                                          log_p, chunks);
  return (int)cudaGetLastError();
}

template <int NK, bool IDX, int E>
__global__ void __launch_bounds__(max_threads(NK, IDX, E))
sort_tiles_valid_kernel(Planes planes, Values vals,
                        const int32_t* __restrict__ counts, int q,
                        const uint8_t* __restrict__ mask, int K, int log_p,
                        int log_run, int chunks) {
  extern __shared__ uint32_t smem[];
  const int P = 1 << log_p;
  const RegTile<NK, IDX> tile(smem, P);
  const size_t first = (size_t)blockIdx.x * K;
  // one plane with the index at E = 16 fills a thread's 64 registers
  // (slot_words == kRegWords): there 16 words of loads in flight, beside
  // the pad index's select, spill, and 8 do not
  constexpr int kFly =
      NK == 1 && IDX && slot_words(NK, IDX, E) == kRegWords ? 8 : 16;
  if (counts != nullptr) {
    const int32_t* cnt = counts + (size_t)blockIdx.x * (K / q);
    load_row<E, kFly>(tile, planes.in, first, K, chunks,
                      [=](int i) { return (i % q) < cnt[i / q]; });
  } else {
    const uint8_t* m = mask + first;
    load_row<E, kFly>(tile, planes.in, first, K, chunks,
                      [=](int i) { return m[i] != 0; });
  }
  __syncthreads();
  reg_block_sort<E>(tile, log_p, log_run, chunks);
  store_row(tile, planes.out, first, K);
  if constexpr (IDX) {
    gather_payloads<E>(tile, vals, first, K, chunks, first, K);
  }
}

template <int NK, bool IDX, int E>
int launch_sort_tiles_valid(const Planes& planes, const Values& vals,
                            const int32_t* counts, int q, const uint8_t* mask,
                            int T, int K, int P, int log_run, int threads,
                            int chunks, size_t smem, cudaStream_t stream) {
  const int log_p = 31 - __builtin_clz(P);
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err =
      allow_smem_once((const void*)sort_tiles_valid_kernel<NK, IDX, E>,
                      smem_cap<NK, IDX>(), smem_set);
  if (err != cudaSuccess) return (int)err;
  sort_tiles_valid_kernel<NK, IDX, E><<<T, threads, smem, stream>>>(
      planes, vals, counts, q, mask, K, log_p, log_run, chunks);
  return (int)cudaGetLastError();
}

}  // namespace tpusort

// keys_in/keys_out: (T, K) row-major; vals_in/vals_out: n_vals (0-8) device
// pointers each, same shape.  P is the power of two >= K; threads, slots
// (E) and smem the geometry of kernels/bitonic.py:tile_sort_geometry; the
// outputs 16-byte aligned.  Returns a cudaError_t (cudaErrorInvalidValue
// for a geometry the kernel does not take or an unaligned output).
extern "C" int tpusort_sort_tiles(const void* keys_in, void* keys_out,
                                  const void* const* vals_in,
                                  void* const* vals_out, int n_vals, int T,
                                  int K, int P, int threads, int slots,
                                  int smem, void* stream) {
  using namespace tpusort;
  Planes keys;
  Values vals;
  int chunks = 0;
  if (!make_operands(&keys_in, &keys_out, 1, vals_in, vals_out, n_vals,
                     &keys, &vals) ||
      !aligned16(&keys_out, 1) || !aligned16(vals_out, n_vals) ||
      !reg_geometry_ok(P, threads, slots, (size_t)smem,
                       (size_t)P * (4 + (n_vals > 0 ? 2 : 0)), &chunks)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_slots(slots, [&](auto e) {
    return dispatch_mode(1, n_vals > 0, [&](auto, auto idx) {
      constexpr bool kIdx = decltype(idx)::value;
      constexpr int kE = decltype(e)::value;
      if constexpr (!fits_registers(1, kIdx, kE)) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (threads > max_threads(1, kIdx, kE)) {
          return (int)cudaErrorInvalidValue;
        }
        return launch_sort_tiles<kIdx, kE>(keys, vals, T, K, P, threads,
                                           chunks, (size_t)smem,
                                           (cudaStream_t)stream);
      }
    });
  });
}

// K9 (counts != NULL: a (T, K / q) int32 table) and K10 (counts NULL: mask,
// (T, K) bytes, non-zero = valid).  keys_in/keys_out: n_planes (1-3) device
// pointers each, (T, K) row-major; vals_in/vals_out: n_vals (0-8).  P is
// the power of two >= K; sorted_run 0 or a power of two dividing K and
// P - K; threads, slots, smem and the outputs as for tpusort_sort_tiles.
// Returns a cudaError_t.
extern "C" int tpusort_sort_tiles_valid(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts, int q, const void* mask, int T, int K, int P,
    int sorted_run, int threads, int slots, int smem, void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  int chunks = 0;
  if (!make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals) ||
      (counts == nullptr) == (mask == nullptr) ||
      !aligned16(keys_out, n_planes) || !aligned16(vals_out, n_vals) ||
      !reg_geometry_ok(P, threads, slots, (size_t)smem,
                       (size_t)P * (4 * n_planes + (n_vals > 0 ? 2 : 0)),
                       &chunks)) {
    return (int)cudaErrorInvalidValue;
  }
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
        return launch_sort_tiles_valid<kNk, kIdx, kE>(
            planes, vals, (const int32_t*)counts, q, (const uint8_t*)mask,
            T, K, P, log_run, threads, chunks, (size_t)smem,
            (cudaStream_t)stream);
      }
    });
  });
}
