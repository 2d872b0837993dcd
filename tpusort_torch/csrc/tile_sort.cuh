// Block-wide tile sort in shared memory, shared by the partition pass (K1)
// and the leaf (K2).
//
// Replaces the bitonic compare-exchange networks of the Pallas kernels
// (tpusort/kernels/bitonic.py: _sort_network, _merge_sorted_runs, the staged
// f*2^a merge).  The TPU networks were shaped by a VPU without gathers:
// every stage is a static roll over 128-lane rows.  Here a stage is one pass
// of independent compare-exchanges over a shared-memory array, one pair per
// thread per step, separated by __syncthreads().  This is the simple first
// version: every stage goes through shared memory; keeping the short-stride
// stages in registers and warp shuffles is later work.
#pragma once

#include <cstdint>

namespace tpusort {

constexpr int kThreads = 1024;

__device__ inline void cmp_swap(uint32_t* a, int i, int j) {
  const uint32_t x = a[i];
  const uint32_t y = a[j];
  if (x > y) {
    a[i] = y;
    a[j] = x;
  }
}

// Sort a[0, 2^log_n) ascending as uint32, with all threads of the block.
// The array must already consist of ascending runs of 2^log_run elements
// (log_run = 0: unsorted); only the merge levels above that run length are
// executed.  Each level merges pairs of ascending runs: a mirror step
// (i against the reflected partner in the doubled run) turns them into two
// bitonic halves split at the median, then half-cleaners finish each half.
// Ends with __syncthreads().
__device__ inline void block_sort(uint32_t* a, int log_n, int log_run) {
  const int half_n = 1 << (log_n - 1);
  for (int lk = log_run + 1; lk <= log_n; ++lk) {
    const int lh = lk - 1;
    for (int p = threadIdx.x; p < half_n; p += blockDim.x) {
      const int base = (p >> lh) << lk;
      const int off = p & ((1 << lh) - 1);
      cmp_swap(a, base + off, base + (1 << lk) - 1 - off);
    }
    __syncthreads();
    for (int lj = lh - 1; lj >= 0; --lj) {
      for (int p = threadIdx.x; p < half_n; p += blockDim.x) {
        const int i = ((p >> lj) << (lj + 1)) + (p & ((1 << lj) - 1));
        cmp_swap(a, i, i + (1 << lj));
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

}  // namespace tpusort
