// A blocked stable rank of a tile's digits, and the staging of a tile's
// words by destination: the parts that the general partition pass (K1c;
// csrc/partition_general.cu) and the tile partition by a sortkey (K8;
// csrc/partition_tiles.cu) share.  One CTA of kRankThreads owns one K-slot
// tile (K a power of two, 128 .. 32768):
//
//   - the walk (rank_walk).  Each walking warp (min(16, K / 32) of them)
//     owns a contiguous span of K / warps slots; lane l's step r takes slot
//     span_start + 32 r + l, so the loads coalesce and (r, lane) is slot
//     order.  A lane loads the words of kRankBatch steps before it ranks any
//     of them (a load used at once costs a trip to device memory a step).
//     Ballots on the digit's bits group the lanes of a step by digit
//     (match_digit): a lane's warp-local rank is its group leader's count of
//     the digit so far plus the group's lanes below it, and the leader adds
//     the group's size to the warp's count of the digit.  No atomics, so
//     the ranks are deterministic and the order stable;
//   - the scan (scan_warp_counts).  For each digit, an exclusive scan of
//     its per-warp counts in warp order (digit-major: thread d walks the 16
//     warps) gives each warp's first rank within the digit, and the digit's
//     total.  A slot's rank within its digit is then its warp's offset plus
//     its warp-local rank;
//   - the staging (stage_row): a tile row's words scattered into a
//     shared-memory buffer at each slot's destination, read with 16-byte
//     loads where the row is aligned, kStageLoads of them in flight a thread.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "operands.cuh"

namespace tpusort {

constexpr int kRankThreads = 512;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankBatch = 8;      // digits a lane loads before it ranks them
constexpr int kStageLoads = 4;     // 16-byte loads a thread has in flight
constexpr uint16_t kNoSlot = 0xFFFF;

// The lanes of the warp whose digit equals this lane's: one ballot per bit
// of the digits (as CUB's MatchAny does), not __match_any_sync.
__device__ __forceinline__ unsigned match_digit(uint32_t d, int bits) {
  unsigned peers = 0xFFFFFFFFu;
  for (int b = 0; b < bits; ++b) {
    const bool set = (d >> b) & 1u;
    const unsigned on = __ballot_sync(0xFFFFFFFFu, set);
    peers &= set ? on : ~on;
  }
  return peers;
}

// The warps that walk a K-slot tile; each owns K / rank_walkers(K) slots,
// a multiple of 32.
__host__ __device__ constexpr int rank_walkers(int K) {
  return K / 32 < kRankWarps ? K / 32 : kRankWarps;
}

// The walk over slots [0, K): src.load(i) issues slot i's loads (a
// Src::Raw), src.digit(raw, i) gives its digit, below 2^bits; the warp's
// counts are wcount[warp * bins + digit], zero on entry.  Calls emit(i,
// digit, warp-local rank) for every slot, in slot order within a warp.
// Does not synchronise the block.
template <class Src, class Emit>
__device__ __forceinline__ void rank_walk(uint16_t* wcount, int bins, int K,
                                          int bits, const Src& src,
                                          Emit&& emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int walkers = rank_walkers(K);
  if (warp >= walkers) return;
  const int span = K / walkers;
  uint16_t* wc = wcount + warp * bins;
  const unsigned lower = (1u << lane) - 1u;
  for (int r0 = warp * span; r0 < (warp + 1) * span; r0 += 32 * kRankBatch) {
    // every load of the batch first, so that they are in flight together
    typename Src::Raw raw[kRankBatch];
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) {
      raw[k] = typename Src::Raw{};
      if (32 * k < span) raw[k] = src.load(r0 + 32 * k + lane);
    }
    uint32_t d[kRankBatch];
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) {
      d[k] = src.digit(raw[k], r0 + 32 * k + lane);
    }
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) {
      if (32 * k >= span) break;           // the warp's span may be shorter
      const unsigned peers = match_digit(d[k], bits);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader) {
        before = wc[d[k]];
        wc[d[k]] = (uint16_t)(before + __popc(peers));
      }
      before = __shfl_sync(0xFFFFFFFFu, before, leader);
      emit(r0 + 32 * k + lane, d[k], before + __popc(peers & lower));
      __syncwarp();              // the next step's leaders read these counts
    }
  }
}

// After the walk and a barrier: each digit's per-warp counts become the
// exclusive scan over the warps, and hist[d] the digit's total, for the
// digits [0, bins).  Does not synchronise.
__device__ __forceinline__ void scan_warp_counts(uint16_t* wcount, int bins,
                                                 int* hist) {
  for (int d = threadIdx.x; d < bins; d += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kRankWarps; ++w) {
      const int c = wcount[w * bins + d];
      wcount[w * bins + d] = (uint16_t)run;
      run += c;
    }
    hist[d] = run;
  }
}

// stage[slot[i]] = in[i] for each i in [0, K) whose slot[i] is not
// kNoSlot: 16-byte loads where `in` is aligned (K is a multiple of 4),
// else 4-byte ones.  Does not synchronise.
__device__ __forceinline__ void stage_row(const uint32_t* in, int K,
                                          const uint16_t* slot,
                                          uint32_t* stage) {
  if ((reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    for (int g0 = 4 * threadIdx.x; g0 < K;
         g0 += 4 * kStageLoads * kRankThreads) {
      uint4 w[kStageLoads];
#pragma unroll
      for (int b = 0; b < kStageLoads; ++b) {
        const int g = g0 + 4 * kRankThreads * b;
        if (g < K) w[b] = *reinterpret_cast<const uint4*>(in + g);
      }
#pragma unroll
      for (int b = 0; b < kStageLoads; ++b) {
        const int g = g0 + 4 * kRankThreads * b;
        if (g < K) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint16_t dst = slot[g + kk];
            if (dst != kNoSlot) stage[dst] = word(w[b], kk);
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const uint16_t dst = slot[i];
      if (dst != kNoSlot) stage[dst] = in[i];
    }
  }
}

}  // namespace tpusort
