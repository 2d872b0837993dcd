// The merge body of K2 (csrc/bitonic.cu), and of K1 and K1b
// (csrc/partition.cu: partition_sorted): a tile that arrives as sorted
// runs is merged over the runs' valid prefixes, where the network body
// sorts the whole tile padded to a power of two.  Steps 1-3 below are
// merge_tile, which both kernels run; step 4 is K2's (K1 histograms or
// cuts the merged slots and emits its runs from them).  K1's and K1b's
// runs body (pass 0, whose tile arrives unsorted: csrc/partition.cu:
// sort_runs) fills the same buffer with each warp's sorted run in place of
// step 1 and then runs steps 2 and 3.
//
// A CTA owns one tile of K slots, cut into runs = K / L runs of L slots (L
// the wrapper's merge run: a power of two of at least 128 dividing the
// counts table's q and the caller's sorted_run; kernels/bitonic.py:
// leaf_merge_geometry).  Run j holds n_j valid slots as a prefix, n_j its
// count from the table clamped to [0, L] (the validity rule of load_row,
// so a poisoned or unclamped count never reads past the run), ascending
// lexicographically over the planes; with payloads the 16-bit slot index
// rides under the last plane (reg_sort.cuh: RegElem), and as a run's slots
// increase along it, (planes, index) ascends strictly.
//
//   1. load_runs: one warp scans the n_j into the runs' starts in a compact
//      buffer; then the threads copy each run's valid prefix, and nothing
//      else, into it (16-byte loads where every plane is aligned; a vector
//      wholly past its run's count is not read).  No sentinel enters: the
//      buffer holds nv = sum n_j slots as ascending runs.
//   2. chain_runs: one warp drops each boundary where the slot before it
//      is not greater than the slot at it, so runs that continue each
//      other become one (the skew tier's emitted runs of 640 slots arrive
//      as five runs of 128: 120 runs a tile become about 24).
//   3. merge_levels: at level l, runs 2p and 2p+1 of 2^l runs each merge
//      into one, ceil(log2(runs)) levels (5 for 24 runs).  Each thread
//      owns per = ceil(nv / threads) consecutive outputs of the level: a
//      binary search over the run starts finds the pair of its first
//      output, a merge-path binary search on that output's diagonal splits
//      the pair, and the thread merges its outputs serially, into the next
//      pair where its span crosses one.  Equal keys come from the earlier
//      run first, which the (planes, index) order gives by itself, so the
//      result is the network's (key, slot) order, bit for bit.  The
//      outputs' key words wait in registers: a barrier, every thread
//      writes them back over the same buffer, a barrier, so one copy of the
//      key planes does; their slot indices go at once to a second index
//      array, and the two arrays change roles each level.
//   4. the epilogue of the network body: slots [nv, c) (only where a
//      caller's counts and offsets disagree) become invalid slots, the
//      dense stores of the key planes, then each payload word staged over
//      plane 0 and gathered by the slot index (clamped to K - 1).
//
// Layout: slot s at word s + s / 32 of each plane (a pad word after every
// 32 slots), so a warp's blocked writes (lane i's outputs at i * per + k)
// and its consecutive reads hit a bank at most twice for every per but 31,
// which is taken as 32.  Shared memory: (K + K / 32) * (4 * planes + 4 if
// payloads) bytes, then the runs + 1 starts and the count of runs left.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "operands.cuh"
#include "reg_sort.cuh"

namespace tpusort {

constexpr int kMergeMinRun = 128;    // the shortest run the merge body takes
constexpr int kMergeMaxRuns = 256;   // the most runs a tile (one warp's scan)

// The slots a thread sorts in its warp's run of 32 of them, where a tile
// arrives unsorted (K1's and K1b's runs body, csrc/partition.cu:
// sort_runs; the packed leaf's, csrc/sort_tiles.cu): 32 where a slot is
// one word in registers (one plane, no payload), 16 where it is two or
// three (a plane and the index packed under it, two planes, or two planes
// and the index); and the largest tile those bodies take.
__host__ __device__ constexpr int runs_slots(int nk, bool idx) {
  return nk + (idx ? 1 : 0) == 1 ? 32 : 16;
}
constexpr int kRunsMaxTile = 16384;

// The word of compact slot s in each plane of the merge buffer.
__host__ __device__ constexpr int merge_word(int s) { return s + (s >> 5); }

// A merge thread holds its outputs' key words in registers, E of each of
// the NK planes (the slot index goes straight to shared memory), and the
// merge's own state besides, about 20 registers and three slots.  E is
// merge_slots(NK), 48 key words at most, and an instance runs up to
// kMergeThreads threads (80 registers), so none spills; a tile that needs
// more threads takes the network body.
constexpr int kMergeThreads = 768;

__host__ __device__ constexpr int merge_slots(int nk) {
  return nk == 1 ? 32 : nk == 2 ? 24 : 16;
}

// The merge buffer in shared memory: NK planes of merge_word(K) words,
// then (IDX) two arrays of as many uint16 indices, the one a level reads
// and the one it writes, then the runs + 1 starts and the count of runs
// left after chain_runs.
template <int NK, bool IDX>
struct MergeTile {
  using Elem = RegElem<NK, IDX>;
  uint32_t* key[NK];
  uint16_t* idx;                       // the slots' indices
  uint16_t* out_idx;                   // a level's outputs' indices
  int* starts;

  // K is a multiple of 128, so a plane's words (K * 33 / 32) are a
  // multiple of 4 and the index arrays' bytes too.
  static constexpr size_t bytes(int K, int runs) {
    return (size_t)merge_word(K) * (NK * sizeof(uint32_t) +
                                    (IDX ? 2 * sizeof(uint16_t) : 0)) +
           (size_t)(runs + 2) * sizeof(int);
  }

  __device__ MergeTile(uint32_t* base, int K) {
    const size_t w = (size_t)merge_word(K);
#pragma unroll
    for (int p = 0; p < NK; ++p) key[p] = base + (size_t)p * w;
    idx = IDX ? reinterpret_cast<uint16_t*>(base + (size_t)NK * w) : nullptr;
    out_idx = IDX ? idx + w : nullptr;
    starts = reinterpret_cast<int*>(base + (size_t)(NK + (IDX ? 1 : 0)) * w);
  }

  __device__ __forceinline__ Elem get(int s) const {
    const int w = merge_word(s);
    Elem e;
#pragma unroll
    for (int p = 0; p < NK - 1; ++p) e.hi[p] = key[p][w];
    if constexpr (IDX) {
      e.lo = (uint64_t)key[NK - 1][w] << 16 | idx[w];
    } else {
      e.lo = key[NK - 1][w];
    }
    return e;
  }

  // slot s from its NK words and its index
  __device__ __forceinline__ void set(int s, const uint32_t (&v)[NK],
                                      uint16_t i) const {
    const int w = merge_word(s);
#pragma unroll
    for (int p = 0; p < NK; ++p) key[p][w] = v[p];
    if (IDX) idx[w] = i;
  }

  // slot s from a register element (the index under the last plane)
  __device__ __forceinline__ void put(int s, const Elem& e) const {
    const int w = merge_word(s);
#pragma unroll
    for (int p = 0; p < NK - 1; ++p) key[p][w] = e.hi[p];
    if constexpr (IDX) {
      key[NK - 1][w] = (uint32_t)(e.lo >> 16);
      idx[w] = (uint16_t)e.lo;
    } else {
      key[NK - 1][w] = e.lo;
    }
  }
};

// One warp (the block's first) writes the runs' starts in the compact
// buffer: starts[j] = count(0) + ... + count(j - 1) for j <= runs (at most
// kMergeMaxRuns).  Each lane reads its runs' counts before it writes their
// starts, so count may read the starts array itself.  Does not
// synchronise.
template <int NK, bool IDX, class Count>
__device__ __forceinline__ void scan_starts(const MergeTile<NK, IDX>& t,
                                            int runs, Count count) {
  const int tid = threadIdx.x;
  if (tid < 32) {                       // up to 8 runs a lane
    constexpr int kPer = kMergeMaxRuns / 32;
    const int per = (runs + 31) >> 5;
    const int j0 = tid * per;
    int n[kPer];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      n[k] = k < per && j0 + k < runs ? count(j0 + k) : 0;
      sum += n[k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (tid >= d) incl += y;
    }
    int s = incl - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < per && j0 + k < runs) t.starts[j0 + k] = s;
      s += n[k];
    }
    if (tid == 31) t.starts[runs] = incl;
  }
}

// Step 1: the runs' starts, then each run's valid prefix from the planes
// at src[p] + first (run j at tile slots [j * L, j * L + L), L = 2^log_l,
// count(j) its valid slots in [0, L]).  Returns nv; ends synchronised.
template <int E, int NK, bool IDX, class Count>
__device__ int load_runs(const MergeTile<NK, IDX>& t,
                         const uint32_t* const* src, size_t first, int K,
                         int log_l, int runs, Count count) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  scan_starts(t, runs, count);
  __syncthreads();
  const int mask = (1 << log_l) - 1;
  bool vec = true;
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    vec = vec && ((reinterpret_cast<uintptr_t>(src[p] + first) & 15) == 0);
  }
  if (vec) {
    // vectors of 4 slots (L is a multiple of 4, so one run each), a batch
    // of loads in flight before any is written
    constexpr int kB = 4 >> (NK - 1) > 0 ? 4 >> (NK - 1) : 1;
    for (int g = 0; g * nt * 4 < K; g += kB) {
      uint4 w[NK][kB];
      int dst[kB], m[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = ((g + b) * nt + tid) * 4;
        m[b] = 0;
        dst[b] = 0;
        if (i < K) {
          const int j = i >> log_l;
          const int o = i & mask;
          const int st = t.starts[j];
          const int left = t.starts[j + 1] - st - o;
          m[b] = left < 0 ? 0 : (left > 4 ? 4 : left);
          dst[b] = st + o;
        }
        if (m[b] > 0) {
#pragma unroll
          for (int p = 0; p < NK; ++p) {
            w[p][b] = *reinterpret_cast<const uint4*>(src[p] + first + i);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = ((g + b) * nt + tid) * 4;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < m[b]) {
            uint32_t v[NK];
#pragma unroll
            for (int p = 0; p < NK; ++p) v[p] = word(w[p][b], kk);
            t.set(dst[b] + kk, v, (uint16_t)(i + kk));
          }
        }
      }
    }
  } else {
    for (int i = tid; i < K; i += nt) {
      const int j = i >> log_l;
      const int o = i & mask;
      const int st = t.starts[j];
      if (o < t.starts[j + 1] - st) {
        uint32_t v[NK];
#pragma unroll
        for (int p = 0; p < NK; ++p) v[p] = src[p][first + i];
        t.set(st + o, v, (uint16_t)i);
      }
    }
  }
  __syncthreads();
  return t.starts[runs];
}

// Step 1b: the loaded runs cut only where their order breaks.  A boundary
// between two runs goes where the slot before it is not greater than the
// slot at it (the two runs, or an empty run, continue each other: a last
// pass's emitted run longer than L is such a chain of L-runs), and the
// starts left are compacted.  Returns the runs left; ends synchronised.
template <int NK, bool IDX>
__device__ int chain_runs(const MergeTile<NK, IDX>& t, int runs, int nv) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    constexpr int kPer = kMergeMaxRuns / 32;
    const int per = (runs + 31) >> 5;
    const int j0 = tid * per;
    int at[kPer];
    bool cut[kPer];
    int n = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + k;
      at[k] = 0;
      cut[k] = false;
      if (k < per && j >= 1 && j < runs) {
        at[k] = t.starts[j];
        cut[k] = at[k] > 0 && at[k] < nv && at[k] != t.starts[j - 1] &&
                 greater(t.get(at[k] - 1), t.get(at[k]));
      }
      n += cut[k] ? 1 : 0;
    }
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (tid >= d) incl += y;
    }
    __syncwarp();                        // every lane has read its starts
    int o = incl - n + 1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (cut[k]) t.starts[o++] = at[k];
    }
    if (tid == 31) {
      t.starts[incl + 1] = nv;
      t.starts[runs + 1] = incl + 1;     // the runs left
    }
  }
  __syncthreads();
  return t.starts[runs + 1];
}

// a if take_a, else b, word by word: a select of the two whole elements
// (take_a ? a : b) is compiled as a select of their addresses, which puts
// both in local memory.
template <int NK, bool IDX>
__device__ __forceinline__ RegElem<NK, IDX> pick(bool take_a,
                                                 const RegElem<NK, IDX>& a,
                                                 const RegElem<NK, IDX>& b) {
  RegElem<NK, IDX> e;
#pragma unroll
  for (int p = 0; p < NK - 1; ++p) e.hi[p] = take_a ? a.hi[p] : b.hi[p];
  e.lo = take_a ? a.lo : b.lo;
  return e;
}

// A thread's outputs of a level: the key words in registers until the
// level's barrier; (IDX) the index written to the level's output array at
// once, which no thread reads during the level.
template <int E, int NK, bool IDX>
struct MergeOut {
  uint32_t key[NK][E];

  // output k (a constant once unrolled), slot s of the level, is e
  __device__ __forceinline__ void take(const MergeTile<NK, IDX>& t, int k,
                                       int s, const RegElem<NK, IDX>& e) {
#pragma unroll
    for (int p = 0; p < NK - 1; ++p) key[p][k] = e.hi[p];
    if constexpr (IDX) {
      key[NK - 1][k] = (uint32_t)(e.lo >> 16);
      t.out_idx[merge_word(s)] = (uint16_t)e.lo;
    } else {
      key[NK - 1][k] = (uint32_t)e.lo;
    }
  }

  // output k's key words to slot s of the buffer
  __device__ __forceinline__ void put(const MergeTile<NK, IDX>& t, int s,
                                      int k) const {
    const int w = merge_word(s);
#pragma unroll
    for (int p = 0; p < NK; ++p) t.key[p][w] = key[p][k];
  }
};

// Outputs [g0, g0 + n) of level l (n >= 1) into out: the merge of runs 2p
// and 2p + 1 of 2^l loaded runs each, for each pair p its outputs span.
template <int E, int NK, bool IDX>
__device__ __forceinline__ void merge_span(const MergeTile<NK, IDX>& t,
                                           int runs, int l, int g0, int n,
                                           int K, MergeOut<E, NK, IDX>& out) {
  using Elem = RegElem<NK, IDX>;
  // the start of loaded run r, the end of the buffer past the last one
  const auto st = [&](int r) { return t.starts[r < runs ? r : runs]; };
  const int w = 1 << l;
  // the last pair that starts at or before g0 (an empty pair before it
  // starts there too, and ends there)
  int lo = 0;
  int hi = (runs - 1) / (2 * w);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (st(2 * mid * w) <= g0) lo = mid; else hi = mid - 1;
  }
  int p = lo;
  const int a = st(2 * p * w);
  int am = st((2 * p + 1) * w);
  int be = st((2 * p + 2) * w);
  // merge path: x of the pair's first d outputs come from run A = [a, am)
  const int d = g0 - a;
  int x = d - (be - am) > 0 ? d - (be - am) : 0;
  int y = d < am - a ? d : am - a;
  while (x < y) {
    const int mid = (x + y) >> 1;
    if (greater(t.get(a + mid), t.get(am + d - 1 - mid))) y = mid;
    else x = mid + 1;
  }
  int ia = a + x;
  int ib = am + d - x;
  Elem ea = t.get(ia < K ? ia : K - 1);
  Elem eb = t.get(ib < K ? ib : K - 1);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (k < n) {
      if (g0 + k == be) {                 // this pair is done: the next
        do {                              // (past any empty one)
          ++p;
          ia = be;
          am = st((2 * p + 1) * w);
          be = st((2 * p + 2) * w);
        } while (ia == be);
        ib = am;
        ea = t.get(ia < K ? ia : K - 1);
        eb = t.get(ib < K ? ib : K - 1);
      }
      const bool take_a = ia < am && (ib >= be || !greater(ea, eb));
      out.take(t, k, g0 + k, pick(take_a, ea, eb));
      if (take_a) ++ia; else ++ib;
      const int nx = take_a ? ia : ib;
      const Elem e = t.get(nx < K ? nx : K - 1);
      if (take_a) ea = e; else eb = e;
    }
  }
}

// Step 2: the loaded runs merged into one, in place (the key words; the
// indices alternate between the two arrays).  Expects the block
// synchronised; ends synchronised.  Returns the tile with the indices'
// final array as its idx.
template <int E, int NK, bool IDX>
__device__ MergeTile<NK, IDX> merge_levels(MergeTile<NK, IDX> t, int runs,
                                           int nv, int K) {
  const int nt = blockDim.x;
  int per = (nv + nt - 1) / nt;          // <= E: threads * E >= K >= nv
  if (per == 31) per = 32;               // 31 would hit one bank 32 times
  const int g0 = (int)threadIdx.x * per;
  const int n = nv - g0 < per ? nv - g0 : per;
  for (int l = 0; (1 << l) < runs; ++l) {
    MergeOut<E, NK, IDX> out;
    if (n > 0) merge_span<E>(t, runs, l, g0, n, K, out);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (k < n) out.put(t, g0 + k, k);
    }
    if constexpr (IDX) {
      uint16_t* const i = t.idx;
      t.idx = t.out_idx;
      t.out_idx = i;
    }
    __syncthreads();
  }
  return t;
}

// Steps 1-3 for one tile of K slots at the planes src[p] + first, in runs
// of L = 2^log_l: run j's valid prefix is count(j) = cnt[jL / q] - jL % q
// clamped to [0, L] (cnt: the tile's row of the (T, K / q) counts; L
// divides q, so one entry a run).  Sets *nv to the tile's valid slots and
// returns the merged tile: sorted slot s < nv at merge_word(s) of each
// plane, its input slot at idx.  Ends synchronised.  K2's merge body
// (merge_leaf) and K1's and K1b's (csrc/partition.cu) run it.
template <int E, int NK, bool IDX>
__device__ MergeTile<NK, IDX> merge_tile(uint32_t* smem,
                                         const uint32_t* const* src,
                                         size_t first, const int32_t* cnt,
                                         int q, int K, int log_l, int* nv) {
  const MergeTile<NK, IDX> loaded(smem, K);
  const int runs = K >> log_l;
  const int L = 1 << log_l;
  const int n = load_runs<E>(loaded, src, first, K, log_l, runs, [=](int j) {
    const int i = j << log_l;
    const int v = cnt[i / q] - i % q;
    return v < 0 ? 0 : (v > L ? L : v);
  });
  *nv = n;
  return merge_levels<E>(loaded, chain_runs(loaded, runs, n), n, K);
}

// Host side: true if (merge_run, threads, slots, smem) is a merge geometry
// for tiles of K slots with a counts table of q-slot chunks
// (kernels/bitonic.py:leaf_merge_geometry): runs of a power of two from
// kMergeMinRun dividing q and K, at most kMergeMaxRuns of them, the
// planes' merge_slots, the fewest warps that cover K at most
// kMergeThreads threads, and smem the buffer's bytes, beside `extra`
// bytes of static shared memory within a CTA.
inline bool merge_geometry_ok(int K, int q, int merge_run, int n_planes,
                              bool has_values, int threads, int slots,
                              size_t smem, size_t extra) {
  if (merge_run <= 0 || (merge_run & (merge_run - 1)) ||
      merge_run < kMergeMinRun || q <= 0 || K <= 0 || K > 32768 ||
      K % merge_run || q % merge_run || K / merge_run > kMergeMaxRuns ||
      n_planes < 1 || n_planes > 3) {
    return false;
  }
  const size_t bytes =
      (size_t)merge_word(K) * (4 * n_planes + (has_values ? 4 : 0)) +
      (size_t)(K / merge_run + 2) * 4;
  return slots == merge_slots(n_planes) && threads >= 32 &&
         threads % 32 == 0 && threads <= kMergeThreads &&
         (long long)threads * slots >= K && smem == bytes &&
         smem + extra <= (size_t)kMaxSmem;
}

// The merge body for one tile: steps 1-3, the c dense slots of every
// operand to out + dst.  cnt: the tile's row of the (T, K / q) counts;
// chunks: 1 (threads * E >= K), a launch argument, so that the payloads'
// staging loop is not unrolled into addresses that stay live across it.
template <int E, int NK, bool IDX>
__device__ void merge_leaf(uint32_t* smem, const Planes& planes,
                           const Values& vals, const int32_t* cnt, int q,
                           int K, int log_l, int chunks, size_t first,
                           size_t dst, int c) {
  int nv;
  const MergeTile<NK, IDX> t =
      merge_tile<E, NK, IDX>(smem, planes.in, first, cnt, q, K, log_l, &nv);
  for (int i = nv + (int)threadIdx.x; i < c; i += blockDim.x) {
    uint32_t v[NK];
#pragma unroll
    for (int p = 0; p < NK; ++p) v[p] = kSentinel;
    t.set(i, v, kPadIndex);
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    store_words(planes.out[p] + dst, c,
                [&](int i) { return t.key[p][merge_word(i)]; });
  }
  if constexpr (IDX) {
    uint32_t* buf = t.key[0];            // its keys are stored
    for (int v = 0; v < vals.count; ++v) {
      __syncthreads();
      stage_row<E>(buf, vals.in[v] + first, K, chunks);
      __syncthreads();
      store_words(vals.out[v] + dst, c, [&](int i) {
        const int s = t.idx[merge_word(i)];
        return buf[s < K ? s : K - 1];
      });
    }
  }
}

}  // namespace tpusort
