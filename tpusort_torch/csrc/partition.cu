// K1 and K1b: one fused MSD partition pass, raw-key mode: 1-3 key planes,
// payloads riding with their keys; K1b cuts the runs at splitters instead
// of digits.
//
// Replaces the raw-key branch of the Pallas kernel _fused_kernel behind
// tpusort/kernels/partition.py:partition_pass_fused, with and without its
// splitter mode.  One CTA owns one K-element tile (K = 16384 on the main
// path).  The kernel has three bodies, one __global__ (two template
// flags, RUNS before MERGE), and the wrapper picks one from the call's
// shape alone (kernels/partition.py: partition_runs_geometry, then
// partition_merge_geometry):
//
// * the runs body (sort_runs), where the tile does not arrive as sorted
//   runs (pass 0, the strided feed's pass 0) and has one or two key
//   planes: each warp sorts its own 32 E slots in registers and on
//   shuffles (reg_sort.cuh: warp_sort, no shared-memory step), keeps its
//   run's valid prefix in the merge buffer (the invalid slots sort to the
//   run's end and are dropped), and merge_runs.cuh's chain_runs and
//   merge_levels merge the runs as the merge body does;
// * the network body, where a tile neither arrives as sorted runs under a
//   counts table nor fits the runs body (3 planes; the emit-only mode,
//   sorted_run = K; a sorted run without a counts table) or the merge
//   does not fit (3 planes at 16,384 slots), laid out as the
//   row tile sorts lay a row out (kernels/bitonic.py:tile_sort_geometry:
//   threads x E slots a thread x chunks = K; 512 x 32 for one plane):
//   1. load the tile's key planes (reg_sort.cuh:load_row, 16-byte loads)
//      into shared memory; a slot is valid iff its global index < n
//      (pass 0) or slot % q_in < counts_in[t, slot / q_in] (later passes);
//      invalid slots become 0xFFFFFFFF in every plane, which sorts last and
//      ties only equal keys, so the keys-only multiset stays exact; with
//      payloads an invalid slot's index is 0xFFFF (reg_sort.cuh:kPadIndex),
//      so it sorts after a valid all-ones key too and never enters a run;
//   2. sort the tile ascending, lexicographically over the planes
//      (reg_sort.cuh:reg_block_sort: the steps inside a thread's E slots in
//      registers, inside a warp's 32 E on shuffles, only the longer ones in
//      shared memory; merge levels above sorted_run only, none in the
//      emit-only mode, sorted_run = K); with payloads a 16-bit slot index
//      is packed under the last plane, so equal keys keep their slot order:
//      the tile's order is the stable one (the contract allows any order
//      of ties; the plain version is stable too, so payloads equal it even
//      on tied keys);
// * the merge body, where a later pass's tile arrives as the previous
//   pass's sorted runs (sorted_run > 0 with a counts table): steps 1 and
//   2 become K2's merge (merge_runs.cuh: merge_tile):
//   each run's valid prefix alone loaded into a compact buffer, runs that
//   continue each other chained, and pairwise merges by merge path, the
//   slot index under the last plane; no sentinel enters, and the nv
//   merged slots are the network's first nv slots, bit for bit.
//
// All three then (partition_sorted for the runs and merge bodies):
//   3. K1: histogram the digit bits [lo_bit, lo_bit + width) of the sorted
//      tile, counted across the planes (plane 0 the most significant 32
//      bits), with warp-aggregated shared atomics (sorted input gives ~one
//      atomic per warp step); start[d] = #(digit < d), count[d] = start[d+1]
//      - start[d] and, for the top digit, n_valid - start[R-1].  The runs
//      and merge bodies count their nv slots and add the network's K - nv
//      sentinels to the all-ones digit.
//      K1b (splitter_cuts): run d holds the keys between splitters d and
//      d+1, so the sorted tile's runs are contiguous and only the R-1 cut
//      points are chosen, as the Pallas kernel chooses them (bit for bit:
//      the engine compares counts exactly); its ranks count the sentinels
//      as the Pallas kernel does, which the merge body adds to an
//      all-ones splitter's rank;
//   4. write run d of tile t = seg * t_seg + j to
//      out[((seg * R + d) * t_seg + j) * S + [0, min(count, S))], the
//      digit-major layout of the next pass (the fused exchange): every key
//      plane from the sorted tile, then each payload word, its tile staged
//      in shared memory over plane 0 (reg_sort.cuh:stage_row) and gathered
//      from there by the slot index; write the unclamped counts to
//      counts_out[t, :].  Slots past a run's count are left unwritten.  The
//      network walks the R x S run slots; the merge body walks its nv
//      slots, each to its run's place (the R x S walk where the runs do
//      not lie end to end: a poisoned K1b tile).
//
// Everything that reads the sorted tile (the histogram, K1b's binary
// searches, the emission) reads slot s at its swizzled word swz(s) on the
// network body, at merge_word(s) on the merge body.
//
// Bound: a pass reads the operands once and writes 1.5x (S = 1.5 K / R) or
// 1x of them, so at HBM speed it is memory-bound (0.642 ms for 2^28 keys,
// 1.283 for key + value, 1.924 for 2 planes + value).  The network body
// runs into its sort network (105 steps for a full 16384 sort, 69 for a
// merge from 256-runs, 10 and 1 of them in shared memory) over the padded
// tile and the scattered emission over R x S slots first: on an H100 at
// 2^28 pass 0 takes 5.2 ms for keys, 12.2 for key + value, and passes 1-2
// (1.5x padded) 6.5-6.9 and 13.6-14.7.  The merge body reads and sorts
// only the valid slots and walks only them: passes 1-2 take 3.8-4.0 ms
// for keys (6x the bound), 8.2-8.4 for key + value and 10.6-10.9 for 2
// planes + value on K1b, where its buffer (135 KB and 203 KB) leaves one
// CTA an SM.  The runs body sorts 55 of the network's 105 steps (45 at E
// = 16), all in registers and on shuffles, then merges 4-5 levels and
// walks the valid slots: pass 0 at 2^28 takes 3.9 ms for keys (5.0 on
// the network), 9.8 for key + value (12.2), 14.2 for 2 planes + value
// (20.1), and 5.0 for 2^27 u64 keys (7.0).  K1b's cut points add two
// binary searches per boundary and one thread's O(R) walk, next to
// nothing.  Shared memory: the network body 64 KB a key plane plus 32 KB
// of slot index at K = 16384, so 3 planes with payloads (224 KB) is its
// largest mode; the merge and runs bodies (K + K / 32) * (4 * planes + 4
// if payloads) bytes and the runs' starts; K1b reads its splitters from
// global memory and keeps its cut points in the histogram's arrays, so it
// needs no more.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "merge_runs.cuh"
#include "operands.cuh"
#include "reg_sort.cuh"

namespace tpusort {

constexpr int kMaxRadix = 256;
// the kernel's static shared memory (hist, start, n_valid) as ptxas lays
// it out
constexpr int kStaticSmem = 2064;

// K1b's splitters: one (T, R-1) word array per key plane, plus the (T, R-1)
// tie fractions, 16-bit fixed point in [0, 65536].
struct Splitters {
  const uint32_t* word[3];
  const uint32_t* frac;
};

// #slots among the n sorted slots whose key is below s (or_equal: at most
// s), lexicographically over the planes; key(p, s) as in digit_of.
template <int NK, class Key>
__device__ inline int rank_of(Key key, int n, const uint32_t* s,
                              bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    int c = 0;
#pragma unroll
    for (int p = 0; p < NK; ++p) {
      if (c == 0) {
        const uint32_t x = key(p, mid);
        c = (x > s[p]) - (x < s[p]);
      }
    }
    if (c < 0 || (or_equal && c == 0)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K1b: the cut points of tile t's sorted slots (port of the splitter branch
// of _fused_kernel, tpusort/kernels/partition.py:214-313).  Boundary d
// (1..R-1) may cut anywhere in its tie range [a_d, b_d] = [#keys < s_d,
// #keys <= s_d], since keys equal to s_d are equal in every tile.  It aims
// at a_d + frac * (b_d - a_d), rounded with a per-(tile, boundary) dither,
// clipped to [max(a_d, prev), prev + S] and to n_valid; a backward relief
// sweep then raises cuts within b_d so the top run fits S.  A cut forced
// outside its legal range, or a top run over S, poisons count 0 to K + 1.
// On return start[d] holds run d's first slot and count[d] its length
// (unclamped).  The ranks count over all K slots, invalid sentinels
// included, as the Pallas kernel counts them: key(p, s) gives the first n
// sorted slots (n = K on the network body; n = n_valid on the merge body,
// which holds no sentinel, so an all-ones splitter's b_d adds the K - n
// sentinels, all-ones in every plane, that the network's count holds).
// The binary searches take one thread per boundary; the walk is
// sequential, on thread 0.  Ends with __syncthreads().
template <int NK, class Key>
__device__ void splitter_cuts(Key key, int n, const Splitters& spl, int t,
                              int K, int R, int S, int n_valid, int* count,
                              int* start) {
  const size_t row = (size_t)t * (R - 1);
  for (int d = threadIdx.x + 1; d < R; d += blockDim.x) {
    uint32_t s[NK];
    bool ones = true;
#pragma unroll
    for (int p = 0; p < NK; ++p) {
      s[p] = spl.word[p][row + d - 1];
      ones = ones && s[p] == kSentinel;
    }
    count[d] = rank_of<NK>(key, n, s, false);            // a_d, then the cut
    start[d] = rank_of<NK>(key, n, s, true) + (ones ? K - n : 0);   // b_d
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool flag = false;
    int prev = 0;
    count[0] = 0;
    for (int d = 1; d < R; ++d) {
      const int a = count[d], b = start[d];
      const int lo = max(a, prev), hi = prev + S;
      flag |= lo > hi;
      // the Pallas dither, in uint32 (its int32 products wrap alike, and
      // only bits 15-30 survive the mask); fd * span needs the full uint32
      // range (the round-5 overflow fix), with fd clamped to 0xFFFF
      const uint32_t u = (((uint32_t)t * 0x9E3779B9u +
                           (((uint32_t)d * 0x85EBCA6Bu) & 0x7FFFFFFFu)) >> 15) &
                         0xFFFFu;
      const uint32_t fd = spl.frac[row + d - 1];
      const uint32_t prod = (min(fd, 0xFFFFu) * (uint32_t)(b - a) + u) >> 16;
      const int tgt = fd >= 0x10000u ? b : a + (int)prod;
      prev = min(min(max(tgt, lo), hi), n_valid);
      count[d] = prev;
    }
    int next = n_valid;
    for (int d = R - 1; d >= 1; --d) {
      next = max(count[d], min(next - S, start[d]));
      count[d] = next;
    }
    flag |= n_valid - count[R - 1] > S;
    for (int d = 0; d < R; ++d) {
      const int end = d + 1 < R ? count[d + 1] : n_valid;
      start[d] = count[d];
      count[d] = end - count[d];
    }
    if (flag) count[0] = K + 1;
  }
  __syncthreads();
}

// Each run d of the sorted tile, slots [start[d], start[d] + min(count[d],
// S)), to its place in out (the fused exchange); word(s) gives sorted slot
// s's word.
template <class Word>
__device__ __forceinline__ void emit_runs(uint32_t* __restrict__ out,
                                          const int* count, const int* start,
                                          int R, int S, int seg, int t_seg,
                                          int j, Word word) {
  for (int e = threadIdx.x; e < R * S; e += blockDim.x) {
    const int d = e / S;
    const int i = e - d * S;
    if (i < count[d]) {
      out[((size_t)(seg * R + d) * t_seg + j) * S + i] = word(start[d] + i);
    }
  }
}

// K1's counts from the digit histogram hist[0, R) of the sorted tile:
// start[d] = #(digit < d), count[d] = hist[d] and, for the top digit,
// n_valid - start[R-1]; the counts go to row and stay in hist.  Starts and
// ends with __syncthreads().
__device__ void digit_counts(int* hist, int* start, int R, int n_valid,
                             int32_t* row) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int d = 0; d < R; ++d) {
      start[d] = acc;
      acc += hist[d];
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < R; d += blockDim.x) {
    const int c = d < R - 1 ? hist[d] : n_valid - start[R - 1];
    row[d] = c;
    hist[d] = c;  // each thread rewrites only its own digit
  }
  __syncthreads();
}

// Steps 3 and 4 over a filled merge buffer m: the nv sorted slots of tile
// t = blockIdx.x, with no sentinel among them, each at merge_word(s), its
// input slot at m.idx.  The runs body and the merge body differ only in how
// they fill m, and give the outputs of the network body bit for bit (the
// same (key, slot) order; K1's counts and K1b's cuts as the network, with
// its K - nv sentinels, gives them).  Where the runs lie end to end over
// [0, nv) (every tile but a poisoned one, or one whose sentinels have a
// digit below the top one), each thread walks the merged slots i = tid,
// tid + threads, ... with a cursor d on the run that holds i, and slot i
// goes to its run's place when i - start[d] < S; else the R x S walk of the
// network body, slots past nv all-ones as its sentinels are.  E and
// chunks stage the payloads (threads * E * chunks >= K).
template <int E, int NK, bool IDX, bool SPL>
__device__ void partition_sorted(const MergeTile<NK, IDX>& m, int nv,
                                 const Planes& planes, const Values& vals,
                                 const Splitters& spl, int K, int R, int S,
                                 int lo_bit, int width, int t_seg,
                                 int chunks, int32_t* counts_out, int* hist,
                                 int* start) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t first = (size_t)t * K;
  const auto key = [&](int p, int s) { return m.key[p][merge_word(s)]; };
  int32_t* row = counts_out + (size_t)t * R;
  if constexpr (SPL) {
    splitter_cuts<NK>(key, nv, spl, t, K, R, S, nv, hist, start);
    for (int d = tid; d < R; d += nt) row[d] = hist[d];
  } else {
    for (int b = 0; b < nv; b += nt) {   // whole warps, for __match_any_sync
      const int i = b + tid;
      const int d = i < nv ? digit_of<NK>(key, i, lo_bit, width) : -1;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      if (d >= 0 && (tid & 31) == __ffs(peers) - 1) {
        atomicAdd(&hist[d], __popc(peers));
      }
    }
    // the network's sentinels: all-ones, so the top digit of the bits
    if (tid == 0 && nv < K) atomicAdd(&hist[(1 << width) - 1], K - nv);
    digit_counts(hist, start, R, nv, row);
  }
  bool gap = false;
  for (int d = tid; d < R; d += nt) {
    const int end = d + 1 < R ? start[d + 1] : nv;
    gap |= hist[d] < 0 || start[d] + hist[d] != end;
  }
  const bool tidy = !__syncthreads_or(gap);

  const int seg = t / t_seg;
  const int j = t - seg * t_seg;
  const auto walk = [&](auto put) {      // put(slot, its place in out)
    int d = 0;
    for (int i = tid; i < nv; i += nt) {
      while (d + 1 < R && start[d + 1] <= i) ++d;
      const int o = i - start[d];
      if (o < S) put(i, ((size_t)(seg * R + d) * t_seg + j) * S + o);
    }
  };
  if (tidy) {
    walk([&](int i, size_t at) {
      const int w = merge_word(i);
#pragma unroll
      for (int p = 0; p < NK; ++p) planes.out[p][at] = m.key[p][w];
    });
  } else {
#pragma unroll
    for (int p = 0; p < NK; ++p) {
      const uint32_t* kp = m.key[p];
      emit_runs(planes.out[p], hist, start, R, S, seg, t_seg, j, [=](int s) {
        return s < nv ? kp[merge_word(s)] : kSentinel;
      });
    }
  }
  if constexpr (IDX) {
    uint32_t* buf = m.key[0];
    const uint16_t* idx = m.idx;
    for (int v = 0; v < vals.count; ++v) {
      __syncthreads();           // plane 0's reads (or the last word's)
      stage_row<E>(buf, vals.in[v] + first, K, chunks);
      __syncthreads();
      uint32_t* out = vals.out[v];
      if (tidy) {
        walk([&](int i, size_t at) { out[at] = buf[idx[merge_word(i)]]; });
      } else {
        emit_runs(out, hist, start, R, S, seg, t_seg, j, [=](int s) {
          return buf[s < nv ? idx[merge_word(s)] : K - 1];
        });
      }
    }
  }
}

// The runs body's slots a thread, E: merge_runs.cuh's runs_slots.  A
// thread sorts its E slots of the tile in its warp's run of 32 E (1,024
// or 512 slots) and holds E outputs in each merge level, so a tile takes K
// / E threads.  Either way a thread gets 64 registers (kRunsMaxTile / E
// threads a CTA, and two CTAs an SM at E = 32): on an H100 at 2^28, more
// registers (half the threads, or one CTA where two fit the shared memory)
// cost more than what they saved, and so did runs of 1,024 on two words
// (a merge level less, at 128 registers a thread).
__host__ __device__ constexpr int runs_min_blocks(int e) {
  return e == 32 ? 2 : 1;
}

// The input key planes of a tile, passed by value: the address of the
// kernel's parameter Planes, passed to a call, would make the kernel copy
// it to local memory (a stack frame, and a spill of its out pointers).
template <int NK>
struct PlanesIn {
  const uint32_t* in[NK];
};

// The runs body's step 1 (pass 0: the tile does not arrive as sorted
// runs) in place of merge_runs.cuh's load_runs: tile t's K slots at
// src.in[p] + first are sorted run by run into the merge buffer t, which
// then holds what load_runs leaves: the runs' starts, and the valid slots
// as ascending runs with no sentinel among them.
// Validity is load_row's rule: with a counts table cin (the tile's row)
// slot i is valid iff i % q < cin[i / q], else iff i < left (n less the
// tile's first slot); so the valid slots among [b, b + len), len <= 32
// dividing b, are a prefix of them, valid(b, len) many.
//   a. every word of the tile's planes to its slot's word merge_word(i) of
//      the buffer, in 16-byte loads (4-byte ones where a plane's row is not
//      16-byte aligned), a vector with no valid slot not read: load_runs'
//      loop with another destination, kept apart, since one loader shared
//      by the two changed the register allocation of every merge instance
//      (K2's keys-only merge body 2.8 -> 3.4 ms on an H100);
//   b. each warp counts the valid slots of its run (warp j's run is slots
//      [32 E j, 32 E (j + 1))), and one warp scans the counts into the
//      runs' starts;
//   c. each thread reads its E slots (blocked, lane l's slots l E ..) as
//      register elements, an invalid slot all-ones in every plane with the
//      index kPadIndex (reg_sort.cuh's order: it sorts after every valid
//      slot, a valid all-ones key included; keys alone, it ties only
//      all-ones keys, whose words it equals), sorts the warp's run
//      (reg_sort.cuh: warp_sort), and after a barrier, so that no write
//      lands on a slot still to be read, writes the run's valid prefix,
//      the first count slots, to the run's start.
// Returns nv, the tile's valid slots; ends synchronised.  Not inlined: on
// its own it keeps within 64 registers what, inlined beside the merge,
// spilled (an H100 at 2^28: 2 planes + value 16.6 ms inlined, 15.4 not);
// so the caller holds nothing across the call that it can recompute (the
// buffer's pointers), which would take registers the call saves.
template <int E, int NK, bool IDX>
__device__ __noinline__ int sort_runs(uint32_t* smem, PlanesIn<NK> src,
                                      size_t first, int K,
                                      const int32_t* cin, int q,
                                      long long left) {
  const MergeTile<NK, IDX> t(smem, K);
  const auto valid = [=](int b, int len) {
    return cin != nullptr
               ? min(max(cin[b / q] - b % q, 0), len)
               : (int)min(max(left - b, 0LL), (long long)len);
  };
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int runs = K / (32 * E);
  bool vec = true;
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    vec = vec &&
          ((reinterpret_cast<uintptr_t>(src.in[p] + first) & 15) == 0);
  }
  if (vec) {
    // E / 4 vectors a thread, a batch in flight before any is written
    constexpr int kB = 4 >> (NK - 1);
    for (int g = 0; g * nt * 4 < K; g += kB) {
      uint4 w[NK][kB];
      bool ok[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = ((g + b) * nt + tid) * 4;
        ok[b] = i < K && valid(i, 4) > 0;
        if (ok[b]) {
#pragma unroll
          for (int p = 0; p < NK; ++p) {
            w[p][b] =
                *reinterpret_cast<const uint4*>(src.in[p] + first + i);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = ((g + b) * nt + tid) * 4;
        if (ok[b]) {
#pragma unroll
          for (int p = 0; p < NK; ++p) {
            const int at = merge_word(i);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              t.key[p][at + kk] = word(w[p][b], kk);
            }
          }
        }
      }
    }
  } else {
    for (int i = tid; i < K; i += nt) {
      if (valid(i, 1) > 0) {
#pragma unroll
        for (int p = 0; p < NK; ++p) {
          t.key[p][merge_word(i)] = src.in[p][first + i];
        }
      }
    }
  }
  const int b = tid * E;
  const int cnt = valid(b, E);
  const int sum = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0) t.starts[tid >> 5] = sum;
  __syncthreads();
  scan_starts(t, runs, [&](int j) { return t.starts[j]; });
  __syncthreads();
  RegElem<NK, IDX> v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const bool ok = r < cnt;
    const int w = merge_word(b + r);
#pragma unroll
    for (int p = 0; p < NK - 1; ++p) {
      v[r].hi[p] = ok ? t.key[p][w] : kSentinel;
    }
    const uint32_t lo = ok ? t.key[NK - 1][w] : kSentinel;
    if constexpr (IDX) {
      v[r].lo = (uint64_t)lo << 16 | (ok ? (uint16_t)(b + r) : kPadIndex);
    } else {
      v[r].lo = lo;
    }
  }
  warp_sort<E>(v, lane);
  __syncthreads();              // every slot of the tile is in registers
  const int st = t.starts[tid >> 5];
  const int n = t.starts[(tid >> 5) + 1] - st;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (lane * E + r < n) t.put(st + lane * E + r, v[r]);
  }
  __syncthreads();
  return t.starts[runs];
}

// The most threads an instance takes: the row sorts' limit, and with
// payloads at most 512 (the emission holds more state than a row sort; the
// geometry never gives a tile with payloads more threads); the runs
// body's, kRunsMaxTile / E; the merge body's, kMergeThreads.
__host__ __device__ constexpr int partition_threads(int nk, bool idx, int e,
                                                    bool runs, bool merge) {
  return merge  ? kMergeThreads
         : runs ? kRunsMaxTile / e
         : idx && max_threads(nk, idx, e) > kThreads / 2
             ? kThreads / 2
             : max_threads(nk, idx, e);
}

// RUNS: the runs body (E runs_slots(NK, IDX)); MERGE: the merge body
// (log_run the merge run's log2, E merge_slots(NK)); else the network body
// (log_run the sorted run's log2, 0 for none).
template <int NK, bool IDX, bool SPL, int E, bool RUNS, bool MERGE>
__global__ void __launch_bounds__(partition_threads(NK, IDX, E, RUNS, MERGE),
                                  RUNS ? runs_min_blocks(E) : 1)
partition_raw_kernel(Planes planes, Values vals, Splitters spl,
                     const int32_t* __restrict__ counts_in, int q_in,
                     long long n, int K, int log_k, int R, int S, int lo_bit,
                     int width, int t_seg, int log_run, int chunks,
                     int32_t* __restrict__ counts_out) {
  extern __shared__ uint32_t smem[];
  __shared__ int hist[kMaxRadix];
  __shared__ int start[kMaxRadix];
  __shared__ int n_valid;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int d = tid; d < R; d += blockDim.x) hist[d] = 0;
  if (tid == 0) n_valid = 0;
  __syncthreads();

  const size_t first = (size_t)t * K;
  if constexpr (RUNS || MERGE) {
    int nv;
    MergeTile<NK, IDX> m(smem, K);
    if constexpr (MERGE) {
      m = merge_tile<E, NK, IDX>(smem, planes.in, first,
                                 counts_in + (size_t)t * (K / q_in), q_in, K,
                                 log_run, &nv);
    } else {
      // the runs body: the sorted runs in place of merge_tile's load_runs,
      // then its chain_runs and merge_levels
      PlanesIn<NK> src;
#pragma unroll
      for (int p = 0; p < NK; ++p) src.in[p] = planes.in[p];
      nv = sort_runs<E, NK, IDX>(
          smem, src, first, K,
          counts_in == nullptr ? nullptr
                               : counts_in + (size_t)t * (K / q_in),
          q_in, n - (long long)first);
      m = MergeTile<NK, IDX>(smem, K);
      const int runs = K / (32 * E);
      m = merge_levels<E>(m, chain_runs(m, runs, nv), nv, K);
    }
    partition_sorted<E, NK, IDX, SPL>(
        m, nv, planes, vals, spl, K, R, S, lo_bit, width, t_seg, chunks,
        counts_out, hist, start);
  } else {
    const RegTile<NK, IDX> tile(smem, K);
    int mine = 0;
    if (counts_in != nullptr) {
      const int32_t* cin = counts_in + (size_t)t * (K / q_in);
      load_row<E>(tile, planes.in, first, K, chunks, [&](int i) {
        const bool v = (i % q_in) < cin[i / q_in];
        mine += v;
        return v;
      });
    } else {
      load_row<E>(tile, planes.in, first, K, chunks, [&](int i) {
        const bool v = (long long)(first + i) < n;
        mine += v;
        return v;
      });
    }
    mine = __reduce_add_sync(0xFFFFFFFFu, mine);
    if ((tid & 31) == 0) atomicAdd(&n_valid, mine);
    __syncthreads();

    reg_block_sort<E>(tile, log_k, log_run, chunks);

    const auto key = [&](int p, int s) { return tile.key[p][swz(s)]; };
    int32_t* row = counts_out + (size_t)t * R;
    if constexpr (SPL) {
      splitter_cuts<NK>(key, K, spl, t, K, R, S, n_valid, hist, start);
      for (int d = tid; d < R; d += blockDim.x) row[d] = hist[d];
    } else {
      for (int i = tid; i < K; i += blockDim.x) {
        const int d = digit_of<NK>(key, i, lo_bit, width);
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
        if ((tid & 31) == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
      }
      digit_counts(hist, start, R, n_valid, row);
    }

    const int seg = t / t_seg;
    const int j = t - seg * t_seg;
#pragma unroll
    for (int p = 0; p < NK; ++p) {
      const uint32_t* kp = tile.key[p];
      emit_runs(planes.out[p], hist, start, R, S, seg, t_seg, j,
                [=](int s) { return kp[swz(s)]; });
    }
    if constexpr (IDX) {
      uint32_t* buf = tile.key[0];
      const uint16_t* idx = tile.idx;
      for (int v = 0; v < vals.count; ++v) {
        __syncthreads();           // plane 0's reads (or the last word's)
        stage_row<E>(buf, vals.in[v] + first, K, chunks);
        __syncthreads();
        emit_runs(vals.out[v], hist, start, R, S, seg, t_seg, j,
                  [=](int s) { return buf[idx[swz(s)]]; });
      }
    }
  }
}

// The dynamic shared memory an instance is allowed, once per device: its
// tile at the largest K (a power of two up to 32768) that fits a CTA beside
// the static arrays, which is every tile the wrapper's check_fits takes;
// the runs body's buffer at its largest tile, kRunsMaxTile slots; the
// merge body's buffer at 32768 slots, or all a CTA has beside them.
template <int NK, bool IDX, int E, bool RUNS, bool MERGE>
constexpr int partition_smem_cap() {
  if (RUNS || MERGE) {
    const int k = RUNS ? kRunsMaxTile : 32768;
    const size_t b =
        MergeTile<NK, IDX>::bytes(k, RUNS ? k / (32 * E) : kMergeMaxRuns);
    return b + kStaticSmem < (size_t)kMaxSmem ? (int)b
                                              : kMaxSmem - kStaticSmem;
  }
  int k = 32768;
  while (RegTile<NK, IDX>::bytes(k) + kStaticSmem > (size_t)kMaxSmem) k /= 2;
  return (int)RegTile<NK, IDX>::bytes(k);
}

template <int NK, bool IDX, bool SPL, int E, bool RUNS, bool MERGE>
int launch_partition(const Planes& planes, const Values& vals,
                     const Splitters& spl, const int32_t* counts_in, int q_in,
                     long long n, int T, int K, int R, int S, int lo_bit,
                     int width, int t_seg, int log_run, int threads,
                     int chunks, size_t smem, int32_t* counts_out,
                     cudaStream_t stream) {
  const int log_k = 31 - __builtin_clz(K);
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = allow_smem_once(
      (const void*)partition_raw_kernel<NK, IDX, SPL, E, RUNS, MERGE>,
      partition_smem_cap<NK, IDX, E, RUNS, MERGE>(), smem_set);
  if (err != cudaSuccess) return (int)err;
  partition_raw_kernel<NK, IDX, SPL, E, RUNS, MERGE>
      <<<T, threads, smem, stream>>>(planes, vals, spl, counts_in, q_in, n, K,
                                     log_k, R, S, lo_bit, width, t_seg,
                                     log_run, chunks, counts_out);
  return (int)cudaGetLastError();
}

// Host side: true if (warp_run, threads, slots, smem) is the runs body's
// geometry for tiles of K slots (kernels/partition.py:
// partition_runs_geometry): one or two key planes, runs_slots a thread and
// warp runs of 32 of them, at most kMergeMaxRuns a tile, K / slots threads
// from a warp up, K at most kRunsMaxTile, and smem the merge buffer's
// bytes, beside the static arrays within a CTA.
inline bool runs_geometry_ok(int K, int warp_run, int n_planes,
                             bool has_values, int threads, int slots,
                             size_t smem) {
  if (n_planes < 1 || n_planes > 2 || K <= 0 ||
      slots != runs_slots(n_planes, has_values) || warp_run != 32 * slots ||
      K % warp_run || K / warp_run > kMergeMaxRuns || K > kRunsMaxTile ||
      threads * slots != K || threads < 32) {
    return false;
  }
  const size_t bytes =
      (size_t)merge_word(K) * (4 * n_planes + (has_values ? 4 : 0)) +
      (size_t)(K / warp_run + 2) * 4;
  return smem == bytes && smem + kStaticSmem <= (size_t)kMaxSmem;
}

// Host side: the instance for (n_planes, has values, slots a thread) with
// SPL, launched at (threads, chunks, smem): the runs body where warp_run >
// 0 (a geometry of runs_geometry_ok), the merge body where merge_run > 0
// (a geometry of merge_geometry_ok, with counts_in), else the network
// body; cudaErrorInvalidValue for a geometry no instance was built for.
template <bool SPL>
int dispatch_partition(const Planes& planes, const Values& vals,
                       const Splitters& spl, int n_planes,
                       const int32_t* counts_in, int q_in, long long n,
                       int T, int K, int R, int S, int lo_bit, int width,
                       int t_seg, int sorted_run, int merge_run, int warp_run,
                       int threads, int slots, size_t smem,
                       int32_t* counts_out, cudaStream_t stream) {
  if (R < 1 || R > kMaxRadix || (K & (K - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (warp_run > 0) {
    if (merge_run > 0 || sorted_run > 0 ||
        (counts_in != nullptr && (q_in <= 0 || K % q_in)) ||
        !runs_geometry_ok(K, warp_run, n_planes, vals.count > 0, threads,
                          slots, smem)) {
      return (int)cudaErrorInvalidValue;
    }
    return dispatch_mode(n_planes, vals.count > 0, [&](auto nk, auto idx) {
      constexpr int kNk = decltype(nk)::value;
      constexpr bool kIdx = decltype(idx)::value;
      if constexpr (kNk > 2) {
        return (int)cudaErrorInvalidValue;
      } else {
        return launch_partition<kNk, kIdx, SPL, runs_slots(kNk, kIdx), true,
                                false>(
            planes, vals, spl, counts_in, q_in, n, T, K, R, S, lo_bit, width,
            t_seg, 0, threads, 1, smem, counts_out, stream);
      }
    });
  }
  if (merge_run > 0) {
    if (counts_in == nullptr ||
        !merge_geometry_ok(K, q_in, merge_run, n_planes, vals.count > 0,
                           threads, slots, smem, kStaticSmem)) {
      return (int)cudaErrorInvalidValue;
    }
    const int log_l = 31 - __builtin_clz(merge_run);
    return dispatch_mode(n_planes, vals.count > 0, [&](auto nk, auto idx) {
      constexpr int kNk = decltype(nk)::value;
      return launch_partition<kNk, decltype(idx)::value, SPL,
                              merge_slots(kNk), false, true>(
          planes, vals, spl, counts_in, q_in, n, T, K, R, S, lo_bit, width,
          t_seg, log_l, threads, 1, smem, counts_out, stream);
    });
  }
  int chunks = 0;
  if (!reg_geometry_ok(K, threads, slots, smem,
                       (size_t)K * (4 * n_planes + (vals.count > 0 ? 2 : 0)),
                       &chunks)) {
    return (int)cudaErrorInvalidValue;
  }
  const int log_run = sorted_run > 0 ? 31 - __builtin_clz(sorted_run) : 0;
  return dispatch_slots(slots, [&](auto e) {
    return dispatch_mode(n_planes, vals.count > 0, [&](auto nk, auto idx) {
      constexpr int kNk = decltype(nk)::value;
      constexpr bool kIdx = decltype(idx)::value;
      constexpr int kE = decltype(e)::value;
      if constexpr (!fits_registers(kNk, kIdx, kE)) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (threads > partition_threads(kNk, kIdx, kE, false, false)) {
          return (int)cudaErrorInvalidValue;
        }
        return launch_partition<kNk, kIdx, SPL, kE, false, false>(
            planes, vals, spl, counts_in, q_in, n, T, K, R, S, lo_bit, width,
            t_seg, log_run, threads, chunks, smem, counts_out, stream);
      }
    });
  });
}

}  // namespace tpusort

// keys_in/keys_out: n_planes (1-3) device pointers each; vals_in/vals_out:
// n_vals (0-8) device pointers each.  K a power of two.  warp_run > 0 runs
// the runs body on warp runs of warp_run slots, with the geometry of
// kernels/partition.py:partition_runs_geometry (runs_geometry_ok);
// merge_run > 0 the merge body on runs of merge_run slots, with the
// geometry of kernels/partition.py:partition_merge_geometry
// (merge_geometry_ok); both 0 the network body, with threads, slots (E)
// and smem the geometry of kernels/bitonic.py:tile_sort_geometry(K,
// n_planes, n_vals).  Returns a cudaError_t (cudaErrorInvalidValue for a
// geometry no instance was built for).
extern "C" int tpusort_partition_raw(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts_in, int q_in, long long n, int T, int K, int R, int S,
    int lo_bit, int width, int t_seg, int sorted_run, int merge_run,
    int warp_run, int threads, int slots, int smem, void* counts_out,
    void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  if (!make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_partition<false>(
      planes, vals, Splitters{}, n_planes, (const int32_t*)counts_in, q_in, n,
      T, K, R, S, lo_bit, width, t_seg, sorted_run, merge_run, warp_run,
      threads, slots, (size_t)smem, (int32_t*)counts_out,
      (cudaStream_t)stream);
}

// K1b: as tpusort_partition_raw, with the runs cut at splitters (n_planes
// (T, R-1) word arrays) and tie fractions ((T, R-1) words) in place of the
// digit bits.  Returns a cudaError_t.
extern "C" int tpusort_partition_splitter(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts_in, int q_in, long long n, int T, int K, int R, int S,
    int t_seg, int sorted_run, int merge_run, int warp_run,
    const void* const* splitters, const void* fracs, int threads, int slots,
    int smem, void* counts_out, void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  if (R < 2 ||
      !make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals)) {
    return (int)cudaErrorInvalidValue;
  }
  Splitters spl{};
  for (int p = 0; p < n_planes; ++p) {
    spl.word[p] = static_cast<const uint32_t*>(splitters[p]);
  }
  spl.frac = static_cast<const uint32_t*>(fracs);
  return dispatch_partition<true>(
      planes, vals, spl, n_planes, (const int32_t*)counts_in, q_in, n, T, K,
      R, S, 0, 1, t_seg, sorted_run, merge_run, warp_run, threads, slots,
      (size_t)smem, (int32_t*)counts_out, (cudaStream_t)stream);
}

extern "C" const char* tpusort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
