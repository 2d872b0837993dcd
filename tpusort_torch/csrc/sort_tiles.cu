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
//
// K3's runs body (sort_tiles_kernel<NK>, a second template of K3's name)
// is the general path's packed leaf read straight from the last K1c
// pass's runs (ops/msd.py: packed_leaf), in place of the row build, the
// network over the padded rows and K4's copy.  One CTA owns one final
// segment of K slots, whose chunks of q slots each hold a valid prefix in
// input order (K1c is stable, and the runs lie in tile order):
//
//   1. one warp scans the chunks' counts (clamped to [0, q]) into their
//      compact starts; each valid slot's sort word goes to its compact
//      place s in the merge buffer (16-byte loads, a vector with no valid
//      slot not read), so the nv valid slots lie compact, in input order.
//      The word is bits [rem_lo, rem_lo + rem_width) of the slot's 1-2
//      key planes (operands.cuh: digit_of) with s under it, rem << ib | s,
//      ib the bits of K - 1: the packed branch keeps rem_width + the index
//      bits + 1 within 32, so the top bit is clear and an all-ones pad
//      sorts after every slot;
//   2. each warp sorts its run of 1,024 compact slots, 32 a lane, in
//      registers and on shuffles (reg_sort.cuh: warp_sort), the slots past
//      nv all-ones, and writes back the run's slots below nv; then
//      merge_runs.cuh's merge_levels merges the ceil(nv / 1024) runs.  The
//      words are distinct and s rises with input order, so their order is
//      the stable one, the rows' (segment, remainder, position) order bit
//      for bit;
//   3. the sorted words' low ib bits, the compact indices, go to an index
//      array; each operand (the key planes whole, then the payload words)
//      is staged compact over the words, its valid slots alone, and
//      gathered by the index into 16-byte stores at the segment's dense
//      offset (collapse.cu's offsets launch over the segments' counts,
//      before it); the last CTA writes zeros past the valid total.
//
// A slot is one word, so the body has the geometry of K1's keys-only runs
// body (partition.cu): 32 slots a thread in the sort and 32 outputs a
// thread in each merge level, K / 32 threads, 64 registers and two CTAs
// an SM, none of it spilled.
//
// Bound: each valid slot's operands are read once (the key planes twice,
// the second read from L2) and written once, and only valid slots are
// sorted, where the rows built a word for every slot, valid or not, for
// K3 to sort over the padded row and K4 to copy (34.5 ms of device time
// at 2^28 [0, 24) pairs on an H100).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "merge_runs.cuh"
#include "operands.cuh"
#include "reg_sort.cuh"

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


// ---- the packed leaf's runs body -----------------------------------------

// The leaf's sort slot is one word, the remainder with the compact index
// under it, so a thread sorts runs_slots(1, false) = 32 of them in its
// warp's run of 1,024 and holds merge_slots(1) = 32 outputs in each merge
// level: K / 32 threads, at most kLeafThreads.
constexpr int kLeafSlots = runs_slots(1, false);
constexpr int kLeafRun = 32 * kLeafSlots;
constexpr int kLeafThreads = kRunsMaxTile / kLeafSlots;
static_assert(merge_slots(1) == kLeafSlots, "a thread's sort and merge slots");

// The body's shared memory: the merge buffer of one plane (MergeTile<1,
// false>: the words, the runs' starts), then K uint16 sorted indices.
inline size_t leaf_smem_bytes(int K) {
  return MergeTile<1, false>::bytes(K, K / kLeafRun) +
         (size_t)K * sizeof(uint16_t);
}

// Every valid slot of a segment's K slots at row[p] (chunk c of q slots
// holds cs[c + 1] - cs[c] valid slots as a prefix) to put(its compact
// place cs[c] + its offset in the chunk, its NK words): 16-byte loads
// where every row is aligned, kB vectors of each row in flight before any
// is put, and a vector with no valid slot not read; 4-byte loads where
// not.  Does not synchronise.  partition.cu's sort_runs keeps a loop of its own: it
// writes whole vectors at their slots' places under its own validity rule,
// where this one puts the valid slots alone at compact places, so one
// loader for both would change the code of K1's and K1b's runs instances;
// and where K2 and K1 once shared a loader, K2's merge body went from 2.8
// to 3.4 ms on an H100 (partition.cu's sort_runs).
template <int kB, int NK, class Put>
__device__ __forceinline__ void load_valid(const uint32_t* const (&row)[NK],
                                           int K, int q, const int* cs,
                                           Put put) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  bool vec = true;
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    vec = vec && ((reinterpret_cast<uintptr_t>(row[p]) & 15) == 0);
  }
  if (vec) {
    for (int g = 0; g * nt * 4 < K; g += kB) {
      uint4 w[NK][kB];
      int m[kB], dst[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = ((g + b) * nt + tid) * 4;
        m[b] = 0;
        dst[b] = 0;
        if (i < K) {
          const int c = i / q;
          const int o = i - c * q;
          const int left = cs[c + 1] - cs[c] - o;
          m[b] = left < 0 ? 0 : (left > 4 ? 4 : left);
          dst[b] = cs[c] + o;
        }
        if (m[b] > 0) {
#pragma unroll
          for (int p = 0; p < NK; ++p) {
            w[p][b] = *reinterpret_cast<const uint4*>(row[p] + i);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < m[b]) {
            uint32_t v[NK];
#pragma unroll
            for (int p = 0; p < NK; ++p) v[p] = word(w[p][b], kk);
            put(dst[b] + kk, v);
          }
        }
      }
    }
  } else {
    for (int i = tid; i < K; i += nt) {
      const int c = i / q;
      const int o = i - c * q;
      if (o < cs[c + 1] - cs[c]) {
        uint32_t v[NK];
#pragma unroll
        for (int p = 0; p < NK; ++p) v[p] = row[p][i];
        put(cs[c] + o, v);
      }
    }
  }
}

// Step 2's warp runs: warp j's run, compact slots [kLeafRun j, kLeafRun
// (j + 1)) of the merge buffer, sorted in place where it starts below nv:
// lane l's kLeafSlots slots l kLeafSlots .. (blocked) in registers, the
// slots past nv all-ones, sorted in registers and on shuffles
// (reg_sort.cuh: warp_sort) and written back below nv.  A warp reads and
// writes only its own run.  Does not synchronise the block.  Not inlined,
// as partition.cu's sort_runs is not: the caller holds nothing across it
// but the buffer's base.
__device__ __noinline__ void sort_leaf_runs(uint32_t* smem, int K, int nv) {
  const MergeTile<1, false> m(smem, K);
  const int b = (int)threadIdx.x * kLeafSlots;
  if ((b & -kLeafRun) >= nv) return;      // the warp's run is empty
  RegElem<1, false> v[kLeafSlots];
#pragma unroll
  for (int r = 0; r < kLeafSlots; ++r) {
    v[r].lo = b + r < nv ? m.key[0][merge_word(b + r)] : kSentinel;
  }
  warp_sort<kLeafSlots>(v, (int)threadIdx.x & 31);
  __syncwarp();                           // every lane has read its slots
#pragma unroll
  for (int r = 0; r < kLeafSlots; ++r) {
    if (b + r < nv) m.key[0][merge_word(b + r)] = v[r].lo;
  }
}

// The packed leaf's runs body, one final segment of K slots a CTA, K /
// kLeafSlots threads; see the top of the file.  ops: NK key planes, then
// the payload words, each (nseg, K) in and (n_out,) out; counts: the
// (nseg, K / q) table; ib: the bits of K - 1, under the remainder; off:
// the segments' dense offsets (nseg + 1, collapse.cu's
// collapse_offsets_kernel over the table's row sums).
template <int NK>
__global__ void __launch_bounds__(kLeafThreads, 2)
sort_tiles_kernel(Operands ops, const int32_t* __restrict__ counts, int q,
                  int K, int rem_lo, int rem_width, int ib,
                  const long long* __restrict__ off, long long n_out) {
  extern __shared__ uint32_t smem[];
  __shared__ int cs[kMergeMaxRuns + 1];     // the chunks' compact starts
  {
    const int t = blockIdx.x;
    const int chunks = K / q;
    const MergeTile<1, false> m(smem, K);
    MergeTile<1, false> at = m;             // scan_starts writes at.starts
    at.starts = cs;
    const int32_t* cnt = counts + (size_t)t * chunks;
    scan_starts(at, chunks, [=](int c) {
      const int v = cnt[c];
      return v < 0 ? 0 : (v > q ? q : v);
    });
    __syncthreads();
    // 1. the sort words, compact, two vectors of each plane in flight
    // (with four of one plane the one-plane instance spilled 108 B at 64
    // registers, and took 88 unbounded; with two, 64 and no spill)
    const uint32_t* keys[NK];
#pragma unroll
    for (int p = 0; p < NK; ++p) keys[p] = ops.in[p] + (size_t)t * K;
    load_valid<2>(keys, K, q, cs, [&](int s, const uint32_t (&w)[NK]) {
      const uint32_t r = (uint32_t)digit_of<NK>(
          [&](int p, int) { return w[p]; }, 0, rem_lo, rem_width);
      m.key[0][merge_word(s)] = r << ib | (uint32_t)s;
    });
    __syncthreads();
  }
  // 2. warp runs, then merge_runs.cuh's levels.  The kernel holds nothing
  // across the call: what follows reads its state again from the
  // parameters and shared memory
  sort_leaf_runs(smem, K, cs[K / q]);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nv = cs[K / q];
  const MergeTile<1, false> m(smem, K);
  const int runs = (nv + kLeafRun - 1) / kLeafRun;
  for (int j = tid; j <= runs; j += nt) {
    m.starts[j] = min(j * kLeafRun, nv);
  }
  __syncthreads();
  merge_levels<kLeafSlots>(m, runs, nv, K);
  // 3. the compact indices in sorted order, then every operand dense,
  // gathered by them from its valid slots staged compact over the words
  uint16_t* const sorted =
      reinterpret_cast<uint16_t*>(smem + merge_word(K) + K / kLeafRun + 2);
  const uint32_t low = (1u << ib) - 1u;
  for (int i = tid; i < nv; i += nt) {
    sorted[i] = (uint16_t)(m.key[0][merge_word(i)] & low);
  }
  const long long o = off[t];
  const long long room = n_out - o;
  const int c = room <= 0 ? 0 : (room < nv ? (int)room : nv);
  uint32_t* buf = m.key[0];
  for (int k = 0; k < ops.count; ++k) {
    __syncthreads();
    const uint32_t* row[1] = {ops.in[k] + (size_t)t * K};
    load_valid<4>(row, K, q, cs,
                  [&](int s, const uint32_t (&w)[1]) { buf[s] = w[0]; });
    __syncthreads();
    store_words(ops.out[k] + o, c, [&](int i) { return buf[sorted[i]]; });
  }
  // words past the segments' valid total are zero (as collapse.cu's)
  if (t == (int)gridDim.x - 1) {
    for (int k = 0; k < ops.count; ++k) {
      for (long long i = off[gridDim.x] + tid; i < n_out; i += nt) {
        ops.out[k][i] = 0u;
      }
    }
  }
}

template <int NK>
int launch_sort_leaf_runs(const Operands& ops, const int32_t* counts, int q,
                          int nseg, int K, int rem_lo, int rem_width, int ib,
                          const long long* off, long long n_out,
                          int threads, size_t smem, cudaStream_t stream) {
  void (*kernel)(Operands, const int32_t*, int, int, int, int, int,
                 const long long*, long long) = sort_tiles_kernel<NK>;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = allow_smem_once(
      (const void*)kernel, (int)leaf_smem_bytes(kRunsMaxTile), smem_set);
  if (err != cudaSuccess) return (int)err;
  sort_tiles_kernel<NK><<<nseg, threads, smem, stream>>>(
      ops, counts, q, K, rem_lo, rem_width, ib, off, n_out);
  return (int)cudaGetLastError();
}

// Host side: true if (warp_run, threads, smem) is the packed leaf's runs
// geometry for segments of K slots with a counts table of q-slot chunks
// (kernels/bitonic.py: leaf_runs_geometry): one or two key planes, K a
// multiple of the warp run kLeafRun and at most kRunsMaxTile, q a
// multiple of kLeafSlots dividing K, at most kMergeMaxRuns chunks,
// K / kLeafSlots threads, and smem leaf_smem_bytes(K).
inline bool leaf_runs_geometry_ok(int K, int q, int n_planes, int warp_run,
                                  int threads, size_t smem) {
  if (n_planes < 1 || n_planes > 2 || warp_run != kLeafRun || K <= 0 ||
      K % kLeafRun || K > kRunsMaxTile || q <= 0 || q % kLeafSlots ||
      K % q || K / q > kMergeMaxRuns) {
    return false;
  }
  return threads == K / kLeafSlots && smem == leaf_smem_bytes(K);
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

// The packed leaf's runs body: ops_in/ops_out n_ops (1-16) device pointers
// each, the first n_planes (1-2) the key planes; inputs (nseg, K) the last
// partition pass's runs, outputs (n_out,); counts: the (nseg, K / q) int32
// table; offsets: nseg + 1 int64, the exclusive cumsum of the segments'
// valid counts (tpusort_collapse_offsets); the segments sorted stably by
// bits [rem_lo, rem_lo + rem_width) of the key (rem_width and the bits of
// K - 1 at most 31 together); warp_run, threads and smem the geometry of
// kernels/bitonic.py:leaf_runs_geometry.  Returns a cudaError_t.
extern "C" int tpusort_sort_leaf_runs(
    const void* const* ops_in, void* const* ops_out, int n_ops, int n_planes,
    const void* counts, int q, const void* offsets, long long n_out,
    int nseg, int K, int rem_lo, int rem_width, int warp_run, int threads,
    int smem, void* stream) {
  using namespace tpusort;
  Operands ops;
  int ib = 0;                           // the bits of K - 1
  while (ib < 31 && (1 << ib) < K) ++ib;
  if (!make_operand_list(ops_in, ops_out, n_ops, &ops) || n_ops < n_planes ||
      nseg < 0 || n_out < 0 || rem_lo < 0 || rem_width < 0 ||
      rem_width + ib > 31 || rem_lo + rem_width > 32 * n_planes ||
      !leaf_runs_geometry_ok(K, q, n_planes, warp_run, threads,
                             (size_t)smem)) {
    return (int)cudaErrorInvalidValue;
  }
  if (nseg == 0) return (int)cudaSuccess;
  const int32_t* c = static_cast<const int32_t*>(counts);
  const long long* off = static_cast<const long long*>(offsets);
  cudaStream_t st = (cudaStream_t)stream;
  return n_planes == 1
             ? launch_sort_leaf_runs<1>(ops, c, q, nseg, K, rem_lo,
                                        rem_width, ib, off, n_out, threads,
                                        (size_t)smem, st)
             : launch_sort_leaf_runs<2>(ops, c, q, nseg, K, rem_lo,
                                        rem_width, ib, off, n_out, threads,
                                        (size_t)smem, st);
}
