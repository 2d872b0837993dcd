// Block-wide row sort with the short steps in registers and warp shuffles,
// used by the row tile sorts (K3, K9, K10; csrc/sort_tiles.cu) and the
// raw-key partition pass (K1, K1b; csrc/partition.cu).
//
// The network is block_sort's (tile_sort.cuh): for each merge level lk
// (runs of 2^(lk-1) merged into runs of 2^lk) a mirror step, slot i against
// i ^ (2^lk - 1), then half-cleaners, i against i + d for d = 2^(lk-2)
// down to 1.  What changes is where each step runs.  The P slots of a row
// live in shared memory between phases; thread t of a chunk of
// C = threads * E slots owns the E consecutive slots [t*E, t*E + E) of it
// in registers ("blocked"), so a step whose pairs lie inside an aligned
// span of
//   - E slots runs in registers, unrolled, with no synchronisation;
//   - 32 * E slots (one warp) runs on __shfl_xor_sync: a half-cleaner at
//     distance d pairs lane l with lane l ^ (d / E) at the same register,
//     a mirror of block B pairs lane l with lane l ^ (B / E - 1) at the
//     reversed register E - 1 - r;
//   - more runs in shared memory, one compare-exchange per pair and a
//     __syncthreads() per step, as block_sort does.
// At P = 16384 with 1024 threads x 16 slots, 15 of the 105 steps touch
// shared memory, with 512 x 32 10; at 2048 with 128 x 16, 3 of 66, with
// 64 x 32 none.  A thread's slots take at most 64 registers
// (fits_registers; above 32 the CTA has at most 512 threads, so a thread
// may have 128), so that no instance spills.  Where a row holds more than
// C slots (chunks > 1: rows too long for the CTA's registers), each
// warp-local run of steps is done chunk by chunk: the steps of such a run
// never cross a warp's span, so the chunks are independent.
//
// A slot is an element of NK 32-bit key planes compared lexicographically,
// plane 0 most significant, and (IDX) a 16-bit slot index that breaks ties:
// in registers the last plane and the index are one 64-bit word,
// (plane << 16) | index, so one unsigned compare orders them.  With the
// index the order is total, so the result is the stable order.  In shared
// memory a slot is NK words and a uint16 index, at the word
// s ^ ((s >> 5) & 31): each 32-slot group is permuted by its group number,
// which makes the blocked reads and writes of E = 4-32 consecutive slots a
// thread free of bank conflicts (and keeps striped ones so).
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "tile_sort.cuh"

namespace tpusort {

// The shared-memory word of slot s (a permutation of each 32-slot group).
__device__ __forceinline__ int swz(int s) { return s ^ ((s >> 5) & 31); }

template <int NK, bool IDX>
struct RegElem {
  using Lo = typename std::conditional<IDX, uint64_t, uint32_t>::type;
  uint32_t hi[NK > 1 ? NK - 1 : 1];  // planes 0 .. NK-2
  Lo lo;                             // plane NK-1, with the index if IDX
};

// a > b over (planes, index)
template <int NK, bool IDX>
__device__ __forceinline__ bool greater(const RegElem<NK, IDX>& a,
                                        const RegElem<NK, IDX>& b) {
  bool gt = a.lo > b.lo;
#pragma unroll
  for (int p = NK - 2; p >= 0; --p) {
    gt = a.hi[p] > b.hi[p] || (a.hi[p] == b.hi[p] && gt);
  }
  return gt;
}

template <int NK, bool IDX>
__device__ __forceinline__ RegElem<NK, IDX> shfl_xor(
    const RegElem<NK, IDX>& x, int mask) {
  RegElem<NK, IDX> y;
#pragma unroll
  for (int p = 0; p < NK - 1; ++p) {
    y.hi[p] = __shfl_xor_sync(0xFFFFFFFFu, x.hi[p], mask);
  }
  y.lo = __shfl_xor_sync(0xFFFFFFFFu, x.lo, mask);
  return y;
}

// x becomes min(x, y) if keep_min, else max(x, y)
template <int NK, bool IDX>
__device__ __forceinline__ void keep(RegElem<NK, IDX>& x,
                                     const RegElem<NK, IDX>& y,
                                     bool keep_min) {
  if (greater(x, y) == keep_min) x = y;
}

template <int NK, bool IDX>
__device__ __forceinline__ void cas(RegElem<NK, IDX>& a,
                                    RegElem<NK, IDX>& b) {
  if (greater(a, b)) {
    const RegElem<NK, IDX> t = a;
    a = b;
    b = t;
  }
}

// The row in shared memory: NK planes of n words, then (IDX) n uint16
// indices, slot s at swz(s) in each.
template <int NK, bool IDX>
struct RegTile {
  using Elem = RegElem<NK, IDX>;
  uint32_t* key[NK];
  uint16_t* idx;

  __device__ RegTile(uint32_t* base, int n) {
#pragma unroll
    for (int p = 0; p < NK; ++p) key[p] = base + (size_t)p * n;
    idx = IDX ? reinterpret_cast<uint16_t*>(base + (size_t)NK * n) : nullptr;
  }

  // Dynamic shared memory for n slots (what tile_smem_bytes says).
  static constexpr size_t bytes(int n) {
    return (size_t)n * (NK * sizeof(uint32_t) + (IDX ? sizeof(uint16_t) : 0));
  }

  __device__ __forceinline__ Elem get(int s) const {
    const int w = swz(s);
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

  __device__ __forceinline__ void put(int s, const Elem& e) const {
    const int w = swz(s);
#pragma unroll
    for (int p = 0; p < NK - 1; ++p) key[p][w] = e.hi[p];
    if constexpr (IDX) {
      key[NK - 1][w] = (uint32_t)(e.lo >> 16);
      idx[w] = (uint16_t)e.lo;
    } else {
      key[NK - 1][w] = e.lo;
    }
  }

  // slot s from its NK words (the index is s)
  __device__ __forceinline__ void set(int s, const uint32_t (&w)[NK]) const {
    const int a = swz(s);
#pragma unroll
    for (int p = 0; p < NK; ++p) key[p][a] = w[p];
    if (IDX) idx[a] = (uint16_t)s;
  }
};

__host__ __device__ constexpr int log2_slots(int e) {
  return e == 4 ? 2 : (e == 8 ? 3 : (e == 16 ? 4 : 5));
}

// ---- the register tier: steps inside a thread's E slots ----------------

// Every level whose runs fit in E slots, from level lo to hi (lo >= 1).
template <int E, int NK, bool IDX>
__device__ __forceinline__ void reg_levels(RegElem<NK, IDX> (&v)[E], int lo,
                                           int hi) {
#pragma unroll
  for (int lk = 1; (1 << lk) <= E; ++lk) {
    const int b = 1 << lk;                   // the runs merged into
    if (lk >= lo && lk <= hi) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if ((r & (b / 2)) == 0) cas(v[r], v[r ^ (b - 1)]);
      }
#pragma unroll
      for (int d = b / 4; d >= 1; d /= 2) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & d) == 0) cas(v[r], v[r + d]);
        }
      }
    }
  }
}

// The half-cleaners at distances E/2 .. 1.
template <int E, int NK, bool IDX>
__device__ __forceinline__ void reg_cleaners(RegElem<NK, IDX> (&v)[E]) {
#pragma unroll
  for (int d = E / 2; d >= 1; d /= 2) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if ((r & d) == 0) cas(v[r], v[r + d]);
    }
  }
}

// ---- the warp tier ------------------------------------------------------

// Mirror of blocks of B = E * (m + 1) slots: lane l's slot r against lane
// (l ^ m)'s slot E - 1 - r; the lower lane keeps the minimum.  Both slots
// of a pair are taken from the partner before either is replaced.
template <int E, int NK, bool IDX>
__device__ __forceinline__ void warp_mirror(RegElem<NK, IDX> (&v)[E],
                                            int lane, int m) {
  const bool lower = (lane & ((m + 1) >> 1)) == 0;
#pragma unroll
  for (int r = 0; r < E / 2; ++r) {
    const RegElem<NK, IDX> a = shfl_xor(v[E - 1 - r], m);
    const RegElem<NK, IDX> b = shfl_xor(v[r], m);
    keep(v[r], a, lower);
    keep(v[E - 1 - r], b, lower);
  }
}

// Half-cleaner at distance d = E * dm: lane l against lane l ^ dm, the same
// register.
template <int E, int NK, bool IDX>
__device__ __forceinline__ void warp_clean(RegElem<NK, IDX> (&v)[E],
                                           int lane, int dm) {
  const bool lower = (lane & dm) == 0;
#pragma unroll
  for (int r = 0; r < E; ++r) keep(v[r], shfl_xor(v[r], dm), lower);
}

// The warp-local steps of levels lo .. hi on the registers.  Level lo's
// steps at block sizes above 32 E (its mirror and its half-cleaners at
// d >= 32 E) have already run in shared memory; no level above lo has any.
template <int E, int NK, bool IDX>
__device__ __forceinline__ void local_levels(RegElem<NK, IDX> (&v)[E],
                                             int lane, int lo, int hi) {
  constexpr int kLogE = log2_slots(E);
  constexpr int kLogW = kLogE + 5;           // a warp's span: 32 E slots
  if (lo <= kLogE) {
    reg_levels<E>(v, lo, hi < kLogE ? hi : kLogE);
    lo = kLogE + 1;
  }
  for (int lk = lo; lk <= hi; ++lk) {
    if (lk <= kLogW) warp_mirror<E>(v, lane, (1 << (lk - kLogE)) - 1);
    const int top = lk - 2 < kLogW - 1 ? lk - 2 : kLogW - 1;
    for (int lj = top; lj >= kLogE; --lj) {
      warp_clean<E>(v, lane, 1 << (lj - kLogE));
    }
    reg_cleaners<E>(v);
  }
}

// ---- the shared-memory tier ---------------------------------------------

// One step over the whole row: pair p of [0, P / 2) compares slots
// pair(p) = (i, j).  A thread takes E / 2 pairs a chunk, a batch at a
// time, and loads the whole batch before it stores any of it (the pairs
// of a step are disjoint), so the loads of a batch are in flight together.
template <int E, int NK, bool IDX, class Pair>
__device__ __forceinline__ void smem_step(const RegTile<NK, IDX>& t,
                                          int chunks, Pair pair) {
  constexpr int kWords = NK + (IDX ? 1 : 0);
  constexpr int kFit = 8 / kWords > 0 ? 8 / kWords : 1;
  constexpr int kBatch = kFit < E / 2 ? kFit : E / 2;
  for (int g = 0; g < chunks * (E / 2); g += kBatch) {
    int i[kBatch], j[kBatch];
    RegElem<NK, IDX> a[kBatch], b[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      pair((g + k) * (int)blockDim.x + (int)threadIdx.x, i[k], j[k]);
      a[k] = t.get(i[k]);
      b[k] = t.get(j[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (greater(a[k], b[k])) {
        t.put(i[k], b[k]);
        t.put(j[k], a[k]);
      }
    }
  }
}

// ---- the block sort -----------------------------------------------------

// Sort the tile's 2^log_p slots ascending with all threads of the block
// (blockDim.x * E * chunks == 2^log_p, blockDim.x a multiple of 32).  The
// slots must already consist of ascending runs of 2^log_run; only the
// levels above run.  Expects the tile written and the block synchronised;
// ends synchronised.
template <int E, int NK, bool IDX>
__device__ void reg_block_sort(const RegTile<NK, IDX>& t, int log_p,
                               int log_run, int chunks) {
  constexpr int kLogE = log2_slots(E);
  constexpr int kLogW = kLogE + 5;
  static_assert((1 << kLogE) == E, "E is 4, 8, 16 or 32");
  const int lane = threadIdx.x & 31;
  const int chunk = blockDim.x * E;
  int lk = log_run + 1;
  while (lk <= log_p) {
    int hi = lk;
    if (lk > kLogW) {                        // the long steps of level lk
      smem_step<E>(t, chunks, [=](int p, int& i, int& j) {
        const int base = (p >> (lk - 1)) << lk;
        const int off = p & ((1 << (lk - 1)) - 1);
        i = base + off;
        j = base + (1 << lk) - 1 - off;
      });
      __syncthreads();
      for (int lj = lk - 2; lj >= kLogW; --lj) {
        smem_step<E>(t, chunks, [=](int p, int& i, int& j) {
          i = ((p >> lj) << (lj + 1)) + (p & ((1 << lj) - 1));
          j = i + (1 << lj);
        });
        __syncthreads();
      }
    } else {
      hi = log_p < kLogW ? log_p : kLogW;
    }
    for (int c = 0; c < chunks; ++c) {
      const int first = c * chunk + threadIdx.x * E;
      RegElem<NK, IDX> v[E];
#pragma unroll
      for (int r = 0; r < E; ++r) v[r] = t.get(first + r);
      local_levels<E>(v, lane, lk, hi);
#pragma unroll
      for (int r = 0; r < E; ++r) t.put(first + r, v[r]);
    }
    __syncthreads();
    lk = hi + 1;
  }
}

// ---- loading and storing a row -----------------------------------------

__device__ __forceinline__ uint32_t word(const uint4& q, int k) {
  return k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
}

// Slots [0, P) of the tile (P = blockDim.x * E * chunks) from the row's NK
// input planes at src[p] + first: slot i < K with valid(i) its words, any
// other slot all-ones in every plane; the index of slot i is i.  16-byte
// loads where every plane's row start is 16-byte aligned (K is a multiple
// of 128, so the row start is aligned when the base is), else 4-byte ones;
// a thread issues a batch of loads (16 words over its planes, or 16 / 2^
// (NK - 1) scalars) before it stores any of them.  Does not synchronise.
template <int E, int NK, bool IDX, class Valid>
__device__ void load_row(const RegTile<NK, IDX>& t,
                         const uint32_t* const* src, size_t first, int K,
                         int chunks, Valid valid) {
  constexpr int kV = E / 4;                  // vectors a thread a chunk
  constexpr int kVB = kV < (4 >> (NK - 1)) ? kV : (4 >> (NK - 1));
  constexpr int kSB = E < (16 >> (NK - 1)) ? E : (16 >> (NK - 1));
  const int nt = blockDim.x;
  bool vec = true;
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    vec = vec && ((reinterpret_cast<uintptr_t>(src[p] + first) & 15) == 0);
  }
  if (vec) {
    for (int g = 0; g < chunks * kV; g += kVB) {
      uint4 q[NK][kVB];
#pragma unroll
      for (int k = 0; k < kVB; ++k) {
        const int i = ((g + k) * nt + (int)threadIdx.x) * 4;
#pragma unroll
        for (int p = 0; p < NK; ++p) {
          q[p][k] = i < K ? *reinterpret_cast<const uint4*>(src[p] + first + i)
                          : make_uint4(kSentinel, kSentinel, kSentinel,
                                       kSentinel);
        }
      }
#pragma unroll
      for (int k = 0; k < kVB; ++k) {
        const int i = ((g + k) * nt + (int)threadIdx.x) * 4;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const bool ok = i + kk < K && valid(i + kk);
          uint32_t s[NK];
#pragma unroll
          for (int p = 0; p < NK; ++p) s[p] = ok ? word(q[p][k], kk) : kSentinel;
          t.set(i + kk, s);
        }
      }
    }
  } else {
    for (int g = 0; g < chunks * E; g += kSB) {
      uint32_t w[NK][kSB];
#pragma unroll
      for (int k = 0; k < kSB; ++k) {
        const int i = (g + k) * nt + (int)threadIdx.x;
#pragma unroll
        for (int p = 0; p < NK; ++p) {
          w[p][k] = i < K ? src[p][first + i] : kSentinel;
        }
      }
#pragma unroll
      for (int k = 0; k < kSB; ++k) {
        const int i = (g + k) * nt + (int)threadIdx.x;
        const bool ok = i < K && valid(i);
        uint32_t s[NK];
#pragma unroll
        for (int p = 0; p < NK; ++p) s[p] = ok ? w[p][k] : kSentinel;
        t.set(i, s);
      }
    }
  }
}

// Slots [0, K) of the sorted tile's planes to dst[p] + first, in 16-byte
// stores (the entry points take only 16-byte aligned outputs; K is a
// multiple of 128, so every row start is aligned).  Does not synchronise.
template <int NK, bool IDX>
__device__ void store_row(const RegTile<NK, IDX>& t, uint32_t* const* dst,
                          size_t first, int K) {
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    uint32_t* out = dst[p] + first;
    for (int i = threadIdx.x * 4; i < K; i += blockDim.x * 4) {
      *reinterpret_cast<uint4*>(out + i) =
          make_uint4(t.key[p][swz(i)], t.key[p][swz(i + 1)],
                     t.key[p][swz(i + 2)], t.key[p][swz(i + 3)]);
    }
  }
}

// Words in[0..K) to buf[0..K) in shared memory (P >= K words, P =
// blockDim.x * E * chunks): 16-byte loads where `in` is aligned, else
// 4-byte ones, a batch of loads in flight before any of them is stored
// (as in load_row).  Does not synchronise.
template <int E>
__device__ void stage_row(uint32_t* buf, const uint32_t* in, int K,
                          int chunks) {
  constexpr int kV = E / 4;
  constexpr int kVB = kV < 4 ? kV : 4;
  constexpr int kSB = E < 16 ? E : 16;
  const int nt = blockDim.x;
  if ((reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    for (int g = 0; g < chunks * kV; g += kVB) {
      uint4 q[kVB];
#pragma unroll
      for (int k = 0; k < kVB; ++k) {
        const int i = ((g + k) * nt + (int)threadIdx.x) * 4;
        if (i < K) q[k] = *reinterpret_cast<const uint4*>(in + i);
      }
#pragma unroll
      for (int k = 0; k < kVB; ++k) {
        const int i = ((g + k) * nt + (int)threadIdx.x) * 4;
        if (i < K) *reinterpret_cast<uint4*>(buf + i) = q[k];
      }
    }
  } else {
    for (int g = 0; g < chunks * E; g += kSB) {
      uint32_t w[kSB];
#pragma unroll
      for (int k = 0; k < kSB; ++k) {
        const int i = (g + k) * nt + (int)threadIdx.x;
        if (i < K) w[k] = in[i];
      }
#pragma unroll
      for (int k = 0; k < kSB; ++k) {
        const int i = (g + k) * nt + (int)threadIdx.x;
        if (i < K) buf[i] = w[k];
      }
    }
  }
}

// Each payload word of slots [0, K): staged whole in shared memory (over
// key plane 0, which store_row has read; stage_row), then gathered from
// there by the slot index, clamped to K - 1, and stored in 16-byte stores.
// Expects the planes already stored; synchronises before each staging.
template <int E, int NK>
__device__ void gather_payloads(const RegTile<NK, true>& t,
                                const Values& vals, size_t first, int K,
                                int chunks) {
  uint32_t* buf = t.key[0];
  for (int v = 0; v < vals.count; ++v) {
    uint32_t* out = vals.out[v] + first;
    __syncthreads();
    stage_row<E>(buf, vals.in[v] + first, K, chunks);
    __syncthreads();
    auto src = [&](int i) {
      const int s = t.idx[swz(i)];
      return buf[s < K ? s : K - 1];
    };
    for (int i = threadIdx.x * 4; i < K; i += blockDim.x * 4) {
      *reinterpret_cast<uint4*>(out + i) =
          make_uint4(src(i), src(i + 1), src(i + 2), src(i + 3));
    }
  }
}

// Host side: true if the n output pointers are 16-byte aligned (the
// kernels store 16 bytes at a time; the wrappers' fresh outputs are).
inline bool aligned16(void* const* out, int n) {
  for (int k = 0; k < n; ++k) {
    if (reinterpret_cast<uintptr_t>(out[k]) & 15) return false;
  }
  return true;
}

// Host side: true if (threads, E, smem) is a geometry the kernels take for
// a row of P slots: E in {4, 8, 16, 32}, threads a multiple of 32 up to
// kThreads, threads * E dividing P, and smem the tile's bytes.
inline bool reg_geometry_ok(int P, int threads, int E, size_t smem,
                            size_t tile_bytes, int* chunks) {
  if ((E != 4 && E != 8 && E != 16 && E != 32) || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || smem != tile_bytes) {
    return false;
  }
  const long long c = (long long)threads * E;
  if (P % c != 0) return false;
  *chunks = (int)(P / c);
  return (*chunks & (*chunks - 1)) == 0;
}

// A thread's E slots take E * (NK + IDX) registers (the planes, and the
// index packed with the last plane).  Up to kRegWords of them an instance
// runs 1024 threads (64 registers a thread); up to twice that, 512 (128
// registers); none is built above that, where it would spill
// (kernels/bitonic.py:tile_sort_geometry never asks for one).
constexpr int kRegWords = 32;

__host__ __device__ constexpr int slot_words(int nk, bool idx, int e) {
  return e * (nk + (idx ? 1 : 0));
}

constexpr bool fits_registers(int nk, bool idx, int e) {
  return slot_words(nk, idx, e) <= 2 * kRegWords;
}

// The most threads an instance may launch with (its __launch_bounds__).
__host__ __device__ constexpr int max_threads(int nk, bool idx, int e) {
  return slot_words(nk, idx, e) <= kRegWords ? kThreads : kThreads / 2;
}

constexpr int kMaxSmem = 232448;   // dynamic shared memory of a CTA, sm_90
constexpr int kMaxDevices = 64;

// Host side: raise a kernel's dynamic shared memory cap to `cap` bytes,
// once per device (the runtime call costs microseconds, which a single-row
// sort, launched from the host each time, would pay at every launch):
// `done` is the kernel instance's own flag array.
inline cudaError_t allow_smem_once(const void* kernel, int cap,
                                   std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

// The cap an instance asks for: its tile at the largest row, 32768 slots,
// or what a CTA has (the wrappers refuse rows that do not fit).
template <int NK, bool IDX>
constexpr int smem_cap() {
  return RegTile<NK, IDX>::bytes(32768) < (size_t)kMaxSmem
             ? (int)RegTile<NK, IDX>::bytes(32768)
             : kMaxSmem;
}

// Host side: calls f(E) with E = slots (4, 8, 16 or 32) as a compile-time
// constant; cudaErrorInvalidValue for any other.
template <class F>
int dispatch_slots(int slots, F&& f) {
  switch (slots) {
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tpusort
