// K5: prefix sum of a 1-D array.  K6: global digit histogram.
//
// K5 replaces the Pallas kernel _scan_kernel behind
// tpusort/kernels/scanhist.py:prefix_sum_tiles.  That kernel threads one
// carry through a grid that runs in order, "the TPU-native replacement for
// CUB's decoupled lookback"; CTAs run in no order here, so the port goes
// back to a look-back (after Merrill and Garland's single-pass scan with
// decoupled look-back).  One launch, scan_lookback_kernel, reads each
// element once and writes it once:
//
//   1. a CTA takes its tile id from an atomic counter, in the order the
//      CTAs start (not blockIdx): every tile it waits on has started, and
//      none waits on a later one, so the look-back always progresses;
//   2. it copies its tile of 8,192 elements into shared memory with
//      cp.async (16 bytes a copy, striped over 512 threads, where the tile
//      is whole and the views aligned; else 4-byte copies and zeros past
//      n), reduces it (each thread its 16 consecutive elements in order,
//      then a warp-shuffle scan of the thread sums and a scan of the warp
//      sums) and publishes the aggregate in the tile's descriptor;
//   3. warp 0 looks back (look_back): tiles come in groups of 128, and
//      tile b's exclusive prefix is its group's anchor, the sum of every
//      tile before the group, plus the group's aggregates below b, which
//      the warp reads (4 a lane, all in flight) and sums in a fixed tree;
//      the group's last tile publishes the next anchor;
//   4. the CTA scans its tile in place from that prefix and stores it,
//      16 bytes a thread, striped.
//
// Descriptors are 64-bit words, zeroed by the wrapper (one fill; the
// kernel allocates nothing): an aggregate is 1 << 32 | its bits; an
// anchor is its carry with status 1 in the two low bits.  Both are stored
// with release semantics and read with relaxed loads followed by one
// acquire fence, at device scope.
//
// float32 stays bit-reproducible and accurate.  A textbook look-back adds
// its predecessors' aggregates in whatever order their publication races
// leave, so the bits would depend on timing.  Here every sum has a fixed
// association: an anchor is the previous anchor plus a fixed tree of its
// group's aggregates, so the anchors are one left fold over the groups,
// and a tile's prefix adds a fixed tree of the group's aggregates below
// it; within a tile the order is fixed by the index alone.  So the same
// input gives the same bits on every run, whatever the schedule.  The
// look-back sums in float64 for float32 input (anchors keep 50 mantissa
// bits): a float32 left fold over the tiles, the Pallas kernel's carry
// order, drifts with their number, past 1e-6 of the running sum at 2^22.
// Integer sums wrap (uint32; int32 as its bits) and are exact in any
// order, so the same code serves all three types.  The exclusive scan is
// the inclusive one minus the element, as in the Pallas kernel.
//
// What paces it.  Any look-back waits, after its own copy, until every
// earlier tile it reads has published (tiles finish their copies out of
// order), plus a round trip to L2; here a tile also waits for its group's
// anchor, one hop of the anchor chain per 128 tiles.  Other designs this
// kernel went through ran slower at 2^28: a window folded forward from the
// nearest inclusive prefix one tile at a time (the fold is serial), a
// Fenwick tree of node sums (chains of dependent publications), a Fenwick
// tree over the groups (spills at 32 registers) and tiles held in
// registers (two CTAs an SM); a decoupled look-back over the groups in
// place of the anchor chain ran no faster.  The tile lives in shared
// memory, so a thread holds 32 registers and four 512-thread CTAs share
// an SM: while some wait in the look-back, the others' copies keep the
// memory busy.
//
// Bound: bytes.  Each element is read once and written once: 2 words an
// element at 3.35 TB/s (0.641 ms at 2^28); descriptors add 8 bytes a tile.
//
// K6 replaces _hist_kernel behind scanhist.py:digit_histogram_tiles, which
// keeps one VMEM vector of bins across a grid that runs in order.  Bound:
// bytes.  Each key is read once, n x 4 bytes at 3.35 TB/s (0.321 ms at
// 2^28), and the counts are one add a key, well under the card's integer
// rate; so the kernel must keep enough reads in flight and spend few
// instructions, and above all few conflicting shared atomics, a key.
//
//   1. Loads.  The grid is the CTAs that fit on the card at once (the SM
//      count times the occupancy), each of 16 warps.  The 16-byte body
//      comes in chunks of 4 x 32 vectors; a warp takes every (warps in the
//      grid)-th chunk and issues its 4 loads (lane l: vectors 32 k + l, so
//      each load is coalesced) before it counts any of them: 64 bytes a
//      thread, 64 KB or more an SM, in flight.  The keys before the first
//      16-byte boundary and after the last whole chunk (at most 3 + 511)
//      go to the grid's last warp, one a lane.
//   2. Up to 8 bins (bits <= 3): registers.  A thread counts bin d in the
//      8-bit field d % 4 of one of two words (+= 1 << 8 (d % 4), the word
//      chosen by a select, so nothing is indexed), which takes 240 keys,
//      15 chunks, before a field could pass 255; then the warp adds the
//      fields with __reduce_add_sync (two bins a sum, in 16-bit halves)
//      into lane b's total of bin b, and starts again from zero.  No
//      atomic until the merge, whatever the keys.
//   3. More bins: shared memory, a copy a warp (16 x 256 x 4 B = 16 KB a
//      CTA), so no two warps ever add to one word.  A thread keeps two
//      (digit, run) pairs over its keys in order and adds a run to its
//      warp's bin only when a key matches neither pair (the older run goes
//      out) and at the end.  Constant and presorted keys, and any stretch
//      of keys with two digits in any order, then cost no atomic a key;
//      uniform keys one, at few conflicts (32 lanes over many bins).  The
//      worst case is many lanes of one instruction missing both pairs onto
//      one bin, e.g. three digits taken in turn.
//   4. Merge.  After __syncthreads, thread b sums bin b over the warps and
//      adds it, if not 0, to the zeroed output with one global atomicAdd.
//
// Integer adds commute, so the counts are exact in any order, and equal
// torch.bincount of the digit on every input.
#include <cuda_runtime.h>

#include <cuda/atomic>

#include <cstdint>
#include <type_traits>

namespace tpusort {

constexpr int kScanThreads = 512;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kGroupTiles = 128;                  // tiles a group anchors
constexpr int kLookSlots = kGroupTiles / 32;      // descriptors a lane reads
constexpr unsigned kFullWarp = 0xFFFFFFFFu;
constexpr unsigned long long kPublished = 1ull << 32;  // an aggregate's flag

template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<uint32_t> { using type = uint4; };

// The sums the look-back forms from tile aggregates, and the anchors'
// descriptor words (status in the low two bits, 0 = not yet published).
// uint32: the sum itself, wrapping.  float32: float64, the anchor's two
// lowest mantissa bits cleared for the status when it is published.
template <class T> struct Carry;

template <> struct Carry<uint32_t> {
  using type = uint32_t;
  static __device__ __forceinline__ uint32_t of(uint32_t bits) { return bits; }
  static __device__ __forceinline__ unsigned long long pack(uint32_t c) {
    return (unsigned long long)c << 2 | 1u;
  }
  static __device__ __forceinline__ uint32_t unpack(unsigned long long w) {
    return (uint32_t)(w >> 2);
  }
};

template <> struct Carry<float> {
  using type = double;
  static __device__ __forceinline__ double of(uint32_t bits) {
    return (double)__uint_as_float(bits);
  }
  static __device__ __forceinline__ unsigned long long pack(double c) {
    return ((unsigned long long)__double_as_longlong(c) & ~3ull) | 1u;
  }
  static __device__ __forceinline__ double unpack(unsigned long long w) {
    return __longlong_as_double((long long)(w & ~3ull));
  }
};

__device__ __forceinline__ uint32_t bits_of(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}

using Descriptor = cuda::atomic_ref<unsigned long long,
                                    cuda::thread_scope_device>;

__device__ __forceinline__ void publish(unsigned long long* d,
                                        unsigned long long w) {
  Descriptor(*d).store(w, cuda::std::memory_order_release);
}

__device__ __forceinline__ unsigned long long peek(unsigned long long* d) {
  return Descriptor(*d).load(cuda::std::memory_order_relaxed);
}

// Inclusive scan of v over the warp's lanes, in lane order.
template <class T>
__device__ inline T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = __shfl_up_sync(kFullWarp, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// The sum of v over the block's lower threads (0 for thread 0), and the
// block's total in *total.  Additions only, in an order the thread index
// fixes.  Every thread of the block calls it; blockDim.x is a multiple of 32.
template <class T>
__device__ inline T block_exclusive(T v, T* total) {
  __shared__ T warp_sum[32];
  __shared__ T block_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T inc = warp_inclusive(v, lane);
  T excl = __shfl_up_sync(kFullWarp, inc, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : T(0);
    const T winc = warp_inclusive(w, lane);
    T wexcl = __shfl_up_sync(kFullWarp, winc, 1);
    if (lane == 0) wexcl = T(0);
    warp_sum[lane] = wexcl;
    if (lane == 31) block_total = winc;
  }
  __syncthreads();
  const T base = warp_sum[warp] + excl;
  *total = block_total;
  return base;
}

// Asynchronous copies from global to shared memory (cp.async): the data
// in flight holds no registers.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

// Tile b's exclusive prefix, on one warp (every lane returns it).  b lies
// in group g = b / 128 at position r = b % 128.  Lane l waits, with relaxed
// loads all in flight together, for the aggregates of the group's tiles
// 4 l .. 4 l + 3 that lie below b (look[] keeps them), and lane 31 also
// for the group's anchor A(g), the sum of every tile before the group
// (A(0) = 0); then an acquire fence.  The group's aggregates below b are
// summed in a fixed tree: each lane its 4 in order, then the lanes' sums
// by butterfly (every lane ends with the same bits: addition commutes).
// The prefix is A(g) + that sum.  The group's last tile also publishes the
// next anchor, A(g + 1) = A(g) + (that sum + its own aggregate).
template <class T>
__device__ typename Carry<T>::type look_back(unsigned long long* agg,
                                             unsigned long long* anchor,
                                             long long b, long long nb,
                                             int lane, T total,
                                             uint32_t* look) {
  using C = Carry<T>;
  using V = typename C::type;
  const long long g = b / kGroupTiles;
  const int r = (int)(b - g * kGroupTiles);
  const long long first = g * kGroupTiles;
  unsigned pending = 0;                      // slots still to be read
#pragma unroll
  for (int k = 0; k < kLookSlots; ++k) {
    if (lane * kLookSlots + k < r) pending |= 1u << k;
  }
  unsigned long long a = lane == 31 && g > 0 ? 0 : C::pack(0);
  while (__any_sync(kFullWarp, pending != 0 || a == 0)) {
#pragma unroll
    for (int k = 0; k < kLookSlots; ++k) {
      if (pending & (1u << k)) {
        const int i = lane * kLookSlots + k;
        const unsigned long long w = peek(agg + first + i);
        if (w) {
          look[i] = (uint32_t)w;
          pending &= ~(1u << k);
        }
      }
    }
    if (a == 0) a = peek(anchor + g);
    if (pending != 0 || a == 0) __nanosleep(32);
  }
  cuda::atomic_thread_fence(cuda::std::memory_order_acquire,
                            cuda::thread_scope_device);
  V s = 0;
#pragma unroll
  for (int k = 0; k < kLookSlots; ++k) {
    const int i = lane * kLookSlots + k;
    if (i < r) s += C::of(look[i]);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) s += __shfl_xor_sync(kFullWarp, s, d);
  const V base = C::unpack(__shfl_sync(kFullWarp, a, 31));
  if (lane == 0 && r == kGroupTiles - 1 && b + 1 < nb) {
    publish(anchor + g + 1, C::pack(base + (s + C::of(bits_of(total)))));
  }
  return base + s;
}

// One launch: a CTA takes tile b from the counter, copies it into shared
// memory (16-byte cp.async, striped over the threads, where the whole tile
// is aligned and inside n; else 4-byte ones and zeros past n), reduces it
// (thread t its 16 consecutive elements in order, then block_exclusive),
// publishes its aggregate, looks back for its exclusive prefix, scans the
// tile in place (element j of a thread is (the prefix + the sum below the
// thread) + the thread's own running sum, in that order) and stores it
// striped, 16 bytes a thread where aligned.  The tile lives in shared
// memory, so a thread holds few registers and four CTAs share an SM: while
// some wait in the look-back, the others' copies keep the memory busy.
template <class T, bool VEC>
__global__ void __launch_bounds__(kScanThreads, 4)
scan_lookback_kernel(const T* __restrict__ in, T* __restrict__ out,
                     unsigned long long* agg, unsigned long long* anchor,
                     unsigned long long* counter, long long n, long long nb,
                     int exclusive) {
  using C = Carry<T>;
  using V = typename Vec4<T>::type;
  __shared__ __align__(16) T tile[kScanTile];
  __shared__ uint32_t look[kGroupTiles];
  __shared__ unsigned long long tile_id;
  __shared__ typename C::type tile_prefix;
  const int tid = threadIdx.x;
  if (tid == 0) tile_id = atomicAdd(counter, 1ull);
  __syncthreads();
  const long long b = (long long)tile_id;
  const long long base = b * kScanTile;
  const int valid = n - base < kScanTile ? (int)(n - base) : kScanTile;
  const bool whole = VEC && valid == kScanTile;
  if (whole) {
#pragma unroll
    for (int k = 0; k < kScanItems / 4; ++k) {
      const int q = 4 * (tid + k * kScanThreads);
      copy16_async(tile + q, in + base + q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int e = tid + k * kScanThreads;
      if (e < valid) {
        copy4_async(tile + e, in + base + e);
      } else {
        tile[e] = T(0);
      }
    }
  }
  wait_copies();
  __syncthreads();
  T* mine = tile + tid * kScanItems;
  T s = mine[0];
#pragma unroll
  for (int j = 1; j < kScanItems; ++j) s += mine[j];
  T total;
  const T below = block_exclusive(s, &total);
  if (tid < 32) {
    if (tid == 0) publish(agg + b, kPublished | bits_of(total));
    const typename C::type prefix =
        look_back<T>(agg, anchor, b, nb, tid, total, look);
    if (tid == 0) tile_prefix = prefix;
  }
  __syncthreads();
  const T head = (T)tile_prefix + below;
  T run = T(0);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const T x = mine[j];
    run += x;
    const T inc = head + run;
    mine[j] = exclusive ? inc - x : inc;
  }
  __syncthreads();
  if (whole) {
#pragma unroll
    for (int k = 0; k < kScanItems / 4; ++k) {
      const int q = 4 * (tid + k * kScanThreads);
      *reinterpret_cast<V*>(out + base + q) =
          *reinterpret_cast<const V*>(tile + q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int e = tid + k * kScanThreads;
      if (e < valid) out[base + e] = tile[e];
    }
  }
}

// The scratch words a launch needs: an aggregate a tile, an anchor a
// group, the counter.
__host__ __device__ constexpr long long scan_scratch_words(long long nb) {
  return nb + (nb + kGroupTiles - 1) / kGroupTiles + 1;
}

template <class T>
int launch_prefix_sum(const void* in, void* out, void* scratch, long long n,
                      int exclusive, cudaStream_t stream) {
  const long long nb = (n + kScanTile - 1) / kScanTile;
  auto* agg = static_cast<unsigned long long*>(scratch);
  auto* anchor = agg + nb;
  auto* counter = agg + scan_scratch_words(nb) - 1;
  const bool vec = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  if (vec) {
    scan_lookback_kernel<T, true><<<(unsigned)nb, kScanThreads, 0, stream>>>(
        (const T*)in, (T*)out, agg, anchor, counter, n, nb, exclusive);
  } else {
    scan_lookback_kernel<T, false><<<(unsigned)nb, kScanThreads, 0, stream>>>(
        (const T*)in, (T*)out, agg, anchor, counter, n, nb, exclusive);
  }
  return (int)cudaGetLastError();
}

constexpr int kHistWarps = 16;
constexpr int kHistThreads = 32 * kHistWarps;
constexpr int kHistMaxBins = 256;
constexpr int kHistRegBins = 8;          // bits <= 3: counts in registers
constexpr int kHistLoads = 4;            // 16-byte loads in flight a thread
constexpr int kHistChunkVecs = 32 * kHistLoads;
constexpr int kHistChunkKeys = 4 * kHistChunkVecs;
constexpr int kHistChunkKeysLane = 4 * kHistLoads;    // a lane's keys a chunk
constexpr int kHistFlushEvery = 255 / kHistChunkKeysLane;   // chunks
constexpr int kHistRestSteps = (3 + kHistChunkKeys - 1 + 31) / 32;
// a field holds what a lane counts between two flushes: at most
// kHistFlushEvery - 1 chunks before the loop ends, then the rest
static_assert((kHistFlushEvery - 1) * kHistChunkKeysLane + kHistRestSteps
                  <= 255 && kHistFlushEvery * kHistChunkKeysLane <= 255,
              "an 8-bit field could pass 255");

// Counts in 8-bit register fields: bins 0-3 in lo, 4-7 in hi; lane b < 8
// holds the warp's flushed total of bin b.
struct RegCounts {
  uint32_t lo = 0, hi = 0, total = 0;

  __device__ __forceinline__ void add(uint32_t d, bool ok = true) {
    const uint32_t inc = ok ? 1u << ((d & 3u) << 3) : 0u;
    lo += d < 4u ? inc : 0u;
    hi += d < 4u ? 0u : inc;
  }

  // Every lane of the warp calls it.  The masked halves hold two fields in
  // 16 bits each, whose sum over 32 lanes (at most 32 x 255) cannot carry.
  __device__ __forceinline__ void flush(int lane) {
    const uint32_t e0 = __reduce_add_sync(kFullWarp, lo & 0x00FF00FFu);
    const uint32_t o0 = __reduce_add_sync(kFullWarp, (lo >> 8) & 0x00FF00FFu);
    const uint32_t e1 = __reduce_add_sync(kFullWarp, hi & 0x00FF00FFu);
    const uint32_t o1 = __reduce_add_sync(kFullWarp, (hi >> 8) & 0x00FF00FFu);
    const uint32_t w = lane & 4 ? (lane & 1 ? o1 : e1) : (lane & 1 ? o0 : e0);
    total += (w >> ((lane & 2) << 3)) & 0xFFFFu;
    lo = hi = 0;
  }

  __device__ __forceinline__ void finish(uint32_t* wbins, int lane) {
    flush(lane);
    if (lane < kHistRegBins) wbins[lane] = total;
  }
};

// Counts as runs into the warp's own shared bins: the two latest digits a
// key matched, each with its run; c0 != c1 always (bins >= 16 here).
struct RunCounts {
  uint32_t* wbins;
  uint32_t c0 = 0, c1 = 1, r0 = 0, r1 = 0;

  __device__ __forceinline__ void add(uint32_t d, bool ok = true) {
    if (!ok) return;
    if (d != c0 && d != c1) {
      if (r1) atomicAdd(wbins + c1, r1);
      c1 = c0;
      r1 = r0;
      c0 = d;
      r0 = 0;
    }
    r0 += d == c0;
    r1 += d == c1;
  }

  __device__ __forceinline__ void finish(uint32_t*, int) {
    if (r0) atomicAdd(wbins + c0, r0);
    if (r1) atomicAdd(wbins + c1, r1);
  }
};

// in[0..n): the keys; in + head is 16-byte aligned and full chunks of
// kHistChunkKeys keys follow it; the rest (the head and what follows the
// chunks) goes to the grid's last warp.  out: (bins,) int32, zeroed.
template <bool kRegs>
__global__ void __launch_bounds__(kHistThreads)
digit_histogram_kernel(const uint32_t* __restrict__ in, long long n,
                       long long head, long long full, int shift,
                       uint32_t mask, int bins, int* __restrict__ out) {
  constexpr int kBins = kRegs ? kHistRegBins : kHistMaxBins;
  __shared__ uint32_t warp_bins[kHistWarps][kBins];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* wbins = warp_bins[warp];
  for (int b = lane; b < kBins; b += 32) wbins[b] = 0;
  __syncwarp();
  typename std::conditional<kRegs, RegCounts, RunCounts>::type c;
  if constexpr (!kRegs) c.wbins = wbins;
  const long long gwarp = (long long)blockIdx.x * kHistWarps + warp;
  const long long nwarps = (long long)gridDim.x * kHistWarps;
  const uint4* body = reinterpret_cast<const uint4*>(in + head) + lane;
  int since_flush = 0;
  for (long long ch = gwarp; ch < full; ch += nwarps) {
    const uint4* p = body + ch * kHistChunkVecs;
    uint4 v[kHistLoads];
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) v[k] = __ldg(p + 32 * k);
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) {
      c.add((v[k].x >> shift) & mask);
      c.add((v[k].y >> shift) & mask);
      c.add((v[k].z >> shift) & mask);
      c.add((v[k].w >> shift) & mask);
    }
    if constexpr (kRegs) {
      if (++since_flush == kHistFlushEvery) {   // the whole warp
        c.flush(lane);
        since_flush = 0;
      }
    }
  }
  if (gwarp == nwarps - 1) {
    const long long tail = head + full * kHistChunkKeys;
    const long long rest = head + (n - tail);
    for (long long i = lane; i - lane < rest; i += 32) {
      const bool ok = i < rest;
      const uint32_t key = ok ? in[i < head ? i : tail + (i - head)] : 0u;
      c.add((key >> shift) & mask, ok);
    }
  }
  c.finish(wbins, lane);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kHistWarps; ++w) s += warp_bins[w][b];
    if (s) atomicAdd(&out[b], (int)s);
  }
}

// The CTAs of the instance that fit on the card at once, per device.
template <bool kRegs>
cudaError_t resident_hist_blocks(int* blocks) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev]) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, digit_histogram_kernel<kRegs>, kHistThreads, 0);
  }
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <bool kRegs>
int launch_digit_histogram(const uint32_t* in, long long n, long long head,
                           int shift, int bits, int* out,
                           cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = resident_hist_blocks<kRegs>(&resident);
  if (err != cudaSuccess) return (int)err;
  const long long full = (n - head) / kHistChunkKeys;
  long long blocks = (full + kHistWarps - 1) / kHistWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > resident) blocks = resident;
  digit_histogram_kernel<kRegs><<<(unsigned)blocks, kHistThreads, 0,
                                  stream>>>(in, n, head, full, shift,
                                            (1u << bits) - 1u, 1 << bits,
                                            out);
  return (int)cudaGetLastError();
}

}  // namespace tpusort

// Prefix sum of in[0..n) into out (both (n,) of 4-byte elements: uint32,
// which wraps, or float32 with is_float), inclusive or exclusive, in one
// launch.  scratch: nb = ceil(n / 8192) tile aggregates, ceil(nb / 128)
// group anchors and the tile counter, 64-bit words, zeroed by the caller.
// n >= 1.  Returns a cudaError_t.
extern "C" int tpusort_prefix_sum(const void* in, void* out, void* scratch,
                                  long long n, int is_float, int exclusive,
                                  void* stream) {
  using namespace tpusort;
  if (n < 1 || (n + kScanTile - 1) / kScanTile > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  return is_float ? launch_prefix_sum<float>(in, out, scratch, n, exclusive,
                                             (cudaStream_t)stream)
                  : launch_prefix_sum<uint32_t>(in, out, scratch, n,
                                                exclusive,
                                                (cudaStream_t)stream);
}

// out[d] += the number of keys in[0..n) whose digit (key >> shift) & (2^bits
// - 1) is d; out is (2^bits,) int32 and zeroed by the caller; bits <= 8;
// in 4-byte aligned.  One launch.  Returns a cudaError_t.
extern "C" int tpusort_digit_histogram(const void* in, long long n, int shift,
                                       int bits, void* out, void* stream) {
  using namespace tpusort;
  if (n < 0 || bits < 1 || (1 << bits) > kHistMaxBins || shift < 0 ||
      shift + bits > 32 || ((uintptr_t)in & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  long long head = ((16 - ((uintptr_t)in & 15)) & 15) / 4;
  if (head > n) head = n;
  const auto* keys = static_cast<const uint32_t*>(in);
  return (1 << bits) <= kHistRegBins
             ? launch_digit_histogram<true>(keys, n, head, shift, bits,
                                            (int*)out, (cudaStream_t)stream)
             : launch_digit_histogram<false>(keys, n, head, shift, bits,
                                             (int*)out, (cudaStream_t)stream);
}
