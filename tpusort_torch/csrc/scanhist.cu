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
// accumulates into one VMEM vector across the ordered grid.  Here each CTA
// keeps a shared-memory histogram (atomicAdd on shared int32), walks the
// keys 16 bytes a thread in a grid-stride loop, and adds its non-zero bins
// to the zeroed global output with one atomicAdd each.  Integer adds
// commute, so the counts are exact in any order.  A warp whose 32 keys
// share one digit (constant or presorted keys) adds 32 with one atomic, by
// __match_all_sync; otherwise every thread adds 1.  Any n: the keys before
// the first 16-byte boundary and after the last whole vector are counted
// one by one.  Bound: bytes (each key read once).
#include <cuda_runtime.h>

#include <cuda/atomic>

#include <cstdint>

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

constexpr int kHistThreads = 512;
constexpr int kHistMaxBins = 256;
constexpr int kHistMaxBlocks = 132 * 8;

// Count digit d once for every thread of the mask m (the calling threads).
__device__ inline void count_digit(int* hist, uint32_t d, unsigned m,
                                   int lane) {
  int same;
  __match_all_sync(m, d, &same);
  if (same) {
    if (lane == __ffs(m) - 1) atomicAdd(&hist[d], __popc(m));
  } else {
    atomicAdd(&hist[d], 1);
  }
}

__global__ void __launch_bounds__(kHistThreads)
digit_histogram_kernel(const uint32_t* __restrict__ in, long long n,
                       long long head, int shift, uint32_t mask, int bins,
                       int* __restrict__ out) {
  __shared__ int hist[kHistMaxBins];
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const uint4* body = reinterpret_cast<const uint4*>(in + head);
  const long long nv = (n - head) / 4;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop's bounds are the same for a whole warp, so all 32 lanes reach
  // the ballot
  const long long warp0 =
      (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
  for (long long base = warp0; base < nv; base += stride) {
    const long long i = base + lane;
    const bool ok = i < nv;
    const unsigned m = __ballot_sync(kFullWarp, ok);
    if (ok) {
      const uint4 v = body[i];
      count_digit(hist, (v.x >> shift) & mask, m, lane);
      count_digit(hist, (v.y >> shift) & mask, m, lane);
      count_digit(hist, (v.z >> shift) & mask, m, lane);
      count_digit(hist, (v.w >> shift) & mask, m, lane);
    }
  }
  if (blockIdx.x == 0) {
    // the keys outside the vectors: before the first 16-byte boundary and
    // after the last whole vector, six at most
    const long long tail = head + nv * 4;
    const long long extra = head + (n - tail);
    if (threadIdx.x < extra) {
      const long long i =
          threadIdx.x < head ? threadIdx.x : tail + (threadIdx.x - head);
      atomicAdd(&hist[(in[i] >> shift) & mask], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const int c = hist[i];
    if (c) atomicAdd(&out[i], c);
  }
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
// - 1) is d; out is (2^bits,) int32 and zeroed by the caller; bits <= 8.
// Returns a cudaError_t.
extern "C" int tpusort_digit_histogram(const void* in, long long n, int shift,
                                       int bits, void* out, void* stream) {
  using namespace tpusort;
  if (n < 0 || bits < 1 || (1 << bits) > kHistMaxBins || shift < 0 ||
      shift + bits > 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  long long head = ((16 - ((uintptr_t)in & 15)) & 15) / 4;
  if (head > n) head = n;
  const long long nv = (n - head) / 4;
  long long blocks = (nv + kHistThreads - 1) / kHistThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kHistMaxBlocks) blocks = kHistMaxBlocks;
  digit_histogram_kernel<<<(unsigned)blocks, kHistThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)in, n, head, shift, (1u << bits) - 1u, 1 << bits,
      (int*)out);
  return (int)cudaGetLastError();
}
