// K5: prefix sum of a 1-D array.  K6: global digit histogram.
//
// K5 replaces the Pallas kernel _scan_kernel behind
// tpusort/kernels/scanhist.py:prefix_sum_tiles.  That kernel threads one
// carry through a grid that runs in order; CTAs run concurrently here, so
// the scan is reduce-then-scan, three launches behind one C entry:
//
//   1. scan_totals_kernel: CTA b sums its fixed chunk of 8,192 elements
//      (1,024 threads x 8 consecutive elements) into totals[b];
//   2. scan_offsets_kernel: one CTA turns totals into their exclusive
//      prefix sums in place (at most 2^18 of them for n < 2^31);
//   3. scan_apply_kernel: CTA b scans its chunk again (each thread its 8
//      elements, a warp-shuffle scan of the thread sums, a scan of the warp
//      sums) and adds offsets[b].
//
// A single chunk skips 1 and 2.  Every chunk, thread and shuffle step is
// fixed by the index alone, so the float32 result does not depend on how
// the CTAs are scheduled: the same input gives the same bits on every run.
// uint32 sums wrap.  The exclusive scan is the inclusive one minus the
// element, as in the Pallas kernel.  Offsets are 64-bit.
//
// Bound: bytes.  The input is read twice and the output written once, 1.5x
// the words the function must move (a decoupled-lookback single pass would
// read it once; later work).
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

#include <cstdint>

namespace tpusort {

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kScanChunk = kScanThreads * kScanItems;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<uint32_t> { using type = uint4; };

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
  __syncthreads();               // the arrays are free for the next call
  return base;
}

// The thread's kScanItems consecutive elements from `first`; zero past n.
template <class T, bool VEC>
__device__ inline void load_items(const T* __restrict__ in, long long first,
                                  long long n, T (&v)[kScanItems]) {
  if (VEC && first + kScanItems <= n) {
    using V = typename Vec4<T>::type;
    const V a = *reinterpret_cast<const V*>(in + first);
    const V b = *reinterpret_cast<const V*>(in + first + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = first + j < n ? in[first + j] : T(0);
    }
  }
}

template <class T>
__device__ inline T sum_items(const T (&v)[kScanItems]) {
  T s = v[0];
#pragma unroll
  for (int j = 1; j < kScanItems; ++j) s += v[j];
  return s;
}

template <class T, bool VEC>
__global__ void __launch_bounds__(kScanThreads)
scan_totals_kernel(const T* __restrict__ in, T* __restrict__ totals,
                   long long n) {
  const long long first =
      (long long)blockIdx.x * kScanChunk + (long long)threadIdx.x * kScanItems;
  T v[kScanItems];
  load_items<T, VEC>(in, first, n, v);
  T total;
  block_exclusive(sum_items(v), &total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// One CTA: totals[0..nb) become their exclusive prefix sums, in place.
template <class T>
__global__ void __launch_bounds__(kScanThreads)
scan_offsets_kernel(T* totals, int nb) {
  T carry = T(0);
  for (int base = 0; base < nb; base += kScanChunk) {
    const int first = base + threadIdx.x * kScanItems;
    T v[kScanItems];
    load_items<T, false>(totals, first, nb, v);
    T total;
    T run = carry + block_exclusive(sum_items(v), &total);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (first + j < nb) totals[first + j] = run;
      run += v[j];
    }
    carry += total;
  }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(kScanThreads)
scan_apply_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const T* __restrict__ offsets, long long n, int exclusive) {
  const long long first =
      (long long)blockIdx.x * kScanChunk + (long long)threadIdx.x * kScanItems;
  T v[kScanItems];
  load_items<T, VEC>(in, first, n, v);
  T total;
  T run = block_exclusive(sum_items(v), &total);
  if (offsets != nullptr) run = offsets[blockIdx.x] + run;
  T o[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    run += v[j];
    o[j] = exclusive ? run - v[j] : run;
  }
  if (VEC && first + kScanItems <= n) {
    using V = typename Vec4<T>::type;
    V a, b;
    a.x = o[0]; a.y = o[1]; a.z = o[2]; a.w = o[3];
    b.x = o[4]; b.y = o[5]; b.z = o[6]; b.w = o[7];
    *reinterpret_cast<V*>(out + first) = a;
    *reinterpret_cast<V*>(out + first + 4) = b;
  } else {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (first + j < n) out[first + j] = o[j];
    }
  }
}

template <class T, bool VEC>
int launch_prefix_sum(const T* in, T* out, T* totals, long long n,
                      int exclusive, cudaStream_t stream) {
  const long long nb = (n + kScanChunk - 1) / kScanChunk;
  if (nb > 1) {
    scan_totals_kernel<T, VEC><<<(unsigned)nb, kScanThreads, 0, stream>>>(
        in, totals, n);
    scan_offsets_kernel<T><<<1, kScanThreads, 0, stream>>>(totals, (int)nb);
  }
  scan_apply_kernel<T, VEC><<<(unsigned)nb, kScanThreads, 0, stream>>>(
      in, out, nb > 1 ? totals : nullptr, n, exclusive);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch_prefix_sum(const void* in, void* out, void* totals, long long n,
                        int exclusive, cudaStream_t stream) {
  const bool vec = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  return vec ? launch_prefix_sum<T, true>((const T*)in, (T*)out, (T*)totals,
                                          n, exclusive, stream)
             : launch_prefix_sum<T, false>((const T*)in, (T*)out, (T*)totals,
                                           n, exclusive, stream);
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
// which wraps, or float32 with is_float), inclusive or exclusive.  totals:
// scratch of ceil(n / 8192) elements.  n >= 1.  Returns a cudaError_t.
extern "C" int tpusort_prefix_sum(const void* in, void* out, void* totals,
                                  long long n, int is_float, int exclusive,
                                  void* stream) {
  using namespace tpusort;
  if (n < 1 || (n + kScanChunk - 1) / kScanChunk > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  return is_float ? dispatch_prefix_sum<float>(in, out, totals, n, exclusive,
                                               (cudaStream_t)stream)
                  : dispatch_prefix_sum<uint32_t>(in, out, totals, n,
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
