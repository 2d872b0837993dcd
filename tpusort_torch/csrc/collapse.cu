// K4: concatenate the valid prefix of every segment into dense outputs.
//
// Replaces both Pallas kernels behind
// tpusort/kernels/collapse.py:collapse_segments: the grouped _collapse_kernel
// (several small segments a grid step) and the chunked
// _collapse_chunk_kernel (segments over the VMEM budget, streamed in
// windows).  That split exists only for VMEM; here one kernel takes every
// segment size.  The Pallas kernels write each group's stream past its end
// and rely on the next in-order grid step to overwrite the overshoot; CTAs
// run concurrently here, so each writes exactly its own range.
//
// Two launches:
//   1. collapse_offsets_kernel, one CTA: each segment's count clamped to
//      [0, seg] and their exclusive cumsum, off[0 .. nseg] (int64);
//   2. collapse_kernel, a grid over the output: CTA c owns the output words
//      [c * 8192, min(n_out, (c + 1) * 8192)), so no CTA is launched for
//      an invalid tail.  It finds the segment of its first and its last
//      word by binary searches of the offsets (an empty segment is never
//      found).  Where fewer than 16 segments meet the chunk, it walks them
//      piece by piece (copy_piece): a scalar head to a 16-byte boundary of
//      the output, then 16-byte stores, each from 4 scalar loads of
//      consecutive words (a piece's source and output differ in alignment),
//      the loads of 4 stores a thread in flight, then a scalar tail.
//      Where more meet it (tiny segments), each thread copies its words
//      t + 256 r one by one, walking on from its previous word's segment
//      (piece by piece, thousands of pieces would run one after another
//      with most threads idle).
//      Words past the sum of the counts are 0.
//
// Bound: memory.  Each valid word is read once and written once, and no
// word past a segment's count is read.  The first version launched a CTA
// for each (segment, 4096-word chunk) of the input, most of which had
// nothing to copy (3 in 4 in the global sort's collapse finish), copied
// word by word with one load in flight a store, and its wrapper cast,
// clamped, zero-filled and scanned the counts in four more launches.  A
// version that staged each chunk in shared memory to store it in aligned
// 16-byte pieces was slower than the first (a load and a barrier between
// every word's load and its store).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "operands.cuh"

namespace tpusort {

constexpr int kCollapseThreads = 256;
constexpr int kCollapseChunk = 8192;    // output words a CTA
constexpr int kCollapseGroups = 4;      // 16-byte stores a thread has in flight
constexpr int kCollapsePieces = 16;     // segments a chunk copies piece by piece
constexpr int kOffsetThreads = 1024;
constexpr int kOffsetPer = 8;           // counts a thread loads a round

// off[s] = sum of clamp(counts[s'], 0, seg) over s' < s, for s in
// [0, nseg], by one CTA in rounds of kOffsetThreads x kOffsetPer counts:
// each thread loads and sums a contiguous block of kOffsetPer, a block-wide
// exclusive scan of the sums, then each thread writes its block's offsets.
template <class C>
__global__ void __launch_bounds__(kOffsetThreads)
collapse_offsets_kernel(const C* __restrict__ counts, int nseg, long long seg,
                        long long* __restrict__ off) {
  __shared__ long long warp_sum[kOffsetThreads / 32 + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long base = 0;                      // the counts before this round
  for (int r0 = 0; r0 < nseg; r0 += kOffsetThreads * kOffsetPer) {
    const int lo = r0 + tid * kOffsetPer;
    long long c[kOffsetPer];
#pragma unroll
    for (int j = 0; j < kOffsetPer; ++j) {
      c[j] = lo + j < nseg ? (long long)counts[lo + j] : 0;
    }
    long long sum = 0;
#pragma unroll
    for (int j = 0; j < kOffsetPer; ++j) {
      c[j] = c[j] < 0 ? 0 : (c[j] > seg ? seg : c[j]);
      sum += c[j];
    }
    long long x = sum;                     // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const long long w = warp_sum[lane];
      long long z = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xFFFFFFFFu, z, o);
        if (lane >= o) z += y;
      }
      warp_sum[lane] = z - w;              // exclusive, over the warps
      if (lane == 31) warp_sum[32] = z;    // the round's total
    }
    __syncthreads();
    long long run = base + warp_sum[warp] + x - sum;
#pragma unroll
    for (int j = 0; j < kOffsetPer; ++j) {
      if (lo + j < nseg) off[lo + j] = run;
      run += c[j];
    }
    base += warp_sum[32];
    __syncthreads();             // warp_sum is rewritten by the next round
  }
  if (tid == 0) off[nseg] = base;
}

// The largest s in [a, b] with off[s] <= o (off[a] <= o).
__device__ __forceinline__ int segment_of(const long long* __restrict__ off,
                                          long long o, int a, int b) {
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (__ldg(off + m) <= o) {
      a = m;
    } else {
      b = m - 1;
    }
  }
  return a;
}

// n words from in to out (in null: zeros, past the sum), with every
// thread of the CTA: a scalar head up to a 16-byte boundary of out, then
// each thread stores 16 bytes from 4 scalar loads, the loads of
// kCollapseGroups stores issued before the stores, then a scalar tail.
__device__ __forceinline__ void copy_piece(const uint32_t* __restrict__ in,
                                           uint32_t* __restrict__ out,
                                           int n) {
  const int tid = threadIdx.x;
  const int head =
      min(n, (int)((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4);
  if (tid < head) out[tid] = in ? in[tid] : 0u;
  const int end = head + ((n - head) & ~3);
  for (int q0 = head + 4 * tid; q0 < end;
       q0 += 4 * kCollapseThreads * kCollapseGroups) {
    uint32_t w[kCollapseGroups][4];
#pragma unroll
    for (int u = 0; u < kCollapseGroups; ++u) {
      const int q = q0 + 4 * kCollapseThreads * u;
#pragma unroll
      for (int j = 0; j < 4; ++j) w[u][j] = q < end && in ? in[q + j] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kCollapseGroups; ++u) {
      const int q = q0 + 4 * kCollapseThreads * u;
      if (q < end) {
        *reinterpret_cast<uint4*>(out + q) =
            make_uint4(w[u][0], w[u][1], w[u][2], w[u][3]);
      }
    }
  }
  if (tid < n - end) out[end + tid] = in ? in[end + tid] : 0u;
}

__global__ void __launch_bounds__(kCollapseThreads)
collapse_kernel(Operands ops, const long long* __restrict__ off, int nseg,
                long long seg, long long n_out) {
  __shared__ int ends[2];
  const int tid = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * kCollapseChunk;
  const long long o1 = min(o0 + kCollapseChunk, n_out);
  if (tid < 2) {                 // the segments of the first and last word
    ends[tid] = segment_of(off, tid ? o1 - 1 : o0, 0, nseg);
  }
  __syncthreads();
  const int s_first = ends[0], s_last = ends[1];
  if (s_last - s_first < kCollapsePieces) {
    // a few segments: piece by piece, 16-byte stores
    for (int s = s_first; s <= s_last; ++s) {
      const long long from = __ldg(off + s);
      const long long a = max(o0, from);
      const long long b = s < nseg ? min(o1, __ldg(off + s + 1)) : o1;
      if (a >= b) continue;                // an empty segment
      for (int k = 0; k < ops.count; ++k) {
        copy_piece(s < nseg ? ops.in[k] + s * seg + (a - from) : nullptr,
                   ops.out[k] + a, (int)(b - a));
      }
    }
    return;
  }
  // many small segments: word by word, each thread walking on from its
  // previous word's segment (a binary search where it must skip several)
  const int len = (int)(o1 - o0);
  for (int k = 0; k < ops.count; ++k) {
    const uint32_t* __restrict__ in = ops.in[k];
    uint32_t* __restrict__ out = ops.out[k] + o0;
    int s = s_first;
    long long from = __ldg(off + s);
    long long next = s < nseg ? __ldg(off + s + 1) : LLONG_MAX;
    for (int i = tid; i < len; i += kCollapseThreads) {
      const long long o = o0 + i;
      if (s < s_last && o >= next) {
        s = segment_of(off, o, s + 1, s_last);
        from = __ldg(off + s);
        next = s < nseg ? __ldg(off + s + 1) : LLONG_MAX;
      }
      out[i] = s < nseg ? in[s * seg + (o - from)] : 0u;
    }
  }
}

// The offsets launch of either entry point below.
inline cudaError_t launch_offsets(const void* counts, int counts_64,
                                  int nseg, long long seg, long long* off,
                                  cudaStream_t st) {
  if (counts_64) {
    collapse_offsets_kernel<<<1, kOffsetThreads, 0, st>>>(
        static_cast<const long long*>(counts), nseg, seg, off);
  } else {
    collapse_offsets_kernel<<<1, kOffsetThreads, 0, st>>>(
        static_cast<const int32_t*>(counts), nseg, seg, off);
  }
  return cudaGetLastError();
}

}  // namespace tpusort

// ops_in/ops_out: n_ops (1-16) device pointers each, inputs (nseg, seg)
// row-major, outputs (n_out,) and 16-byte aligned; counts: (nseg,) int32,
// or int64 with counts_64, clamped here to [0, seg]; offsets: nseg + 1
// int64 of scratch, where the exclusive cumsum of the clamped counts is
// left.  Returns a cudaError_t.
extern "C" int tpusort_collapse(const void* const* ops_in,
                                void* const* ops_out, int n_ops,
                                const void* counts, int counts_64,
                                void* offsets, long long n_out, int nseg,
                                int seg, void* stream) {
  using namespace tpusort;
  Operands ops;
  if (!make_operand_list(ops_in, ops_out, n_ops, &ops) || nseg < 0 ||
      seg < 0 || n_out < 0 || !aligned16(ops_out, n_ops)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n_out + kCollapseChunk - 1) / kCollapseChunk;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  long long* off = static_cast<long long*>(offsets);
  cudaError_t err = launch_offsets(counts, counts_64, nseg, seg, off, st);
  if (err != cudaSuccess) return (int)err;
  collapse_kernel<<<(unsigned)blocks, kCollapseThreads, 0, st>>>(
      ops, off, nseg, seg, n_out);
  return (int)cudaGetLastError();
}

// The first launch alone: offsets (nseg + 1 int64) the exclusive cumsum of
// the (nseg,) counts (int32, or int64 with counts_64) clamped to [0, seg],
// for a kernel that writes the segments dense itself (the packed leaf's
// runs body, sort_tiles.cu).  Returns a cudaError_t.
extern "C" int tpusort_collapse_offsets(const void* counts, int counts_64,
                                        void* offsets, int nseg, int seg,
                                        void* stream) {
  using namespace tpusort;
  if (nseg < 0 || seg < 0) return (int)cudaErrorInvalidValue;
  return (int)launch_offsets(counts, counts_64, nseg, seg,
                             static_cast<long long*>(offsets),
                             (cudaStream_t)stream);
}
