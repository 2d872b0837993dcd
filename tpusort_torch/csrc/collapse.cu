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
// A 1-D grid over (segment s, chunk c of kChunk words): the CTA copies words
// [c * kChunk, min(count_s, (c + 1) * kChunk)) of segment s of every operand
// to out[offset_s + c * kChunk ...], clipped at n_out.  offset_s, the
// exclusive cumsum of the counts, comes from the wrapper.
//
// Bound: memory.  Each valid word is read once and written once; no word past
// a segment's count is read.  A chunk's reads are contiguous; its writes
// start at any word offset, so they coalesce within a warp but are not
// vectorised.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tile_sort.cuh"

namespace tpusort {

constexpr int kCollapseThreads = 256;
constexpr int kCollapseChunk = 4096;

__global__ void __launch_bounds__(kCollapseThreads)
collapse_kernel(Operands ops, const int32_t* __restrict__ counts,
                const long long* __restrict__ offsets, long long n_out,
                long long seg, long long chunks) {
  const long long b = blockIdx.x;
  const long long s = b / chunks;
  const long long lo = (b - s * chunks) * kCollapseChunk;
  const long long cnt = counts[s];
  if (lo >= cnt) return;
  const long long dst = offsets[s] + lo;
  long long len = cnt - lo;
  if (len > kCollapseChunk) len = kCollapseChunk;
  if (len > n_out - dst) len = n_out - dst;
  const size_t src = (size_t)s * seg + lo;
  for (int k = 0; k < ops.count; ++k) {
    const uint32_t* __restrict__ in = ops.in[k] + src;
    uint32_t* __restrict__ out = ops.out[k] + dst;
    for (long long i = threadIdx.x; i < len; i += blockDim.x) out[i] = in[i];
  }
}

}  // namespace tpusort

// ops_in/ops_out: n_ops (1-16) device pointers each, inputs (nseg, seg)
// row-major, outputs (n_out,); counts: (nseg,) int32 in [0, seg]; offsets:
// (nseg,) int64, their exclusive cumsum.  Returns a cudaError_t.
extern "C" int tpusort_collapse(const void* const* ops_in,
                                void* const* ops_out, int n_ops,
                                const void* counts, const void* offsets,
                                long long n_out, int nseg, int seg,
                                void* stream) {
  using namespace tpusort;
  Operands ops;
  if (!make_operand_list(ops_in, ops_out, n_ops, &ops) || nseg < 0 ||
      seg < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long chunks = ((long long)seg + kCollapseChunk - 1) / kCollapseChunk;
  const long long blocks = (long long)nseg * chunks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0 || n_out <= 0) return (int)cudaSuccess;
  collapse_kernel<<<(unsigned)blocks, kCollapseThreads, 0,
                    (cudaStream_t)stream>>>(
      ops, (const int32_t*)counts, (const long long*)offsets, n_out, seg,
      chunks);
  return (int)cudaGetLastError();
}
