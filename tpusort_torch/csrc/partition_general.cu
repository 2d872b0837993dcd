// K1c: one fused MSD partition pass, general branch: each tile partitioned
// stably by its digit, every operand word riding in input order.
//
// Replaces the general branch of the Pallas kernel _fused_kernel behind
// tpusort/kernels/partition.py:partition_pass_fused.  The TPU kernel sorts
// the packed key (digit, or R if the slot is invalid) << log2(K) | slot with
// a bitonic network, every plane and value riding it, because the TPU has no
// scatter and no atomics.  A stable partition by digit needs no sort: here it
// is a block-wide radix rank.  One CTA owns one K-slot tile:
//
//   1. each slot is valid iff its global index < n (pass 0) or slot % q_in <
//      counts_in[t, slot / q_in] (later passes).  Its digit is bits
//      [lo_bit, lo_bit + width) of the key across the planes (plane 0 the
//      most significant 32 bits; the bits may straddle two planes), or the
//      caller's digit plane.  An invalid slot, or a digit not below R, gets
//      digit R and is dropped.  The digits go to shared memory (2 bytes a
//      slot) and into a shared histogram of R + 1 bins (one atomic per digit
//      per warp step, by __match_any_sync); counts_out[t, d] = hist[d] for
//      d < R, which may exceed S;
//   2. a second walk over the tile in input order, blockDim slots at a time:
//      each warp ranks its lanes among equal digits (__match_any_sync and a
//      popc of the lower lanes' mask); the per-warp digit counts go to shared
//      memory and are scanned across the warps in warp order, from a running
//      base per digit that carries from chunk to chunk.  A slot's rank j then
//      counts the slots of its digit before it in input order: the partition
//      is stable by construction;
//   3. where j < S, every operand word of the slot goes to
//      out[((seg * R + d) * t_seg + tile_in_seg) * S + j], the digit-major
//      layout of the next pass (the fused exchange).  Slots past a run's
//      count are left unwritten.
//
// Bound: the stores.  Each operand word is read once and written at most
// once (the planes that hold the digit are read twice, the second time mostly
// from L2), with no sort network, but the writes of one warp step land in
// runs of consecutive words, one run per digit present, so they coalesce only
// as far as the digits repeat within the warp.  Shared memory holds 2 bytes a
// slot (32 KB at K = 16384) and 18.5 KB of counts, whatever the number of
// operands.
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_sort.cuh"

namespace tpusort {

constexpr int kGenThreads = 512;
constexpr int kGenWarps = kGenThreads / 32;
constexpr int kGenMaxRadix = 256;

// Bits [lo, lo + width) of word i of the n_planes-plane key, width <= 8.
__device__ inline uint32_t key_digit(const Operands& ops, int n_planes,
                                     size_t i, int lo, int width) {
  uint32_t d = 0;
  for (int p = 0; p < n_planes; ++p) {
    const int base = 32 * (n_planes - 1 - p);
    const int ov_lo = max(lo, base);
    const int ov_hi = min(lo + width, base + 32);
    if (ov_hi > ov_lo) {
      const uint32_t m = (1u << (ov_hi - ov_lo)) - 1u;
      d |= ((ops.in[p][i] >> (ov_lo - base)) & m) << (ov_lo - lo);
    }
  }
  return d;
}

__global__ void __launch_bounds__(kGenThreads)
partition_general_kernel(Operands ops, int n_planes,
                         const int32_t* __restrict__ digit_in,
                         const int32_t* __restrict__ counts_in, int q_in,
                         long long n, int K, int R, int S, int lo_bit,
                         int width, int t_seg,
                         int32_t* __restrict__ counts_out) {
  extern __shared__ uint16_t dig[];
  __shared__ int hist[kGenMaxRadix + 1];
  __shared__ int base[kGenMaxRadix + 1];
  __shared__ int wcount[kGenWarps * (kGenMaxRadix + 1)];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bins = R + 1;
  for (int d = tid; d < bins; d += blockDim.x) {
    hist[d] = 0;
    base[d] = 0;
  }
  __syncthreads();

  // K is a multiple of 128 and each chunk below starts at a multiple of
  // blockDim, so a warp's 32 lanes are all inside the tile or all outside
  // it: the warp intrinsics always see full warps.
  const size_t first = (size_t)t * K;
  const int32_t* cin = counts_in ? counts_in + (size_t)t * (K / q_in) : nullptr;
  for (int i = tid; i < K; i += blockDim.x) {
    const bool v = cin ? (i % q_in) < cin[i / q_in] : (long long)(first + i) < n;
    uint32_t d = R;
    if (v) {
      d = digit_in ? (uint32_t)digit_in[first + i]
                   : key_digit(ops, n_planes, first + i, lo_bit, width);
      if (d > (uint32_t)R) d = R;
    }
    dig[i] = (uint16_t)d;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  for (int d = tid; d < R; d += blockDim.x) {
    counts_out[(size_t)t * R + d] = hist[d];
  }

  const int seg = t / t_seg;
  const int j = t - seg * t_seg;
  const unsigned lower = (1u << lane) - 1u;
  for (int c0 = 0; c0 < K; c0 += blockDim.x) {
    for (int e = tid; e < kGenWarps * bins; e += blockDim.x) wcount[e] = 0;
    __syncthreads();
    const int i = c0 + tid;
    const bool inside = i < K;
    int d = R;
    unsigned peers = 0;
    if (inside) {
      d = dig[i];
      peers = __match_any_sync(0xFFFFFFFFu, d);
      if (lane == __ffs(peers) - 1) wcount[warp * bins + d] = __popc(peers);
    }
    __syncthreads();
    // exclusive scan of each digit's per-warp counts in warp order, starting
    // from the digit's running base; the base moves on by the chunk's total
    for (int dd = tid; dd < R; dd += blockDim.x) {
      int run = base[dd];
      for (int w = 0; w < kGenWarps; ++w) {
        const int c = wcount[w * bins + dd];
        wcount[w * bins + dd] = run;
        run += c;
      }
      base[dd] = run;
    }
    __syncthreads();
    if (inside && d < R) {
      const int rank = wcount[warp * bins + d] + __popc(peers & lower);
      if (rank < S) {
        const size_t o = (((size_t)seg * R + d) * t_seg + j) * S + rank;
        const size_t src = first + i;
        for (int k = 0; k < ops.count; ++k) ops.out[k][o] = ops.in[k][src];
      }
    }
    __syncthreads();  // wcount is cleared for the next chunk
  }
}

}  // namespace tpusort

// ops_in/ops_out: n_ops (1-16) device pointers each, the n_planes key planes
// first; digit: a (T, K) int32 digit plane or null.  Returns a cudaError_t.
extern "C" int tpusort_partition_general(
    const void* const* ops_in, void* const* ops_out, int n_ops, int n_planes,
    const void* digit, const void* counts_in, int q_in, long long n, int T,
    int K, int R, int S, int lo_bit, int width, int t_seg, void* counts_out,
    void* stream) {
  using namespace tpusort;
  Operands ops;
  if (!make_operand_list(ops_in, ops_out, n_ops, &ops) || n_planes < 1 ||
      n_planes > n_ops || R < 1 || R > kGenMaxRadix || K % 128 || t_seg < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)K * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      partition_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  partition_general_kernel<<<T, kGenThreads, smem, (cudaStream_t)stream>>>(
      ops, n_planes, (const int32_t*)digit, (const int32_t*)counts_in, q_in, n,
      K, R, S, lo_bit, width, t_seg, (int32_t*)counts_out);
  return (int)cudaGetLastError();
}
