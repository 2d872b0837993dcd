// K1c: one fused MSD partition pass, general branch: each tile partitioned
// stably by its digit, every operand word riding in input order.
//
// Replaces the general branch of the Pallas kernel _fused_kernel behind
// tpusort/kernels/partition.py:partition_pass_fused.  The TPU kernel sorts
// the packed key (digit, or R if the slot is invalid) << log2(K) | slot with
// a bitonic network, every plane and value riding it, because the TPU has no
// scatter and no atomics.  A stable partition by digit needs no sort: here it
// is a blocked radix rank, then staged stores.  One CTA of 512 threads owns
// one K-slot tile (K a power of two, 128 .. 32768):
//
//   1. the rank (block_rank.cuh:rank_walk, which K8 shares).  Each
//      walking warp (min(16, K / 32) of them) owns a contiguous span of
//      K / warps slots; lane l's step r takes slot span_start + 32 r + l,
//      so the loads coalesce and (r, lane) is slot order.  A slot is valid
//      iff its global index < n (pass 0) or slot % q_in < counts_in[t,
//      slot / q_in] (later passes); its digit is bits [lo_bit, lo_bit +
//      width) of the key across the planes (plane 0 the most significant
//      32 bits; the bits may straddle two planes) or the caller's digit
//      plane; an invalid slot, or a digit not below R, gets digit R and is
//      dropped.  Ballots on the digit's bits group the lanes of a step by
//      digit: a lane's warp-local rank is its group leader's count of the
//      digit so far plus the group's lanes below it, and the leader adds
//      the group's size.  No atomics, so the ranks are deterministic and
//      the partition stable.  The digit and the warp-local rank of each
//      slot go to shared memory;
//   2. the scan (block_rank.cuh:scan_warp_counts).  For each digit, an
//      exclusive scan of its per-warp counts in warp order (digit-major:
//      thread d walks the 16 warps) gives each warp's first rank within
//      the digit, and the digit's total hist[d]: counts_out[t, d] =
//      hist[d], which may exceed S.  Warp 0 then scans the run lengths
//      m_d = min(hist[d], S) over the digits into the staging offsets
//      (each rounded up to 4 words, so every staged run is 16-byte
//      aligned) and the runs' pieces of 128 words;
//   3. a slot's destination: where d < R and its rank j within the digit
//      is below S, the staging word local[d] + j, else none;
//   4. for each operand word: the tile re-read from device memory (16-byte
//      loads where the row is aligned; the planes that hold the digit come
//      mostly from L2), scattered into the staging buffer by destination
//      (block_rank.cuh:stage_row); then each warp stores whole pieces,
//      lane l the 16 bytes at 4 l of the piece, to
//      out[((seg * R + d) * t_seg + tile_in_seg) * S + j]
//      (the digit-major layout of the next pass, the fused exchange), so
//      consecutive lanes store consecutive words and a run's tail past
//      m_d is left unwritten.
//
// Bound: the bytes.  Each operand word is read once and written at most
// once (the digit planes twice, the second time mostly from L2), and the
// stores are whole 16-byte runs.  The walk issues a batch of 8 steps'
// loads before it ranks any of them (a load used at once costs a trip to
// device memory a step), one ballot a bit of the digit (6 at R = 32) a
// step, and a constant number of barriers a tile.  The first version took
// three barriers and a serial scan of 16 warp counts per digit for every
// 512 slots, and stored each word with a 4-byte store at its own rank,
// which coalesced only as far as the digits repeated within a warp.
//
// Shared memory (dynamic, sized by K and R): the staging buffer, K + 4 R
// words, which holds the warp-local ranks during the walk; each slot's
// digit, then its destination, 2 bytes a slot (one buffer for both: the
// destination replaces the digit slot by slot); the per-warp digit counts,
// then the scanned offsets, 16 x (R + 1) uint16; hist, the staging offsets
// and the piece offsets, R + 1 ints each.  That is 100 KB at K = 16384
// and R = 32 (113.7 KB at R = 256), so two CTAs share an SM (with
// __launch_bounds__(512, 2): 64 registers a thread), which is what the
// 2-byte destination reusing the digit's buffer buys; 212 KB at K = 32768.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "block_rank.cuh"
#include "operands.cuh"

namespace tpusort {

constexpr int kGenMaxRadix = 256;
constexpr int kGenPiece = 128;     // words a warp stores at once: 16 B a lane

// The kernel's dynamic shared memory, carved the same way on both sides.
struct GenSmem {
  uint32_t* stage;   // K + 4R words
  int* hist;         // R + 1
  int* local;        // R + 1: staging offset of each digit's run
  int* piece;        // R + 1: first piece of each digit's run
  uint16_t* wcount;  // kRankWarps x (R + 1)
  uint16_t* slot;    // K: digit, then destination

  __host__ __device__ static size_t ints(int R) {
    return ((size_t)3 * (R + 1) + 3) & ~(size_t)3;  // keeps 16-byte alignment
  }
  __host__ __device__ static size_t bytes(int K, int R) {
    return 4 * ((size_t)K + 4 * R) + 4 * ints(R) +
           2 * (size_t)kRankWarps * (R + 1) + 2 * (size_t)K;
  }
  __device__ GenSmem(uint32_t* base, int K, int R) {
    stage = base;
    hist = reinterpret_cast<int*>(base + K + 4 * R);
    local = hist + (R + 1);
    piece = local + (R + 1);
    wcount = reinterpret_cast<uint16_t*>(hist + ints(R));
    slot = wcount + kRankWarps * (R + 1);
  }
};

// Where the digit's bits [lo, lo + width) (width <= 8) lie in the
// n_planes-plane key, plane 0 the most significant 32 bits: the low part in
// one plane from bit `shift`, and where the bits straddle two planes, the
// rest from bit 0 of the plane above it (`hi`, else null).
struct DigitBits {
  const uint32_t* lo;
  const uint32_t* hi;
  int shift, lo_bits;
  uint32_t lo_mask, hi_mask;

  __device__ DigitBits(const Operands& ops, int n_planes, int bit, int width)
      : shift(bit % 32), lo_bits(min(width, 32 - bit % 32)) {
    const int p = n_planes - 1 - bit / 32;
    lo = ops.in[p];
    hi = width > lo_bits ? ops.in[p - 1] : nullptr;
    lo_mask = (1u << lo_bits) - 1u;
    hi_mask = (1u << (width - lo_bits)) - 1u;
  }
  __device__ uint32_t operator()(uint32_t w_lo, uint32_t w_hi) const {
    return ((w_lo >> shift) & lo_mask) | ((w_hi & hi_mask) << lo_bits);
  }
};

// The walk's source: slot i's digit from the key planes (or the caller's
// digit plane), R where the slot is invalid or its digit is not below R.
struct GenDigits {
  struct Raw {
    uint32_t w0, w1;
    int c;
  };
  DigitBits bits;
  const uint32_t* src0;    // the digit's low plane, or the digit plane
  const uint32_t* src1;    // the plane above where the digit straddles two
  const int32_t* cin;      // the tile's counts_in row, or null (pass 0)
  bool plane;              // src0 is the caller's digit plane
  size_t first;
  long long n;
  int q_in, q_shift, R;

  __device__ Raw load(int i) const {
    const size_t g = first + i;
    Raw r{src0[g], 0u, 0};
    if (src1) r.w1 = src1[g];
    if (cin) r.c = cin[i >> q_shift];
    return r;
  }
  __device__ uint32_t digit(const Raw& r, int i) const {
    const bool v = cin ? (i & (q_in - 1)) < r.c : (long long)(first + i) < n;
    const uint32_t x = plane ? r.w0 : bits(r.w0, r.w1);
    return v && x < (uint32_t)R ? x : R;
  }
};

__global__ void __launch_bounds__(kRankThreads, 2)
partition_general_kernel(Operands ops, int n_planes,
                         const int32_t* __restrict__ digit_in,
                         const int32_t* __restrict__ counts_in, int q_in,
                         long long n, int K, int R, int S, int lo_bit,
                         int width, int t_seg,
                         int32_t* __restrict__ counts_out) {
  extern __shared__ uint32_t smem[];
  const GenSmem sm(smem, K, R);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bins = R + 1;
  for (int e = tid; e < kRankWarps * bins; e += blockDim.x) sm.wcount[e] = 0;
  __syncthreads();

  // 1. the rank, warp by warp over contiguous spans, in slot order
  const size_t first = (size_t)t * K;
  const int32_t* cin = counts_in ? counts_in + (size_t)t * (K / q_in) : nullptr;
  const int span = K / rank_walkers(K);      // a multiple of 32
  const DigitBits digits(ops, n_planes, lo_bit, width);
  const GenDigits src{digits, digit_in ? reinterpret_cast<const uint32_t*>(
                                             digit_in) : digits.lo,
                      digit_in ? nullptr : digits.hi, cin, digit_in != nullptr,
                      first, n, q_in, cin ? __ffs(q_in) - 1 : 0, R};
  // digits 0 .. R take 32 - __clz(R) bits
  rank_walk(sm.wcount, bins, K, 32 - __clz(R), src,
            [&](int i, uint32_t d, int rank) {
              sm.slot[i] = (uint16_t)d;
              sm.stage[i] = rank;
            });
  __syncthreads();

  // 2. the scan: per digit over the warps, then over the digits
  scan_warp_counts(sm.wcount, bins, sm.hist);
  __syncthreads();
  if (warp == 0) {
    int base_l = 0, base_p = 0;
    for (int d0 = 0; d0 < R; d0 += 32) {
      const int d = d0 + lane;
      const int m = d < R ? min(sm.hist[d], S) : 0;
      if (d < R) counts_out[(size_t)t * R + d] = sm.hist[d];
      const int a = (m + 3) & ~3;
      const int b = (m + kGenPiece - 1) / kGenPiece;
      int sa = a, sb = b;                  // inclusive scans over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int xa = __shfl_up_sync(0xFFFFFFFFu, sa, o);
        const int xb = __shfl_up_sync(0xFFFFFFFFu, sb, o);
        if (lane >= o) {
          sa += xa;
          sb += xb;
        }
      }
      if (d < R) {
        sm.local[d] = base_l + sa - a;
        sm.piece[d] = base_p + sb - b;
      }
      base_l += __shfl_sync(0xFFFFFFFFu, sa, 31);
      base_p += __shfl_sync(0xFFFFFFFFu, sb, 31);
    }
    if (lane == 0) {
      sm.local[R] = base_l;
      sm.piece[R] = base_p;
    }
  }
  __syncthreads();

  // 3. each slot's staging word, or none
  for (int i = tid; i < K; i += blockDim.x) {
    const int d = sm.slot[i];
    uint16_t dst = kNoSlot;
    if (d < R) {
      const int j = sm.wcount[(i / span) * bins + d] + (int)sm.stage[i];
      if (j < S) dst = (uint16_t)(sm.local[d] + j);
    }
    sm.slot[i] = dst;
  }

  // 4. each operand word: staged by destination, then stored run by run
  const int seg = t / t_seg;
  const int tj = t - seg * t_seg;
  const int pieces = sm.piece[R];
  for (int k = 0; k < ops.count; ++k) {
    __syncthreads();   // destinations written; the last operand's stores done
    stage_row(ops.in[k] + first, K, sm.slot, sm.stage);
    __syncthreads();
    uint32_t* out = ops.out[k];
    int d = 0;                   // a warp's pieces ascend, so its digit does
    for (int pc = warp; pc < pieces; pc += kRankWarps) {
      while (sm.piece[d + 1] <= pc) ++d;
      const int m = min(sm.hist[d], S);
      const int j = (pc - sm.piece[d]) * kGenPiece + 4 * lane;
      uint32_t* dst = out + (((size_t)seg * R + d) * t_seg + tj) * S;
      const uint32_t* src = sm.stage + sm.local[d];
      if (j + 4 <= m) {
        *reinterpret_cast<uint4*>(dst + j) =
            *reinterpret_cast<const uint4*>(src + j);
      } else {
        for (int kk = 0; kk < 4 && j + kk < m; ++kk) dst[j + kk] = src[j + kk];
      }
    }
  }
}

}  // namespace tpusort

// ops_in/ops_out: n_ops (1-16) device pointers each, the n_planes key planes
// first, the inputs (T, K) row-major and the outputs (T * R * S,) and
// 16-byte aligned; digit: a (T, K) int32 digit plane or null; K a power of
// two from 128 to 32768, S a multiple of 4, R at most 256.  Returns a
// cudaError_t.
extern "C" int tpusort_partition_general(
    const void* const* ops_in, void* const* ops_out, int n_ops, int n_planes,
    const void* digit, const void* counts_in, int q_in, long long n, int T,
    int K, int R, int S, int lo_bit, int width, int t_seg, void* counts_out,
    void* stream) {
  using namespace tpusort;
  Operands ops;
  if (!make_operand_list(ops_in, ops_out, n_ops, &ops) || n_planes < 1 ||
      n_planes > n_ops || R < 1 || R > kGenMaxRadix || K < 128 ||
      K > 32768 || (K & (K - 1)) || S <= 0 || S % 4 || t_seg < 1 ||
      T % t_seg || (counts_in && (q_in <= 0 || (q_in & (q_in - 1)) ||
                                  K % q_in)) ||
      !aligned16(ops_out, n_ops)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = allow_smem_once((const void*)partition_general_kernel,
                                    kMaxSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  partition_general_kernel<<<T, kRankThreads, GenSmem::bytes(K, R),
                             (cudaStream_t)stream>>>(
      ops, n_planes, (const int32_t*)digit, (const int32_t*)counts_in, q_in, n,
      K, R, S, lo_bit, width, t_seg, (int32_t*)counts_out);
  return (int)cudaGetLastError();
}
