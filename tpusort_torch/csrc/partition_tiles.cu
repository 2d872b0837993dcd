// K8: order each tile stably by the caller's sortkey, then emit its data
// operands as R runs of S slots from the caller's run starts.
//
// Replaces the Pallas kernel _partition_kernel behind
// tpusort/kernels/partition.py:partition_tiles, which the per-phase profiler
// of the MSD engine runs once a partition pass (tpusort/ops/msd.py
// _partition_pass with use_pallas).  The caller computes the digit
// histogram, the run starts and a sortkey (digit, or R where invalid) <<
// log2(K) | slot.  The TPU kernel sorts the tile by it with a bitonic
// network.  A sortkey whose low bits are the slot needs no sort: the order
// is the stable order of its high bits, a radix rank.
//
// Contract: ops = [sortkey, data...], each (T, K) 32-bit words; starts
// (T, R) int32.  The tile's order is the stable sort by the sortkey as
// unsigned (ties in slot order), and for each data operand
// out[t, d * S + j] = sorted[t, clamp(starts[t, d] + j, 0, K - 1)], every
// one of the R * S slots written.  The sortkey is not emitted.  The clamp
// keeps the slots past a run's count inside the tile (the Pallas kernel
// leaves them garbage and never reads past the tile either).
//
// One CTA of 512 threads a tile (K a power of two, 128 .. 32768):
//   1. the sortkey read with 16-byte loads; its AND and its OR over the
//      tile, whose XOR is the bits that vary, and one block-wide vote:
//      does every slot's low log2(K) bits equal its slot?  Then the tile is
//      already in the order of those bits, a stable pass over them would be
//      the identity, and the passes start at bit log2(K); otherwise at bit
//      0.  Bits that do not vary need no pass.  The engine's sortkey at
//      R = 32 leaves one pass of 6 bits;
//   2. LSD passes of at most 8 bits over the varying bits, low to high.
//      Each is a stable rank of the digit (key >> lo) & mask over the
//      tile in its current order: block_rank.cuh's walk (contiguous warp
//      spans, a batch of loads before the ranks, ballots on the digit's
//      bits) and digit-major scan, which K1c (partition_general.cu) runs
//      too; then each position's new place is the digit's base plus its
//      warp's offset plus its warp-local rank.  The current order is a
//      permutation of slot indices in shared memory (none before the first
//      pass); a digit is read from the sortkey in device memory at its
//      slot (mostly from L2).  The last pass writes each slot's final
//      position;
//   3. for each data operand, the tile staged in shared memory at its
//      sorted positions (block_rank.cuh:stage_row, 16-byte loads), then
//      the R * S output words stored in pieces of 128, lane l the 16
//      bytes at 4 l of its piece: S is a multiple of 128, so a piece lies
//      in one run and every store is 16-byte aligned.  Lane l reads its 4
//      words from the staging buffer in an order rotated by l / 8, so the
//      warp's reads of a step fall in 32 different banks.
//
// Bound: the bytes.  The sortkey and each data word are read once and R x S
// words a data operand written once (the sortkey is re-read by each pass,
// mostly from L2).  A pass costs one ballot a digit bit a step and a
// constant number of barriers; the first version sorted the tile with a
// shared-memory network instead, 105 steps at K = 16384, each a pass over
// the tile with a __syncthreads(), and gathered each output word with a
// 4-byte load from device memory.
//
// Shared memory (dynamic, sized by K): the staging buffer, K words, which
// holds two uint16 permutation or rank arrays during the passes; each
// slot's final position, 2 bytes a slot; the per-warp digit counts, 16 x
// 256 uint16; the digit totals (then bases), the run starts and the
// reductions.  That is 105.5 KB at K = 16384, so two CTAs share an SM
// (with __launch_bounds__(512, 2): 64 registers a thread); 201.5 KB at
// K = 32768.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "block_rank.cuh"
#include "operands.cuh"

namespace tpusort {

constexpr int kMaxRuns = 128;       // R: the Pallas kernel's one lane row
constexpr int kTileRadix = 256;     // digits of one pass (8 bits)
constexpr int kTilePiece = 128;     // words a warp stores at once: 16 B a lane

// The kernel's dynamic shared memory, carved the same way on both sides.
struct TileSmem {
  uint32_t* stage;   // K words; during the passes the arrays x0 and x1
  uint16_t* x0;      // K
  uint16_t* x1;      // K
  uint16_t* dest;    // K: each slot's final position
  uint16_t* wcount;  // kRankWarps x kTileRadix
  int* hist;         // kTileRadix: digit totals, then digit bases
  int* start;        // kMaxRuns
  unsigned* red;     // 2: the AND and the OR of the sortkey

  __host__ __device__ static size_t bytes(int K) {
    return 4 * (size_t)K + 2 * (size_t)K + 2 * (size_t)kRankWarps * kTileRadix +
           4 * (size_t)(kTileRadix + kMaxRuns + 4);
  }
  __device__ TileSmem(uint32_t* base, int K) {
    stage = base;
    x0 = reinterpret_cast<uint16_t*>(base);
    x1 = x0 + K;
    dest = x1 + K;
    wcount = dest + K;
    hist = reinterpret_cast<int*>(wcount + kRankWarps * kTileRadix);
    start = hist + kTileRadix;
    red = reinterpret_cast<unsigned*>(start + kMaxRuns);
  }
};

// The walk's source for one pass: the digit of the slot at position i of
// the current order (perm[i], or i before the first pass).
struct KeyDigits {
  using Raw = uint32_t;
  const uint32_t* key;     // the tile's sortkey row
  const uint16_t* perm;    // position -> slot, or null
  int lo;
  uint32_t mask;

  __device__ Raw load(int i) const { return key[perm ? perm[i] : i]; }
  __device__ uint32_t digit(Raw k, int) const { return (k >> lo) & mask; }
};

__global__ void __launch_bounds__(kRankThreads, 2)
partition_tiles_kernel(const uint32_t* __restrict__ sortkey, Values vals,
                       const int32_t* __restrict__ starts, int K, int R,
                       int S) {
  extern __shared__ uint32_t smem[];
  const TileSmem sm(smem, K);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t first = (size_t)blockIdx.x * K;
  const uint32_t* key = sortkey + first;
  if (tid == 0) {
    sm.red[0] = ~0u;
    sm.red[1] = 0u;
  }
  for (int d = tid; d < R; d += blockDim.x) {
    sm.start[d] = starts[(size_t)blockIdx.x * R + d];
  }
  __syncthreads();

  // 1. the bits that vary, and the vote: low log2(K) bits == slot
  const uint32_t low = (uint32_t)K - 1u;
  uint32_t all = ~0u, any = 0u;
  bool in_order = true;
  if ((reinterpret_cast<uintptr_t>(key) & 15) == 0) {
    for (int g0 = 4 * tid; g0 < K; g0 += 4 * kStageLoads * kRankThreads) {
      uint4 w[kStageLoads];
#pragma unroll
      for (int b = 0; b < kStageLoads; ++b) {
        const int g = g0 + 4 * kRankThreads * b;
        if (g < K) w[b] = *reinterpret_cast<const uint4*>(key + g);
      }
#pragma unroll
      for (int b = 0; b < kStageLoads; ++b) {
        const int g = g0 + 4 * kRankThreads * b;
        if (g < K) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t x = word(w[b], kk);
            all &= x;
            any |= x;
            in_order &= (x & low) == (uint32_t)(g + kk);
          }
        }
      }
    }
  } else {
    for (int i = tid; i < K; i += blockDim.x) {
      const uint32_t x = key[i];
      all &= x;
      any |= x;
      in_order &= (x & low) == (uint32_t)i;
    }
  }
  all = __reduce_and_sync(0xFFFFFFFFu, all);
  any = __reduce_or_sync(0xFFFFFFFFu, any);
  if (lane == 0) {
    atomicAnd(&sm.red[0], all);
    atomicOr(&sm.red[1], any);
  }
  in_order = __syncthreads_and(in_order);   // also orders the two atomics
  uint32_t varying = sm.red[0] ^ sm.red[1];
  if (in_order) varying &= ~low;

  // 2. LSD passes over the varying bits, 8 at most a pass
  const int span = K / rank_walkers(K);
  int lo = varying ? __ffs(varying) - 1 : 32;
  const int hi = 32 - __clz(varying);
  const int passes = (hi - lo + 7) / 8;
  if (passes <= 0) {
    for (int i = tid; i < K; i += blockDim.x) sm.dest[i] = (uint16_t)i;
  }
  const uint16_t* perm = nullptr;      // position -> slot; null: identity
  for (int p = 0; p < passes; ++p) {
    const int width = min(8, hi - lo);
    const int bins = 1 << width;
    const uint32_t mask = (uint32_t)bins - 1u;
    const bool last = p == passes - 1;
    // the last pass writes dest by slot; the others a permutation by
    // position, into x0 or x1 so that pass p + 1 reads it from there
    uint16_t* out = last ? sm.dest : (((passes - 1 - p) & 1) ? sm.x0 : sm.x1);
    uint16_t* rank = (sm.dest != out && sm.dest != perm) ? sm.dest
                     : (sm.x1 != out && sm.x1 != perm) ? sm.x1 : sm.x0;
    for (int e = tid; e < kRankWarps * bins; e += blockDim.x) {
      sm.wcount[e] = 0;
    }
    __syncthreads();
    const KeyDigits src{key, perm, lo, mask};
    rank_walk(sm.wcount, bins, K, width, src,
              [&](int i, uint32_t, int r) { rank[i] = (uint16_t)r; });
    __syncthreads();
    scan_warp_counts(sm.wcount, bins, sm.hist);
    __syncthreads();
    if (warp == 0) {                   // the digits' bases, in place
      int base = 0;
      for (int d0 = 0; d0 < bins; d0 += 32) {
        const int d = d0 + lane;
        const int h = d < bins ? sm.hist[d] : 0;
        int x = h;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
          if (lane >= o) x += y;
        }
        if (d < bins) sm.hist[d] = base + x - h;
        base += __shfl_sync(0xFFFFFFFFu, x, 31);
      }
    }
    __syncthreads();
    for (int i = tid; i < K; i += blockDim.x) {
      const int s = perm ? perm[i] : i;
      const uint32_t d = (key[s] >> lo) & mask;
      const int pos = sm.hist[d] + sm.wcount[(i / span) * bins + d] + rank[i];
      if (last) {
        out[s] = (uint16_t)pos;
      } else {
        out[pos] = (uint16_t)s;
      }
    }
    __syncthreads();
    perm = out;
    lo += width;
  }

  // 3. each data operand: staged at its sorted positions, then stored run
  // by run from the clamped positions
  const int pieces = R * (S / kTilePiece);
  const int rot = lane >> 3;
  for (int v = 0; v < vals.count; ++v) {
    __syncthreads();   // dest written; the last operand's stores done
    stage_row(vals.in[v] + first, K, sm.dest, sm.stage);
    __syncthreads();
    uint32_t* out = vals.out[v] + (size_t)blockIdx.x * R * S;
    for (int pc = warp; pc < pieces; pc += kRankWarps) {
      const int o = pc * kTilePiece + 4 * lane;
      const int d = o / S;
      const int at = sm.start[d] + (o - d * S);
      uint32_t t[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {     // t[kk] is word (kk + rot) & 3
        const int a = at + ((kk + rot) & 3);
        t[kk] = sm.stage[a < 0 ? 0 : (a < K ? a : K - 1)];
      }
      if (rot & 1) {                       // t[m] = word m: rotate by rot
        const uint32_t x = t[3];
        t[3] = t[2];
        t[2] = t[1];
        t[1] = t[0];
        t[0] = x;
      }
      if (rot & 2) {
        uint32_t x = t[0];
        t[0] = t[2];
        t[2] = x;
        x = t[1];
        t[1] = t[3];
        t[3] = x;
      }
      *reinterpret_cast<uint4*>(out + o) = make_uint4(t[0], t[1], t[2], t[3]);
    }
  }
}

}  // namespace tpusort

// sortkey: (T, K) row-major; vals_in: n_vals (1-8) device pointers, (T, K)
// each; vals_out: n_vals 16-byte aligned device pointers, (T, R * S) each;
// starts: (T, R) int32.  K a power of two in [128, 32768], R in [1, 128],
// S a positive multiple of 128.  Returns a cudaError_t.
extern "C" int tpusort_partition_tiles(const void* sortkey,
                                       const void* const* vals_in,
                                       void* const* vals_out, int n_vals,
                                       const void* starts, int T, int K,
                                       int R, int S, void* stream) {
  using namespace tpusort;
  if (n_vals < 1 || n_vals > kMaxValues || R < 1 || R > kMaxRuns || S < 1 ||
      S % kTilePiece || (long long)R * S > (1LL << 30) || K < 128 ||
      K > 32768 || (K & (K - 1)) || T < 0 || !aligned16(vals_out, n_vals)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
  Values vals{};
  vals.count = n_vals;
  for (int v = 0; v < n_vals; ++v) {
    vals.in[v] = static_cast<const uint32_t*>(vals_in[v]);
    vals.out[v] = static_cast<uint32_t*>(vals_out[v]);
  }
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = allow_smem_once((const void*)partition_tiles_kernel,
                                    kMaxSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  partition_tiles_kernel<<<T, kRankThreads, TileSmem::bytes(K),
                           (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(sortkey), vals,
      static_cast<const int32_t*>(starts), K, R, S);
  return (int)cudaGetLastError();
}
