// K1 and K1b: one fused MSD partition pass, raw-key mode: 1-3 key planes,
// payloads riding with their keys; K1b cuts the runs at splitters instead
// of digits.
//
// Replaces the raw-key branch of the Pallas kernel _fused_kernel behind
// tpusort/kernels/partition.py:partition_pass_fused, with and without its
// splitter mode.  One CTA owns one K-element tile (K = 16384 on the main
// path), laid out as the row tile sorts lay a row out
// (kernels/bitonic.py:tile_sort_geometry: threads x E slots a thread x
// chunks = K; 512 x 32 for one plane at 16,384):
//
//   1. load the tile's key planes (reg_sort.cuh:load_row, 16-byte loads)
//      into shared memory; a slot is valid iff its global index < n
//      (pass 0) or slot % q_in < counts_in[t, slot / q_in] (later passes);
//      invalid slots become 0xFFFFFFFF in every plane, which sorts last and
//      ties only equal keys, so the keys-only multiset stays exact (with
//      payloads the engine checks that no valid key is all-ones);
//   2. sort the tile ascending, lexicographically over the planes
//      (reg_sort.cuh:reg_block_sort: the steps inside a thread's E slots in
//      registers, inside a warp's 32 E on shuffles, only the longer ones in
//      shared memory; merge levels above sorted_run only, none in the
//      emit-only mode, sorted_run = K); with payloads a 16-bit slot index
//      is packed under the last plane, so equal keys keep their slot order:
//      the tile's order is the stable one (the contract allows any order
//      of ties; the plain version is stable too, so payloads equal it even
//      on tied keys);
//   3. K1: histogram the digit bits [lo_bit, lo_bit + width) of the sorted
//      tile, counted across the planes (plane 0 the most significant 32
//      bits), with warp-aggregated shared atomics (sorted input gives ~one
//      atomic per warp step); start[d] = #(digit < d), count[d] = start[d+1]
//      - start[d] and, for the top digit, n_valid - start[R-1].
//      K1b (splitter_cuts): run d holds the keys between splitters d and
//      d+1, so the sorted tile's runs are contiguous and only the R-1 cut
//      points are chosen, as the Pallas kernel chooses them (bit for bit:
//      the engine compares counts exactly);
//   4. write run d of tile t = seg * t_seg + j to
//      out[((seg * R + d) * t_seg + j) * S + [0, min(count, S))], the
//      digit-major layout of the next pass (the fused exchange): every key
//      plane from the sorted tile, then each payload word, its tile staged
//      in shared memory over plane 0 (reg_sort.cuh:stage_row) and gathered
//      from there by the slot index; write the unclamped counts to
//      counts_out[t, :].  Slots past a run's count are left unwritten.
//
// Everything that reads the sorted tile (the histogram, K1b's binary
// searches, the emission) reads slot s at its swizzled word swz(s).
//
// Bound: a pass reads the operands once and writes 1.5x (S = 1.5 K / R) or
// 1x of them, so at HBM speed it is memory-bound; the sort network (105
// steps for a full 16384 sort, 69 for a merge from 256-runs, 10 and 1 of
// them in shared memory) and the scattered emission are what it runs into
// first.  K1b's cut points add two binary searches per boundary and one
// thread's O(R) walk, next to nothing.  Shared memory: 64 KB a key plane
// plus 32 KB of slot index at K = 16384, so 3 planes with payloads (224 KB)
// is the largest mode; K1b reads its splitters from global memory and
// keeps its cut points in the histogram's arrays, so it needs no more.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "reg_sort.cuh"
#include "tile_sort.cuh"

namespace tpusort {

constexpr int kMaxRadix = 256;
// the kernel's static shared memory (hist, start, n_valid) as ptxas lays
// it out
constexpr int kStaticSmem = 2064;

// Bits [lo, lo + width) of the sorted slot s's NK-plane key, width <= 8.
template <int NK, bool IDX>
__device__ inline int digit_of(const RegTile<NK, IDX>& t, int s, int lo,
                               int width) {
  const int w = swz(s);
  uint32_t d = 0;
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    const int base = 32 * (NK - 1 - p);
    const int ov_lo = max(lo, base);
    const int ov_hi = min(lo + width, base + 32);
    if (ov_hi > ov_lo) {
      const uint32_t m = (1u << (ov_hi - ov_lo)) - 1u;
      d |= ((t.key[p][w] >> (ov_lo - base)) & m) << (ov_lo - lo);
    }
  }
  return (int)d;
}

// K1b's splitters: one (T, R-1) word array per key plane, plus the (T, R-1)
// tie fractions, 16-bit fixed point in [0, 65536].
struct Splitters {
  const uint32_t* word[3];
  const uint32_t* frac;
};

// #slots of the sorted tile whose key is below s (or_equal: at most s),
// lexicographically over the planes, counted over all K slots, invalid
// sentinels included (as the Pallas kernel counts them).
template <int NK, bool IDX>
__device__ inline int rank_of(const RegTile<NK, IDX>& t, int K,
                              const uint32_t* s, bool or_equal) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int w = swz(mid);
    int c = 0;
#pragma unroll
    for (int p = 0; p < NK; ++p) {
      if (c == 0) {
        const uint32_t x = t.key[p][w];
        c = (x > s[p]) - (x < s[p]);
      }
    }
    if (c < 0 || (or_equal && c == 0)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K1b: the cut points of tile t's sorted slots (port of the splitter branch
// of _fused_kernel, tpusort/kernels/partition.py:214-313).  Boundary d
// (1..R-1) may cut anywhere in its tie range [a_d, b_d] = [#keys < s_d,
// #keys <= s_d], since keys equal to s_d are equal in every tile.  It aims
// at a_d + frac * (b_d - a_d), rounded with a per-(tile, boundary) dither,
// clipped to [max(a_d, prev), prev + S] and to n_valid; a backward relief
// sweep then raises cuts within b_d so the top run fits S.  A cut forced
// outside its legal range, or a top run over S, poisons count 0 to K + 1.
// On return start[d] holds run d's first slot and count[d] its length
// (unclamped).  The binary searches take one thread per boundary; the walk
// is sequential, on thread 0.  Ends with __syncthreads().
template <int NK, bool IDX>
__device__ void splitter_cuts(const RegTile<NK, IDX>& tile,
                              const Splitters& spl, int t, int K, int R,
                              int S, int n_valid, int* count, int* start) {
  const size_t row = (size_t)t * (R - 1);
  for (int d = threadIdx.x + 1; d < R; d += blockDim.x) {
    uint32_t s[NK];
#pragma unroll
    for (int p = 0; p < NK; ++p) s[p] = spl.word[p][row + d - 1];
    count[d] = rank_of(tile, K, s, false);  // a_d, then the cut
    start[d] = rank_of(tile, K, s, true);   // b_d
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool flag = false;
    int prev = 0;
    count[0] = 0;
    for (int d = 1; d < R; ++d) {
      const int a = count[d], b = start[d];
      const int lo = max(a, prev), hi = prev + S;
      flag |= lo > hi;
      // the Pallas dither, in uint32 (its int32 products wrap alike, and
      // only bits 15-30 survive the mask); fd * span needs the full uint32
      // range (the round-5 overflow fix), with fd clamped to 0xFFFF
      const uint32_t u = (((uint32_t)t * 0x9E3779B9u +
                           (((uint32_t)d * 0x85EBCA6Bu) & 0x7FFFFFFFu)) >> 15) &
                         0xFFFFu;
      const uint32_t fd = spl.frac[row + d - 1];
      const uint32_t prod = (min(fd, 0xFFFFu) * (uint32_t)(b - a) + u) >> 16;
      const int tgt = fd >= 0x10000u ? b : a + (int)prod;
      prev = min(min(max(tgt, lo), hi), n_valid);
      count[d] = prev;
    }
    int next = n_valid;
    for (int d = R - 1; d >= 1; --d) {
      next = max(count[d], min(next - S, start[d]));
      count[d] = next;
    }
    flag |= n_valid - count[R - 1] > S;
    for (int d = 0; d < R; ++d) {
      const int end = d + 1 < R ? count[d + 1] : n_valid;
      start[d] = count[d];
      count[d] = end - count[d];
    }
    if (flag) count[0] = K + 1;
  }
  __syncthreads();
}

// Each run d of the sorted tile, slots [start[d], start[d] + min(count[d],
// S)), to its place in out (the fused exchange); word(s) gives sorted slot
// s's word.
template <class Word>
__device__ __forceinline__ void emit_runs(uint32_t* __restrict__ out,
                                          const int* count, const int* start,
                                          int R, int S, int seg, int t_seg,
                                          int j, Word word) {
  for (int e = threadIdx.x; e < R * S; e += blockDim.x) {
    const int d = e / S;
    const int i = e - d * S;
    if (i < count[d]) {
      out[((size_t)(seg * R + d) * t_seg + j) * S + i] = word(start[d] + i);
    }
  }
}

// The most threads an instance takes: the row sorts' limit, and with
// payloads at most 512 (the emission holds more state than a row sort; the
// geometry never gives a tile with payloads more threads).
__host__ __device__ constexpr int partition_threads(int nk, bool idx, int e) {
  return idx && max_threads(nk, idx, e) > kThreads / 2 ? kThreads / 2
                                                        : max_threads(nk, idx, e);
}

template <int NK, bool IDX, bool SPL, int E>
__global__ void __launch_bounds__(partition_threads(NK, IDX, E))
partition_raw_kernel(Planes planes, Values vals, Splitters spl,
                     const int32_t* __restrict__ counts_in, int q_in,
                     long long n, int K, int log_k, int R, int S, int lo_bit,
                     int width, int t_seg, int log_run, int chunks,
                     int32_t* __restrict__ counts_out) {
  extern __shared__ uint32_t smem[];
  __shared__ int hist[kMaxRadix];
  __shared__ int start[kMaxRadix];
  __shared__ int n_valid;
  const RegTile<NK, IDX> tile(smem, K);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int d = tid; d < R; d += blockDim.x) hist[d] = 0;
  if (tid == 0) n_valid = 0;
  __syncthreads();

  const size_t first = (size_t)t * K;
  int mine = 0;
  if (counts_in != nullptr) {
    const int32_t* cin = counts_in + (size_t)t * (K / q_in);
    load_row<E>(tile, planes.in, first, K, chunks, [&](int i) {
      const bool v = (i % q_in) < cin[i / q_in];
      mine += v;
      return v;
    });
  } else {
    load_row<E>(tile, planes.in, first, K, chunks, [&](int i) {
      const bool v = (long long)(first + i) < n;
      mine += v;
      return v;
    });
  }
  mine = __reduce_add_sync(0xFFFFFFFFu, mine);
  if ((tid & 31) == 0) atomicAdd(&n_valid, mine);
  __syncthreads();

  reg_block_sort<E>(tile, log_k, log_run, chunks);

  if constexpr (SPL) {
    splitter_cuts(tile, spl, t, K, R, S, n_valid, hist, start);
    for (int d = tid; d < R; d += blockDim.x) {
      counts_out[(size_t)t * R + d] = hist[d];
    }
  } else {
    for (int i = tid; i < K; i += blockDim.x) {
      const int d = digit_of(tile, i, lo_bit, width);
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      if ((tid & 31) == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int d = 0; d < R; ++d) {
        start[d] = acc;
        acc += hist[d];
      }
    }
    __syncthreads();
    for (int d = tid; d < R; d += blockDim.x) {
      const int c = d < R - 1 ? hist[d] : n_valid - start[R - 1];
      counts_out[(size_t)t * R + d] = c;
      hist[d] = c;  // each thread rewrites only its own digit
    }
    __syncthreads();
  }

  const int seg = t / t_seg;
  const int j = t - seg * t_seg;
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    const uint32_t* key = tile.key[p];
    emit_runs(planes.out[p], hist, start, R, S, seg, t_seg, j,
              [=](int s) { return key[swz(s)]; });
  }
  if constexpr (IDX) {
    uint32_t* buf = tile.key[0];
    const uint16_t* idx = tile.idx;
    for (int v = 0; v < vals.count; ++v) {
      __syncthreads();           // plane 0's reads (or the last word's)
      stage_row<E>(buf, vals.in[v] + first, K, chunks);
      __syncthreads();
      emit_runs(vals.out[v], hist, start, R, S, seg, t_seg, j,
                [=](int s) { return buf[idx[swz(s)]]; });
    }
  }
}

// The dynamic shared memory an instance is allowed, once per device: its
// tile at the largest K (a power of two up to 32768) that fits a CTA beside
// the static arrays, which is every tile the wrapper's check_fits takes.
template <int NK, bool IDX>
constexpr int partition_smem_cap() {
  int k = 32768;
  while (RegTile<NK, IDX>::bytes(k) + kStaticSmem > (size_t)kMaxSmem) k /= 2;
  return (int)RegTile<NK, IDX>::bytes(k);
}

template <int NK, bool IDX, bool SPL, int E>
int launch_partition(const Planes& planes, const Values& vals,
                     const Splitters& spl, const int32_t* counts_in, int q_in,
                     long long n, int T, int K, int R, int S, int lo_bit,
                     int width, int t_seg, int log_run, int threads,
                     int chunks, size_t smem, int32_t* counts_out,
                     cudaStream_t stream) {
  const int log_k = 31 - __builtin_clz(K);
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err =
      allow_smem_once((const void*)partition_raw_kernel<NK, IDX, SPL, E>,
                      partition_smem_cap<NK, IDX>(), smem_set);
  if (err != cudaSuccess) return (int)err;
  partition_raw_kernel<NK, IDX, SPL, E><<<T, threads, smem, stream>>>(
      planes, vals, spl, counts_in, q_in, n, K, log_k, R, S, lo_bit, width,
      t_seg, log_run, chunks, counts_out);
  return (int)cudaGetLastError();
}

// Host side: the instance for (n_planes, has values, slots a thread) with
// SPL, launched at (threads, chunks, smem); cudaErrorInvalidValue for a
// geometry no instance was built for.
template <bool SPL>
int dispatch_partition(const Planes& planes, const Values& vals,
                       const Splitters& spl, int n_planes,
                       const int32_t* counts_in, int q_in, long long n,
                       int T, int K, int R, int S, int lo_bit, int width,
                       int t_seg, int sorted_run, int threads, int slots,
                       size_t smem, int32_t* counts_out,
                       cudaStream_t stream) {
  int chunks = 0;
  if (R < 1 || R > kMaxRadix || (K & (K - 1)) != 0 ||
      !reg_geometry_ok(K, threads, slots, smem,
                       (size_t)K * (4 * n_planes + (vals.count > 0 ? 2 : 0)),
                       &chunks)) {
    return (int)cudaErrorInvalidValue;
  }
  const int log_run = sorted_run > 0 ? 31 - __builtin_clz(sorted_run) : 0;
  return dispatch_slots(slots, [&](auto e) {
    return dispatch_mode(n_planes, vals.count > 0, [&](auto nk, auto idx) {
      constexpr int kNk = decltype(nk)::value;
      constexpr bool kIdx = decltype(idx)::value;
      constexpr int kE = decltype(e)::value;
      if constexpr (!fits_registers(kNk, kIdx, kE)) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (threads > partition_threads(kNk, kIdx, kE)) {
          return (int)cudaErrorInvalidValue;
        }
        return launch_partition<kNk, kIdx, SPL, kE>(
            planes, vals, spl, counts_in, q_in, n, T, K, R, S, lo_bit, width,
            t_seg, log_run, threads, chunks, smem, counts_out, stream);
      }
    });
  });
}

}  // namespace tpusort

// keys_in/keys_out: n_planes (1-3) device pointers each; vals_in/vals_out:
// n_vals (0-8) device pointers each.  K a power of two; threads, slots (E)
// and smem the geometry of kernels/bitonic.py:tile_sort_geometry(K,
// n_planes, n_vals).  Returns a cudaError_t (cudaErrorInvalidValue for a
// geometry no instance was built for).
extern "C" int tpusort_partition_raw(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts_in, int q_in, long long n, int T, int K, int R, int S,
    int lo_bit, int width, int t_seg, int sorted_run, int threads, int slots,
    int smem, void* counts_out, void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  if (!make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_partition<false>(
      planes, vals, Splitters{}, n_planes, (const int32_t*)counts_in, q_in, n,
      T, K, R, S, lo_bit, width, t_seg, sorted_run, threads, slots,
      (size_t)smem, (int32_t*)counts_out, (cudaStream_t)stream);
}

// K1b: as tpusort_partition_raw, with the runs cut at splitters (n_planes
// (T, R-1) word arrays) and tie fractions ((T, R-1) words) in place of the
// digit bits.  Returns a cudaError_t.
extern "C" int tpusort_partition_splitter(
    const void* const* keys_in, void* const* keys_out, int n_planes,
    const void* const* vals_in, void* const* vals_out, int n_vals,
    const void* counts_in, int q_in, long long n, int T, int K, int R, int S,
    int t_seg, int sorted_run, const void* const* splitters,
    const void* fracs, int threads, int slots, int smem, void* counts_out,
    void* stream) {
  using namespace tpusort;
  Planes planes;
  Values vals;
  if (R < 2 ||
      !make_operands(keys_in, keys_out, n_planes, vals_in, vals_out, n_vals,
                     &planes, &vals)) {
    return (int)cudaErrorInvalidValue;
  }
  Splitters spl{};
  for (int p = 0; p < n_planes; ++p) {
    spl.word[p] = static_cast<const uint32_t*>(splitters[p]);
  }
  spl.frac = static_cast<const uint32_t*>(fracs);
  return dispatch_partition<true>(
      planes, vals, spl, n_planes, (const int32_t*)counts_in, q_in, n, T, K,
      R, S, 0, 1, t_seg, sorted_run, threads, slots, (size_t)smem,
      (int32_t*)counts_out, (cudaStream_t)stream);
}

extern "C" const char* tpusort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
