// Block-wide tile sort in shared memory, shared by the leaf (K2) and
// partition_tiles (K8).  The row tile sorts (K3, K9, K10) and the raw-key
// partition pass (K1, K1b) run reg_sort.cuh, the same network with its
// short steps in registers and warp shuffles.
//
// Replaces the bitonic compare-exchange networks of the Pallas kernels
// (tpusort/kernels/bitonic.py: _sort_network, _merge_sorted_runs, the staged
// f*2^a merge).  The TPU networks were shaped by a VPU without gathers:
// every stage is a static roll over 128-lane rows, and payloads ride the
// network as extra operands.  Here a stage is one pass of independent
// compare-exchanges over shared-memory arrays, one pair per thread per step,
// separated by __syncthreads().  This is the simple first version: every
// stage goes through shared memory.
//
// Payloads do not ride.  A tile of 1-3 key planes (4 bytes a slot each)
// carries, when payloads exist, a 16-bit slot index instead; the caller
// gathers each payload word from global memory by that index as it writes
// its outputs (rank, then gather).  Shared memory then depends only on the
// number of key planes: at 16,384 slots 64 KB a plane plus 32 KB of index.
#pragma once

#include <cstdint>
#include <type_traits>

namespace tpusort {

constexpr int kThreads = 1024;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;  // invalid slots, every plane

// NK key planes of n slots each, laid out one after the other from `base`,
// then (IDX) a uint16 slot index per slot.  Compares lexicographically as
// unsigned words, plane 0 most significant; unstable.  With IDX_TIES, equal
// keys compare by their slot index, so the order is (planes, index): K3
// needs it to keep its virtual pad slots (index >= K) behind genuine
// all-ones keys.
template <int NK, bool IDX, bool IDX_TIES = false>
struct SmemTile {
  static_assert(IDX || !IDX_TIES, "index ties need the index");
  uint32_t* key[NK];
  uint16_t* idx;

  __device__ SmemTile(uint32_t* base, int n) {
#pragma unroll
    for (int p = 0; p < NK; ++p) key[p] = base + (size_t)p * n;
    idx = IDX ? reinterpret_cast<uint16_t*>(base + (size_t)NK * n) : nullptr;
  }

  // Dynamic shared memory for n slots.
  static constexpr size_t bytes(int n) {
    return (size_t)n * (NK * sizeof(uint32_t) + (IDX ? sizeof(uint16_t) : 0));
  }

  __device__ void cmp_swap(int i, int j) const {
    uint32_t x[NK], y[NK];
    bool gt = IDX_TIES && idx[i] > idx[j];
#pragma unroll
    for (int p = NK - 1; p >= 0; --p) {
      x[p] = key[p][i];
      y[p] = key[p][j];
      gt = x[p] > y[p] || (x[p] == y[p] && gt);
    }
    if (gt) {
#pragma unroll
      for (int p = 0; p < NK; ++p) {
        key[p][i] = y[p];
        key[p][j] = x[p];
      }
      if (IDX) {
        const uint16_t t = idx[i];
        idx[i] = idx[j];
        idx[j] = t;
      }
    }
  }

  // Slot i from the tile's input words (plane p at src[p][i]) or, when
  // invalid, the all-ones sentinel in every plane.
  __device__ void load(int i, const uint32_t* const* src, size_t off,
                       bool valid) const {
#pragma unroll
    for (int p = 0; p < NK; ++p) key[p][i] = valid ? src[p][off + i] : kSentinel;
    if (IDX) idx[i] = (uint16_t)i;
  }
};

// Sort the tile's slots [0, 2^log_n) ascending, with all threads of the
// block.  The slots must already consist of ascending runs of 2^log_run
// (log_run = 0: unsorted); only the merge levels above that run length are
// executed.  Each level merges pairs of ascending runs: a mirror step (i
// against the reflected partner in the doubled run) turns them into two
// bitonic halves split at the median, then half-cleaners finish each half.
// Ends with __syncthreads().
template <class Tile>
__device__ inline void block_sort(const Tile& t, int log_n, int log_run) {
  const int half_n = 1 << (log_n - 1);
  for (int lk = log_run + 1; lk <= log_n; ++lk) {
    const int lh = lk - 1;
    for (int p = threadIdx.x; p < half_n; p += blockDim.x) {
      const int base = (p >> lh) << lk;
      const int off = p & ((1 << lh) - 1);
      t.cmp_swap(base + off, base + (1 << lk) - 1 - off);
    }
    __syncthreads();
    for (int lj = lh - 1; lj >= 0; --lj) {
      for (int p = threadIdx.x; p < half_n; p += blockDim.x) {
        const int i = ((p >> lj) << (lj + 1)) + (p & ((1 << lj) - 1));
        t.cmp_swap(i, i + (1 << lj));
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// Up to this many payload words per launch, passed by value.
constexpr int kMaxValues = 8;

struct Values {
  const uint32_t* in[kMaxValues];
  uint32_t* out[kMaxValues];
  int count;
};

struct Planes {
  const uint32_t* in[3];
  uint32_t* out[3];
};

// Host side: the device pointer arrays of the C entry points, checked and
// packed for the kernels; false if the counts are out of range.
inline bool make_operands(const void* const* keys_in, void* const* keys_out,
                          int n_planes, const void* const* vals_in,
                          void* const* vals_out, int n_vals, Planes* planes,
                          Values* vals) {
  if (n_planes < 1 || n_planes > 3 || n_vals < 0 || n_vals > kMaxValues) {
    return false;
  }
  *planes = Planes{};
  for (int p = 0; p < n_planes; ++p) {
    planes->in[p] = static_cast<const uint32_t*>(keys_in[p]);
    planes->out[p] = static_cast<uint32_t*>(keys_out[p]);
  }
  *vals = Values{};
  vals->count = n_vals;
  for (int v = 0; v < n_vals; ++v) {
    vals->in[v] = static_cast<const uint32_t*>(vals_in[v]);
    vals->out[v] = static_cast<uint32_t*>(vals_out[v]);
  }
  return true;
}

// Up to this many operand words per launch of the kernels that move words
// without comparing them (K1c, K4), passed by value.
constexpr int kMaxOperands = 16;

struct Operands {
  const uint32_t* in[kMaxOperands];
  uint32_t* out[kMaxOperands];
  int count;
};

// Host side: n (1-16) input and output device pointers packed for those
// kernels; false if n is out of range.
inline bool make_operand_list(const void* const* in, void* const* out, int n,
                              Operands* ops) {
  if (n < 1 || n > kMaxOperands) return false;
  *ops = Operands{};
  ops->count = n;
  for (int k = 0; k < n; ++k) {
    ops->in[k] = static_cast<const uint32_t*>(in[k]);
    ops->out[k] = static_cast<uint32_t*>(out[k]);
  }
  return true;
}

// Host side: calls f(NK, IDX) with NK = n_planes (1-3) and IDX = has_values
// as compile-time constants, so each mode runs its own template instance.
template <class F>
int dispatch_mode(int n_planes, bool has_values, F&& f) {
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using Three = std::integral_constant<int, 3>;
  switch (n_planes) {
    case 1:
      return has_values ? f(One{}, std::true_type{}) : f(One{}, std::false_type{});
    case 2:
      return has_values ? f(Two{}, std::true_type{}) : f(Two{}, std::false_type{});
    default:
      return has_values ? f(Three{}, std::true_type{})
                        : f(Three{}, std::false_type{});
  }
}

}  // namespace tpusort
