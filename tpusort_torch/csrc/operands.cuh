// What every kernel of the port shares: the operand structs passed to the
// kernels by value, the host helpers that pack and check them, the mode
// dispatch, and the limits of a CTA on sm_90.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace tpusort {

constexpr int kThreads = 1024;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;  // invalid slots, every plane

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

// Word k (0-3) of a 16-byte load.
__device__ __forceinline__ uint32_t word(const uint4& q, int k) {
  return k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
}

// Host side: true if the n output pointers are 16-byte aligned (the
// kernels store 16 bytes at a time; the wrappers' fresh outputs are).
inline bool aligned16(void* const* out, int n) {
  for (int k = 0; k < n; ++k) {
    if (reinterpret_cast<uintptr_t>(out[k]) & 15) return false;
  }
  return true;
}

// Bits [lo, lo + width) of slot s's NK-plane key (plane 0 the most
// significant), width <= 31; key(p, s) is plane p's word of slot s.  K1's
// digits (partition.cu) and the packed leaf's remainders (sort_tiles.cu).
template <int NK, class Key>
__device__ inline int digit_of(Key key, int s, int lo, int width) {
  uint32_t d = 0;
#pragma unroll
  for (int p = 0; p < NK; ++p) {
    const int base = 32 * (NK - 1 - p);
    const int ov_lo = max(lo, base);
    const int ov_hi = min(lo + width, base + 32);
    if (ov_hi > ov_lo) {
      const uint32_t m = (1u << (ov_hi - ov_lo)) - 1u;
      d |= ((key(p, s) >> (ov_lo - base)) & m) << (ov_lo - lo);
    }
  }
  return (int)d;
}

constexpr int kMaxSmem = 232448;   // dynamic shared memory of a CTA, sm_90
constexpr int kMaxDevices = 64;

// Host side: raise a kernel's dynamic shared memory cap to `cap` bytes,
// once per device (the runtime call costs microseconds, which a single-row
// sort, launched from the host each time, would pay at every launch):
// `done` is the kernel instance's own flag array.
inline cudaError_t allow_smem_once(const void* kernel, int cap,
                                   std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace tpusort
