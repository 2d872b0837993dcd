// K7: the all-to-all of the global sort's padded windows, as a pull.
//
// Replaces the Pallas kernel _a2a_kernel behind
// tpusort/parallel/ring.py:ring_all_to_all.  Every shard r of d holds a
// (d, window) send buffer whose row b is the window it sends to shard b;
// after the exchange shard r holds out[s] = send_s[r] for every s.
//
// On the TPU each shard starts d - 1 remote DMAs and one local copy, all
// before any wait, and a semaphore pair per peer says when its own window
// has landed: the grid runs in order and the DMAs overlap.  Here CUDA
// blocks run concurrently and a kernel cannot wait for another shard's
// kernel, so the exchange is a pull: shard r launches one kernel that reads
// window r of each of the d peers' send buffers, by address from a table of
// d pointers passed by value, and writes it to row s of its own output.
// Each shard writes only its own memory, so no two stores race.  The
// caller's barrier takes the place of the semaphores: one before the launch
// (every send buffer has been written) and one after (no peer reuses its
// send buffer before every pull that reads it has been queued).  The same
// kernel reads a peer's memory on another card where the two have peer
// access; the caller here keeps every shard on one card.
//
// Grid: blockIdx.y is the peer s, blockIdx.x strides over its window in
// 16-byte words, one uint4 load and store a thread a step.  Bound: bytes,
// 2 x 4 B x d x window (each word read once and written once), 0.16 ms at
// d = 8 and window = 2^23 words at 3.35 TB/s.  Nothing is computed.
#include <cuda_runtime.h>

#include <cstdint>

namespace tpusort {

constexpr int kMaxPeers = 64;
constexpr int kRingThreads = 256;

// The peers' send buffers, passed by value in the kernel's parameter space.
struct Peers {
  const uint4* send[kMaxPeers];
};

__global__ void __launch_bounds__(kRingThreads)
ring_pull_kernel(Peers peers, int rank, long long w4, uint4* __restrict__ out) {
  const int s = blockIdx.y;
  const uint4* __restrict__ src = peers.send[s] + (size_t)rank * w4;
  uint4* __restrict__ dst = out + (size_t)s * w4;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < w4;
       i += step) {
    dst[i] = src[i];
  }
}

}  // namespace tpusort

// sends: d device pointers to (d, window) 32-bit buffers, 16-byte aligned;
// out: this shard's (d, window) buffer.  window must be a multiple of 4
// words.  Returns a cudaError_t.
extern "C" int tpusort_ring_pull(const void* const* sends, int d, int rank,
                                 long long window, void* out, void* stream) {
  using namespace tpusort;
  if (d < 1 || d > kMaxPeers || rank < 0 || rank >= d || window <= 0 ||
      window % 4 || reinterpret_cast<uintptr_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  Peers peers{};
  for (int s = 0; s < d; ++s) {
    if (reinterpret_cast<uintptr_t>(sends[s]) % 16) {
      return (int)cudaErrorInvalidValue;
    }
    peers.send[s] = static_cast<const uint4*>(sends[s]);
  }
  const long long w4 = window / 4;
  // enough blocks to keep every SM's loads in flight; each thread walks its
  // share of the window beyond that
  const long long want = (w4 + kRingThreads - 1) / kRingThreads;
  const int bx = (int)(want < 1024 ? want : 1024);
  ring_pull_kernel<<<dim3(bx, d), kRingThreads, 0, (cudaStream_t)stream>>>(
      peers, rank, w4, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
