// Ring all-gather of the int8 wire, written by hand for Hopper.
//
// Replaces: src/repro/kernels/ring_allreduce.py:_ring_allgather_kernel
// (launched by _ring_allgather_tpu_1d / ring_allgather_wire_tpu), the TPU
// kernel that forwards one endpoint's packed wire bytes and scales around
// the exchange ring with remote DMAs, so that every endpoint holds every
// source in its canonical slot. Here the ring runs over symmetric buffers
// (symm.cuh) that every member maps into its peers with CUDA IPC: on one
// card the members are processes sharing it, on several cards the same
// pointers are peer-mapped over NVLink.
//
// Member r of E, for each block b (a stripe of the bytes) independently:
//   - signals its left neighbour "ready" and waits for its right
//     neighbour's "ready" (the TPU kernel's opening neighbour barrier);
//   - hop k = 0 .. E-2: stores slot (r - k) mod E (its own input at k = 0,
//     the slot that just arrived from the left otherwise) straight into
//     the right neighbour's same slot, then publishes (epoch, k + 1) into
//     the right neighbour's pad after __threadfence_system();
//   - before hop k >= 1 it acquire-waits for the left neighbour's (epoch,
//     k) word; every slot is copied into the output row as it is read.
// Epochs grow with every call, so no pad is reset. A wait that passes its
// deadline writes an error code to a host-mapped flag and the kernel
// returns; the wrapper raises when it reads the flag.
//
// Bound: bytes. All E members share one card's HBM here, so one launch
// moves about 2 E (E - 1) n bytes through it (each member writes E - 1
// slots into a peer and reads E - 1 back, plus its input and output).
// Ranks on one card are time-sliced between their CUDA contexts, so a hop
// costs a context switch, not a memory time. Design: at most 32 blocks
// (all resident, none waits for a block that is not scheduled), 16-byte
// vector copies when the lengths and pointers allow, bytes otherwise.

#include "symm.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kWireThreads) ring_allgather_kernel(
    const T* __restrict__ src, long long n, T* __restrict__ out, Peers peers,
    long long slot_stride, int rank, int E, unsigned long long epoch,
    unsigned long long timeout_ns, int* err_flag) {
  const int b = blockIdx.x;
  const int right = (rank + 1) % E, left = (rank + E - 1) % E;
  char* mine = peers.base[rank];
  char* rbase = peers.base[right];
  const uint64_t deadline = global_ns() + timeout_ns;
  const uint64_t base_val = epoch * 64ull;
  long long lo, hi;
  stripe(n, &lo, &hi);

  // opening neighbour barrier: my region is free for this call
  if (threadIdx.x == 0) st_release_sys(ready_word(peers.base[left], b, rank), base_val);
  if (!block_wait_geq(ready_word(mine, b, right), base_val, deadline, err_flag,
                      kErrReadyTimeout))
    return;

  const long long stride_u = slot_stride / static_cast<long long>(sizeof(T));
  const T* my_data = reinterpret_cast<const T*>(mine + kPadBytes);
  T* r_data = reinterpret_cast<T*>(rbase + kPadBytes);
  for (int k = 0; k < E; ++k) {
    if (k > 0 && !block_wait_geq(data_word(mine, b, left), base_val + k, deadline, err_flag,
                                 kErrDataTimeout))
      return;
    const int s = (rank - k + E) % E;
    const bool forward = k < E - 1;
    T* o = out + s * n;
    if (k == 0) {
      for (long long u = lo + threadIdx.x; u < hi; u += blockDim.x) {
        const T v = src[u];
        o[u] = v;
        if (forward) r_data[s * stride_u + u] = v;
      }
    } else {
      const T* from = my_data + s * stride_u;
      for (long long u = lo + threadIdx.x; u < hi; u += blockDim.x) {
        const T v = load_recv(from + u);
        o[u] = v;
        if (forward) r_data[s * stride_u + u] = v;
      }
    }
    if (forward) block_signal(data_word(rbase, b, rank), base_val + k + 1);
  }
}

}  // namespace

// src: (n,) bytes of this member; out: (E, n) bytes; peers: E buffer bases
// (own at [rank]); slot_stride: bytes between slots of a data region (a
// multiple of 16, >= n). err_flag: a host-mapped int.
extern "C" int ring_allgather_launch(const void* src, long long n, void* out,
                                     const void* const* peers, long long slot_stride,
                                     int rank, int E, unsigned long long epoch,
                                     unsigned long long timeout_ns, void* err_flag,
                                     int nblocks, int device, void* stream) {
  // bind the calling thread to the tensors' card (autograd's thread may
  // have no current context yet)
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 2 || E > kMaxRanks || rank < 0 || rank >= E || nblocks < 1 ||
      nblocks > kMaxBlocks || slot_stride % 16 != 0 || slot_stride < n)
    return static_cast<int>(cudaErrorInvalidValue);
  Peers p;
  for (int j = 0; j < kMaxRanks; ++j)
    p.base[j] = j < E ? static_cast<char*>(const_cast<void*>(peers[j])) : nullptr;
  int* flag = static_cast<int*>(err_flag);
  if (vector_ok(src, out, n)) {
    ring_allgather_kernel<uint4><<<nblocks, kWireThreads, 0, st>>>(
        static_cast<const uint4*>(src), n / 16, static_cast<uint4*>(out), p, slot_stride,
        rank, E, epoch, timeout_ns, flag);
  } else {
    ring_allgather_kernel<unsigned char><<<nblocks, kWireThreads, 0, st>>>(
        static_cast<const unsigned char*>(src), n, static_cast<unsigned char*>(out), p,
        slot_stride, rank, E, epoch, timeout_ns, flag);
  }
  return static_cast<int>(cudaGetLastError());
}
