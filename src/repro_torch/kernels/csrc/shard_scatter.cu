// Shard scatter of the int8 wire (the rs-ag reduce-scatter leg), written
// by hand for Hopper.
//
// Replaces: src/repro/kernels/ring_allreduce.py:_shard_scatter_kernel
// (launched by _shard_scatter_tpu_1d / shard_scatter_wire_tpu), the TPU
// kernel that sends slot e of every endpoint's per-slot wire stack to
// endpoint e with remote DMAs, so that endpoint e holds its own slot from
// every source in canonical source order. Here over the symmetric buffers
// of symm.cuh (CUDA IPC), as the ring all-gather.
//
// Member r of E, for each block b (a stripe of the slot bytes)
// independently:
//   - a global entry barrier: it signals "ready" into every peer's pad and
//     waits for every peer's "ready" in its own (the TPU kernel's barrier);
//   - for every offset k = 1 .. E-1 it stores its slot (r + k) mod E into
//     row r of that owner's data region; the rows are disjoint, so every
//     offset goes at once. Its own slot goes straight to its output row r;
//   - one release signal per (source, owner) pair after
//     __threadfence_system(); the owner acquire-waits for its E - 1
//     signals and copies the rows into its output.
// Deadlines and the error flag as in ring_allgather.cu.
//
// Bound: bytes. On one card a launch moves about 2 E (E - 1) m bytes of
// slots through the shared HBM (m the slot length; written into the peers,
// read back by the owners), plus every member's own slot and output.

#include "symm.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kWireThreads) shard_scatter_kernel(
    const T* __restrict__ slots, long long m, T* __restrict__ out, Peers peers,
    long long slot_stride, int rank, int E, unsigned long long epoch,
    unsigned long long timeout_ns, int* err_flag) {
  const int b = blockIdx.x;
  char* mine = peers.base[rank];
  const uint64_t deadline = global_ns() + timeout_ns;
  const uint64_t base_val = epoch * 64ull;
  long long lo, hi;
  stripe(m, &lo, &hi);

  if (threadIdx.x == 0) {
    for (int j = 0; j < E; ++j)
      if (j != rank) st_release_sys(ready_word(peers.base[j], b, rank), base_val);
  }
  for (int j = 0; j < E; ++j) {
    if (j != rank && !block_wait_geq(ready_word(mine, b, j), base_val, deadline, err_flag,
                                     kErrReadyTimeout))
      return;
  }

  const long long stride_u = slot_stride / static_cast<long long>(sizeof(T));
  for (int k = 1; k < E; ++k) {
    const int o = (rank + k) % E;
    T* dst = reinterpret_cast<T*>(peers.base[o] + kPadBytes) + rank * stride_u;
    const T* from = slots + o * m;
    for (long long u = lo + threadIdx.x; u < hi; u += blockDim.x) dst[u] = from[u];
  }
  {
    const T* from = slots + rank * m;
    T* o = out + rank * m;
    for (long long u = lo + threadIdx.x; u < hi; u += blockDim.x) o[u] = from[u];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < E; ++k)
      st_release_sys(data_word(peers.base[(rank + k) % E], b, rank), base_val + 1);
  }

  const T* my_data = reinterpret_cast<const T*>(mine + kPadBytes);
  for (int j = 0; j < E; ++j) {
    if (j == rank) continue;
    if (!block_wait_geq(data_word(mine, b, j), base_val + 1, deadline, err_flag,
                        kErrDataTimeout))
      return;
    const T* from = my_data + j * stride_u;
    T* o = out + j * m;
    for (long long u = lo + threadIdx.x; u < hi; u += blockDim.x) o[u] = load_recv(from + u);
  }
}

}  // namespace

// slots: (E, m) bytes, row e meant for member e; out: (E, m) bytes, row j
// member j's slot `rank`; peers, slot_stride (>= m, a multiple of 16),
// err_flag as ring_allgather_launch.
extern "C" int shard_scatter_launch(const void* slots, long long m, void* out,
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
      nblocks > kMaxBlocks || slot_stride % 16 != 0 || slot_stride < m)
    return static_cast<int>(cudaErrorInvalidValue);
  Peers p;
  for (int j = 0; j < kMaxRanks; ++j)
    p.base[j] = j < E ? static_cast<char*>(const_cast<void*>(peers[j])) : nullptr;
  int* flag = static_cast<int*>(err_flag);
  if (vector_ok(slots, out, m)) {
    shard_scatter_kernel<uint4><<<nblocks, kWireThreads, 0, st>>>(
        static_cast<const uint4*>(slots), m / 16, static_cast<uint4*>(out), p, slot_stride,
        rank, E, epoch, timeout_ns, flag);
  } else {
    shard_scatter_kernel<unsigned char><<<nblocks, kWireThreads, 0, st>>>(
        static_cast<const unsigned char*>(slots), m, static_cast<unsigned char*>(out), p,
        slot_stride, rank, E, epoch, timeout_ns, flag);
  }
  return static_cast<int>(cudaGetLastError());
}
