// Host entry points of the symmetric buffers (kernels/symm.py): device
// allocations of our own, CUDA IPC handles, and a host-mapped error flag.
//
// The buffers are allocated with cudaMalloc here, not by PyTorch's caching
// allocator: an IPC handle names a whole cudaMalloc allocation, and a
// handle of a cached sub-block would open at its segment's base.

#include <string.h>

#include "symm.cuh"

extern "C" int symm_alloc(int device, long long bytes, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMalloc(out, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  // a zero pad: every signal word starts below every epoch's values
  e = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int symm_free(int device, void* p) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaFree(p));
}

// handle_out: 64 bytes (cudaIpcMemHandle_t)
extern "C" int ipc_get_handle(void* p, void* handle_out) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  memcpy(handle_out, &h, sizeof(h));
  return 0;
}

extern "C" int ipc_open_handle(int device, const void* handle, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int ipc_close_handle(int device, void* p) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaIpcCloseMemHandle(p));
}

// An int in pinned host memory that kernels write through its mapped
// device address (the same address under unified addressing).
extern "C" int host_flag_alloc(void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, 64, cudaHostAllocMapped);
  if (e != cudaSuccess) return static_cast<int>(e);
  memset(*host, 0, 64);
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

extern "C" int host_flag_free(void* host) { return static_cast<int>(cudaFreeHost(host)); }

extern "C" int ipc_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }
