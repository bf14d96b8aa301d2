// Symmetric buffers of the wire exchange: the layout every rank's buffer
// shares, and the signalling helpers of the ring all-gather and shard
// scatter kernels.
//
// Every member of an exchange group owns one buffer (cudaMalloc, mapped
// into its peers with CUDA IPC). It starts with a signal pad, then the
// data region:
//
//   [ ready[kMaxBlocks][kMaxRanks] | data[kMaxBlocks][kMaxRanks] ]  uint64
//   [ pad to kPadBytes ][ data region: E slots of slot_stride bytes ]
//
// Word ready[b][j] of member r's pad is written by member j: "block b of
// my kernel may now store into your data region". Word data[b][j] is
// written by member j after block b of its kernel stored into r's data
// region. Values grow with every call (epoch * 64 + step), so a pad is
// never reset and a wait is "until the word reaches the value".
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxRanks = 8;
constexpr int kMaxBlocks = 32;
constexpr long long kPadBytes = 8192;  // >= 2 * kMaxBlocks * kMaxRanks * 8
constexpr int kWireThreads = 256;

// error codes written to the host-mapped flag on a missed deadline
constexpr int kErrReadyTimeout = 1;
constexpr int kErrDataTimeout = 2;

struct Peers {
  char* base[kMaxRanks];  // every member's buffer, mapped here; own at [rank]
};

__device__ __forceinline__ uint64_t* ready_word(char* base, int b, int j) {
  return reinterpret_cast<uint64_t*>(base) + b * kMaxRanks + j;
}
__device__ __forceinline__ uint64_t* data_word(char* base, int b, int j) {
  return reinterpret_cast<uint64_t*>(base) + kMaxBlocks * kMaxRanks + b * kMaxRanks + j;
}

__device__ __forceinline__ uint64_t ld_acquire_sys(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (with __nanosleep) until *p >= target. Ranks that share a card are
// time-sliced, so the peer may only advance when the card switches to
// its context: the wait ends at `deadline` (globaltimer ns) at the latest,
// and then writes `code` to the host-mapped error flag and returns false.
__device__ __forceinline__ bool wait_geq(const uint64_t* p, uint64_t target,
                                         uint64_t deadline, int* err_flag, int code) {
  unsigned ns = 64;
  while (ld_acquire_sys(p) < target) {
    if (global_ns() > deadline) {
      atomicExch_system(err_flag, code);
      __threadfence_system();
      return false;
    }
    __nanosleep(ns);
    if (ns < 4096) ns <<= 1;
  }
  return true;
}

// Thread 0 of the block waits; every thread learns the outcome.
__device__ __forceinline__ bool block_wait_geq(const uint64_t* p, uint64_t target,
                                               uint64_t deadline, int* err_flag, int code) {
  __shared__ int ok;
  if (threadIdx.x == 0) ok = wait_geq(p, target, deadline, err_flag, code) ? 1 : 0;
  __syncthreads();
  const bool r = ok != 0;
  __syncthreads();  // `ok` is reused by the next wait
  return r;
}

// Every thread's stores of this block become visible system-wide, then
// thread 0 publishes `value` (release) into a peer's pad word.
__device__ __forceinline__ void block_signal(uint64_t* word, uint64_t value) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) st_release_sys(word, value);
}

// This block's part [lo, hi) of n units.
__device__ __forceinline__ void stripe(long long n, long long* lo, long long* hi) {
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  *lo = per * blockIdx.x;
  *hi = *lo + per < n ? *lo + per : n;
  if (*lo > n) *lo = n;
}

// Received data: read at L2 (a peer wrote it; never serve it from L1).
__device__ __forceinline__ uint4 load_recv(const uint4* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned char load_recv(const unsigned char* p) {
  return *reinterpret_cast<const volatile unsigned char*>(p);
}

inline bool vector_ok(const void* a, const void* b, long long nbytes) {
  return nbytes % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}
