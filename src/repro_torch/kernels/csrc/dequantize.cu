// Blockwise dequantize, written by hand for Hopper.
//
// Replaces: src/repro/kernels/quantize.py:_dequant_kernel (launched by
// _dequantize_pallas), the TPU kernel that turns the outer collective's
// int8 (or int4-in-int8) payload and its per-block fp32 absmax scales back
// into fp32, in every compressed outer sync (Quantized, Int8Wire, rs-ag).
//
//   out[i] = float(q[i]) * scales[i / block]     (one fp32 rounding)
//
// `__fmul_rn` keeps the single rounding explicit, so the kernel is bit for
// bit its plain version (kernels/ref.py:dequantize_blockwise_ref).
//
// Bound: bytes. Each value moves 1 byte in and 4 bytes out, plus one scale
// per block; one multiply per value. Design: a grid-stride loop over
// vectors of 4 values, each one 4-byte load of int8 and one 16-byte store
// of fp32, so a warp reads 128 contiguous bytes and writes 512 (16 values
// a thread, with four 16-byte stores each, would leave a warp's stores 64
// bytes apart). That path needs `block % 4 == 0` (the 4 values share one scale), a
// 4-byte aligned payload and a 16-byte aligned output; any other block
// size (the reference's tests use 32, 64, 256, but the function takes any
// block >= 1) or alignment takes a scalar grid-stride loop over single
// values. The ragged case (a payload that is not whole blocks) never
// reaches the kernel: the wrapper raises.

#include "common.cuh"

namespace {

constexpr int kDequantThreads = 256;
constexpr long long kMaxBlocks = 132 * 64;  // grid-stride beyond this

__device__ __forceinline__ float byte_times(int word, int j, float s) {
  return __fmul_rn(static_cast<float>(static_cast<int8_t>(word >> (8 * j))), s);
}

__global__ void __launch_bounds__(kDequantThreads) dequantize_vec4_kernel(
    const int* __restrict__ q, const float* __restrict__ scales,
    float4* __restrict__ out, long long nvec, int vecs_per_block) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const int w = q[v];
    const float s = scales[v / vecs_per_block];
    out[v] = make_float4(byte_times(w, 0, s), byte_times(w, 1, s), byte_times(w, 2, s),
                         byte_times(w, 3, s));
  }
}

__global__ void __launch_bounds__(kDequantThreads) dequantize_scalar_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scales,
    float* __restrict__ out, long long nq, int block) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nq; i += stride) {
    out[i] = __fmul_rn(static_cast<float>(q[i]), scales[i / block]);
  }
}

unsigned grid_for(long long items) {
  long long g = (items + kDequantThreads - 1) / kDequantThreads;
  return static_cast<unsigned>(g < kMaxBlocks ? g : kMaxBlocks);
}

}  // namespace

// q: (nq,) int8, nq a multiple of block; scales: (nq / block,) fp32;
// out: (nq,) fp32.
extern "C" int dequantize_blockwise_launch(const void* q, const void* scales, void* out,
                                           long long nq, int block, int device, void* stream) {
  // bind the calling thread to the tensors' card (autograd's thread may
  // have no current context yet)
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  if (block < 1 || nq % block != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (block % 4 == 0 && aligned) {
    const long long nvec = nq / 4;
    dequantize_vec4_kernel<<<grid_for(nvec), kDequantThreads, 0, s>>>(
        static_cast<const int*>(q), static_cast<const float*>(scales),
        static_cast<float4*>(out), nvec, block / 4);
  } else {
    dequantize_scalar_kernel<<<grid_for(nq), kDequantThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(out), nq, block);
  }
  return static_cast<int>(cudaGetLastError());
}
