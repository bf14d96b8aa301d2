// Blockwise symmetric absmax int8 quantization, written by hand for Hopper.
//
// Replaces: src/repro/kernels/quantize.py:_quant_kernel (launched by
// _quantize_pallas), the TPU kernel that quantizes the outer collective's
// payload and, with block = head_dim, every int8 KV-cache write.
//
// Per block of `block` elements:
//   scale = absmax * (1/qmax)        (1/qmax rounded once to float)
//   inv   = scale > 0 ? 1/scale : 0  (IEEE division: built without fast math)
//   q     = clamp(rint(x * inv), -qmax, qmax)   (round half to even)
// which matches the plain version (kernels/ref.py) bit for bit.
//
// Bound: bytes. Every element is read once (twice from L1) and written once
// as int8; there are a handful of operations per byte. Design: one warp per
// block row, lanes striding over the row, the absmax reduced by shuffles;
// eight rows per thread block. `block` is generic, so the KV path (block =
// 64) and the outer-sync path (block = 256) share the kernel. The ragged
// tail past `n` reads as zeros, so the payload comes out padded to whole
// blocks.

#include "common.cuh"

namespace {

constexpr int kQuantWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32) quantize_blockwise_kernel(
    const T* __restrict__ x, long long n, int8_t* __restrict__ q,
    float* __restrict__ scales, long long nb, int block, float qmax,
    float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kQuantWarps + (threadIdx.x >> 5);
  if (row >= nb) return;
  const long long base = row * block;

  float amax = 0.f;
  for (int j = lane; j < block; j += 32) {
    const long long i = base + j;
    const float v = i < n ? load_f(x, i) : 0.f;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = warp_max(amax);

  const float scale = amax * inv_qmax;
  const float inv = scale > 0.f ? 1.0f / scale : 0.f;
  for (int j = lane; j < block; j += 32) {
    const long long i = base + j;
    const float v = i < n ? load_f(x, i) : 0.f;
    const float r = fminf(fmaxf(rintf(v * inv), -qmax), qmax);
    q[i] = static_cast<int8_t>(r);
  }
  if (lane == 0) scales[row] = scale;
}

}  // namespace

extern "C" int quantize_blockwise_launch(const void* x, int x_dtype,
                                         long long n, void* q, void* scales,
                                         long long nb, int block, float qmax,
                                         float inv_qmax, int device, void* stream) {
  // bind the calling thread to the tensors' card (autograd's thread may
  // have no current context yet)
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const long long grid = (nb + kQuantWarps - 1) / kQuantWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (x_dtype == DT_F32) {
      quantize_blockwise_kernel<float><<<static_cast<unsigned>(grid), kQuantWarps * 32, 0, s>>>(
          static_cast<const float*>(x), n, static_cast<int8_t*>(q),
          static_cast<float*>(scales), nb, block, qmax, inv_qmax);
    } else if (x_dtype == DT_BF16) {
      quantize_blockwise_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kQuantWarps * 32, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, static_cast<int8_t*>(q),
          static_cast<float*>(scales), nb, block, qmax, inv_qmax);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned by any entry point of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
