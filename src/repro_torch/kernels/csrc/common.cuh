// Shared helpers of the port's CUDA kernels: dtype codes, loads and stores
// that convert to and from float, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (kernels/_build.py callers)
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const int8_t* p, long long i) {
  return static_cast<float>(p[i]);
}

// Value k of a vector held in registers, converted to float again at a
// second use. For bf16 the conversion is opaque to the compiler, so the
// vector stays packed between its two uses instead of being held as twice
// as many floats (which spills a lane that holds a whole row).
__device__ __forceinline__ float reload_f(const float* p, int k) { return p[k]; }
__device__ __forceinline__ float reload_f(const __nv_bfloat16* p, int k) {
  float f;
  asm volatile("mov.b32 %0, {0, %1};" : "=f"(f) : "h"(__bfloat16_as_ushort(p[k])));
  return f;
}

__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Large finite stand-in for -inf, as the reference kernels use: a fully
// masked row keeps exp(m_old - m_new) finite.
#define NEG_INF_F (-1e30f)

// Programmatic dependent launch (Hopper): a kernel launched with
// launch_dependent may be scheduled while the kernel before it on the stream
// is still running; it calls griddep_wait() before it reads anything that
// kernel writes. The earlier kernel may call griddep_launch_dependents()
// once its own blocks no longer need the SMs to themselves.
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}
