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
// Bound: bytes. Every element is read once and written once as int8; there
// are a handful of operations per byte.
//
// Design (the dequantize kernel's, in reverse): a group of lanes takes one
// quant block, each lane VPL vectors of 16 bytes (8 bf16 or 4 fp32 values):
// block 64 in bf16 8 lanes (four blocks a warp), block 128 16 lanes, block
// 256 32 lanes (in fp32 two vectors a lane). The values stay in registers
// from the load to the rounding, so x is read once; the absmax is reduced
// by shuffles inside the group; each lane stores its int8 values packed in
// one instruction a vector (8 bytes for bf16, 4 for fp32) and the group's
// first lane writes the scale. The grid covers every quant block, a warp
// taking 32 / L of them, and the block scheduler streams the CTAs through
// the SMs (a grid-stride loop with the next blocks loaded ahead in
// registers was slower at every shape tried on the H100). The vector that
// straddles `n` is read value by value, and the
// ragged tail reads as zeros, so the payload comes out padded to whole
// blocks. Block sizes that are not a power-of-two number of vectors (up to
// 128), and an x that is not 16-byte aligned, take the scalar kernel: a
// warp a block, lanes striding one value at a time, x read twice.

#include "common.cuh"

namespace {

constexpr int kQuantWarps = 8, kQuantThreads = 32 * kQuantWarps;
constexpr int kQuantMaxVpl = 4;  // vectors a lane

// scale = amax * (1/qmax); q = clamp(rint(v * inv), -qmax, qmax)
__device__ __forceinline__ float quant_scale(float amax, float inv_qmax) {
  return amax * inv_qmax;
}
__device__ __forceinline__ float quant_inv(float scale) {
  return scale > 0.f ? 1.0f / scale : 0.f;
}
__device__ __forceinline__ int quant_round(float v, float inv, float qmax) {
  return static_cast<int>(fminf(fmaxf(rintf(v * inv), -qmax), qmax));
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_blockwise_kernel(
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

  const float scale = quant_scale(amax, inv_qmax);
  const float inv = quant_inv(scale);
  for (int j = lane; j < block; j += 32) {
    const long long i = base + j;
    const float v = i < n ? load_f(x, i) : 0.f;
    q[i] = static_cast<int8_t>(quant_round(v, inv, qmax));
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// VEC int8 values packed into one store: 8 bytes for bf16, 4 for fp32.
template <int VEC>
struct Packed;
template <>
struct Packed<4> {
  __device__ static void store(int8_t* p, const int (&b)[4]) {
    *reinterpret_cast<unsigned*>(p) = (b[0] & 0xff) | (b[1] & 0xff) << 8 | (b[2] & 0xff) << 16 |
                                      static_cast<unsigned>(b[3] & 0xff) << 24;
  }
};
template <>
struct Packed<8> {
  __device__ static void store(int8_t* p, const int (&b)[8]) {
    const unsigned lo = (b[0] & 0xff) | (b[1] & 0xff) << 8 | (b[2] & 0xff) << 16 |
                        static_cast<unsigned>(b[3] & 0xff) << 24;
    const unsigned hi = (b[4] & 0xff) | (b[5] & 0xff) << 8 | (b[6] & 0xff) << 16 |
                        static_cast<unsigned>(b[7] & 0xff) << 24;
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  }
};

// Quant blocks of L * VPL vectors, L = 2^lpb_log2 lanes a block: lane `sub`
// holds vectors sub, sub + L, ... of its block; warp w of the grid takes
// blocks w * gpw + its group.
template <typename T, int VEC, int VPL>
__global__ void __launch_bounds__(kQuantThreads) quantize_blockwise_vec_kernel(
    const T* __restrict__ x, long long n, int8_t* __restrict__ q, float* __restrict__ scales,
    long long nb, int lpb_log2, float qmax, float inv_qmax) {
  using V = Vec<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int L = 1 << lpb_log2;
  const int sub = lane & (L - 1);
  const long long block = static_cast<long long>(L) * VPL * VEC;
  const long long blk =
      (static_cast<long long>(blockIdx.x) * kQuantWarps + (threadIdx.x >> 5)) * (32 >> lpb_log2) +
      (lane >> lpb_log2);

  V a[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const long long e = blk * block + static_cast<long long>(sub + i * L) * VEC;
    if (blk < nb && e + VEC <= n) {
      a[i] = *reinterpret_cast<const V*>(x + e);
    } else {  // past the blocks, or the vector that straddles n
      a[i] = V{};
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (blk < nb && e + k < n) a[i].v[k] = x[e + k];
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) amax = fmaxf(amax, fabsf(load_f(a[i].v, k)));
  for (int o = L >> 1; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (blk >= nb) return;
  const float scale = quant_scale(amax, inv_qmax);
  const float inv = quant_inv(scale);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    int codes[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) codes[k] = quant_round(reload_f(a[i].v, k), inv, qmax);
    Packed<VEC>::store(q + blk * block + static_cast<long long>(sub + i * L) * VEC, codes);
  }
  if (sub == 0) scales[blk] = scale;
}

template <typename T, int VEC, int VPL>
void launch_vec(const void* x, long long n, void* q, void* scales, long long nb, int lpb_log2,
                float qmax, float inv_qmax, cudaStream_t s) {
  const long long per_cta = static_cast<long long>(kQuantWarps) * (32 >> lpb_log2);
  quantize_blockwise_vec_kernel<T, VEC, VPL>
      <<<static_cast<unsigned>((nb + per_cta - 1) / per_cta), kQuantThreads, 0, s>>>(
          static_cast<const T*>(x), n, static_cast<int8_t*>(q), static_cast<float*>(scales), nb,
          lpb_log2, qmax, inv_qmax);
}

// The vector kernel for x of T, if `block` is a power-of-two number of its
// 16-byte vectors (at most 32 * kQuantMaxVpl) and x is 16-byte aligned;
// false otherwise.
template <typename T>
bool try_vec(const void* x, long long n, void* q, void* scales, long long nb, int block,
             float qmax, float inv_qmax, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = block / VEC;
  if (block % VEC != 0 || (nv & (nv - 1)) != 0 || nv > 32 * kQuantMaxVpl ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(q) & (VEC - 1)) != 0)
    return false;
  int lpb_log2 = 0;
  while ((1 << lpb_log2) < nv && lpb_log2 < 5) ++lpb_log2;
  const int vpl = nv >> lpb_log2;
  const auto launch = vpl == 1   ? launch_vec<T, VEC, 1>
                      : vpl == 2 ? launch_vec<T, VEC, 2>
                                 : launch_vec<T, VEC, kQuantMaxVpl>;
  launch(x, n, q, scales, nb, lpb_log2, qmax, inv_qmax, s);
  return true;
}

template <typename T>
void launch_scalar(const void* x, long long n, void* q, void* scales, long long nb, int block,
                   float qmax, float inv_qmax, cudaStream_t s) {
  const long long grid = (nb + kQuantWarps - 1) / kQuantWarps;
  quantize_blockwise_kernel<T><<<static_cast<unsigned>(grid), kQuantThreads, 0, s>>>(
      static_cast<const T*>(x), n, static_cast<int8_t*>(q), static_cast<float*>(scales), nb,
      block, qmax, inv_qmax);
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
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  if (block < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_F32) {
    if (!try_vec<float>(x, n, q, scales, nb, block, qmax, inv_qmax, s))
      launch_scalar<float>(x, n, q, scales, nb, block, qmax, inv_qmax, s);
  } else if (x_dtype == DT_BF16) {
    if (!try_vec<__nv_bfloat16>(x, n, q, scales, nb, block, qmax, inv_qmax, s))
      launch_scalar<__nv_bfloat16>(x, n, q, scales, nb, block, qmax, inv_qmax, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned by any entry point of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
