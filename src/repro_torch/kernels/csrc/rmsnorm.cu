// RMSNorm forward and backward, written by hand for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm.py:_rmsnorm_kernel (launched by
// _rmsnorm_pallas), the TPU kernel that normalises a (block_rows, D) panel
// in VMEM in one pass:
//   y = x * rsqrt(mean(x^2) + eps) * scale
// with x widened to fp32, the scale read in fp32 and y cast back to x's
// dtype. The port runs it wherever a model with norm="rmsnorm" normalises:
// the block and final norms (D = d_model) and the per-head qk-norm
// (D = head_dim, eps 1e-6).
//
// The backward has no TPU kernel to mirror (the reference differentiates
// XLA's ops). With r = rsqrt(mean(x^2) + eps) per row, s the scale and
// g = dy:
//   dx     = r s g - x r^3 (sum_j g_j s_j x_j) / D     (x's dtype)
//   dscale = sum over rows of g x r                    (fp32)
// The forward writes r per row in fp32 when autograd needs it, as the flash
// forward writes its log-sum-exp, so the backward does not recompute it.
//
// Bound: bytes. Per element the forward reads x and writes y (4 bytes in
// bf16) for 4 operations; the backward reads x and dy and writes dx. Design:
// each row is reduced in fp32 by a group of threads, 16-byte loads a
// thread (8 bf16 or 4 fp32 values) when D is a multiple of that width and
// the pointers are aligned, one value a thread otherwise. A row of at most
// 32 vectors (the qk-norm's 128, the decode batch's narrow rows) takes a
// power-of-two slice of a warp, reduced with shuffles, so several rows share
// a warp; a wider row (d_model 2048) takes a whole block, reduced with
// shuffles and then across warps through shared memory. Every thread of a
// group ends with the same sum, added in the same order, so the result does
// not depend on the launch.
//
// dscale is a sum over all rows, made without atomics so that it is the
// same in every run: each thread accumulates its own columns in shared
// memory over the rows its block takes, the block adds its groups in a
// fixed order and writes one row of an (nblocks, D) fp32 workspace, and a
// second kernel adds the workspace's rows per column in order.
//
// The output products are written with __fmul_rn / __fsub_rn in the order
// of the plain version (kernels/ref.py:rmsnorm_ref, rmsnorm_bwd_ref); only
// the sums' order differs from it.

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kWarpRowThreads = 256;  // block size when rows share warps
constexpr int kMaxThreads = 1024;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Sum of v over the G threads of this thread's group. G <= 32 is a
// power-of-two slice of a warp (every lane of the warp takes part); G > 32
// is the whole block. ``red`` is 32 floats of shared memory.
__device__ __forceinline__ float group_sum(float v, int G, float* red) {
  if (G <= 32) {
    for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  v = warp_sum(v);
  __syncthreads();  // ``red`` may still be read for the previous row
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, int i, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = load_f(p, i);
  } else {
    const Vec<T, VEC> w = reinterpret_cast<const Vec<T, VEC>*>(p)[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = load_f(w.v, k);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, int i, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    store_f(p, i, f[0]);
  } else {
    Vec<T, VEC> w;
#pragma unroll
    for (int k = 0; k < VEC; ++k) store_f(w.v, k, f[k]);
    reinterpret_cast<Vec<T, VEC>*>(p)[i] = w;
  }
}

// Each block takes rows base + group for base = blockIdx.x * groups, +
// gridDim.x * groups, ...: the trip count is the same for every thread of
// the block, so every thread reaches every shuffle and barrier.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
    float* __restrict__ rstd, long long rows, int D, int G, float eps) {
  __shared__ float red[32];
  const int nvec = D / VEC;
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  for (long long base = static_cast<long long>(blockIdx.x) * groups; base < rows;
       base += static_cast<long long>(gridDim.x) * groups) {
    const long long row = base + group;
    const bool live = row < rows;
    const T* xr = x + row * D;
    float ss = 0.f;
    if (live) {
      for (int i = lane; i < nvec; i += G) {
        float f[VEC];
        load_vec<T, VEC>(xr, i, f);
#pragma unroll
        for (int k = 0; k < VEC; ++k) ss += f[k] * f[k];
      }
    }
    ss = group_sum(ss, G, red);
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(D)), eps));
    if (!live) continue;
    if (rstd != nullptr && lane == 0) rstd[row] = r;
    T* orow = out + row * D;
    for (int i = lane; i < nvec; i += G) {
      float f[VEC];
      load_vec<T, VEC>(xr, i, f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) f[k] = __fmul_rn(__fmul_rn(f[k], r), scale[i * VEC + k]);
      store_vec<T, VEC>(orow, i, f);
    }
  }
}

// dx for the rows of this block, and this block's row of the dscale
// workspace. Shared memory: ``groups * D`` floats, one dscale accumulator
// per group and column; column c of a group is only ever touched by the
// thread that owns its vector.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
    const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ partial,
    long long rows, int D, int G) {
  extern __shared__ float acc[];
  __shared__ float red[32];
  const int nvec = D / VEC;
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  for (int i = threadIdx.x; i < groups * D; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  float* mine = acc + group * D;
  const float fd = static_cast<float>(D);
  for (long long base = static_cast<long long>(blockIdx.x) * groups; base < rows;
       base += static_cast<long long>(gridDim.x) * groups) {
    const long long row = base + group;
    const bool live = row < rows;
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float c = 0.f;  // sum_j g_j s_j x_j
    if (live) {
      for (int i = lane; i < nvec; i += G) {
        float xf[VEC], gf[VEC];
        load_vec<T, VEC>(xr, i, xf);
        load_vec<T, VEC>(gr, i, gf);
#pragma unroll
        for (int k = 0; k < VEC; ++k) c += __fmul_rn(gf[k], scale[i * VEC + k]) * xf[k];
      }
    }
    c = group_sum(c, G, red);
    if (!live) continue;
    const float r = rstd[row];
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    const float cd = __fdiv_rn(c, fd);
    T* dxr = dx + row * D;
    for (int i = lane; i < nvec; i += G) {
      float xf[VEC], gf[VEC], d[VEC];
      load_vec<T, VEC>(xr, i, xf);
      load_vec<T, VEC>(gr, i, gf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int col = i * VEC + k;
        const float gs = __fmul_rn(gf[k], scale[col]);
        d[k] = __fsub_rn(__fmul_rn(r, gs), __fmul_rn(__fmul_rn(xf[k], r3), cd));
        mine[col] = __fadd_rn(mine[col], __fmul_rn(__fmul_rn(gf[k], xf[k]), r));
      }
      store_vec<T, VEC>(dxr, i, d);
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < D; col += blockDim.x) {
    float t = 0.f;
    for (int g = 0; g < groups; ++g) t += acc[g * D + col];
    partial[static_cast<long long>(blockIdx.x) * D + col] = t;
  }
}

// dscale[c] = sum over the workspace's rows of partial[b, c], in row order.
__global__ void __launch_bounds__(256) rmsnorm_colsum_kernel(
    const float* __restrict__ partial, float* __restrict__ dscale, int nblocks, int D) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= D) return;
  float t = 0.f;
  for (int b = 0; b < nblocks; ++b) t += partial[static_cast<long long>(b) * D + col];
  dscale[col] = t;
}

struct Layout {
  int G;        // threads a row
  int threads;  // block size
};

// Rows of at most 32 vectors share warps (G the next power of two of the
// row's vectors); wider rows take a block of up to 1024 threads.
Layout layout_for(int nvec) {
  if (nvec <= 32) {
    int g = 1;
    while (g < nvec) g <<= 1;
    return {g, kWarpRowThreads};
  }
  int t = (nvec + 31) / 32 * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return {t, t};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

long long blocks_for(long long rows, int groups) {
  const long long want = (rows + groups - 1) / groups;
  const long long cap = 132LL * 16;  // the loop over rows covers the rest
  return want < cap ? want : cap;
}

template <typename T, int VEC>
int fwd_vec(const void* x, const void* scale, void* out, void* rstd, long long rows, int D,
            float eps, cudaStream_t s) {
  const Layout l = layout_for(D / VEC);
  const unsigned grid = static_cast<unsigned>(blocks_for(rows, l.threads / l.G));
  rmsnorm_fwd_kernel<T, VEC><<<grid, l.threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(rstd), rows, D, l.G, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int bwd_vec(const void* x, const void* scale, const void* dy, const void* rstd, void* dx,
            void* dscale, void* partial, long long rows, int D, int nblocks, cudaStream_t s) {
  const Layout l = layout_for(D / VEC);
  const size_t smem = sizeof(float) * static_cast<size_t>(l.threads / l.G) * D;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_bwd_kernel<T, VEC><<<nblocks, l.threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
      static_cast<const float*>(rstd), static_cast<T*>(dx), static_cast<float*>(partial),
      rows, D, l.G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_colsum_kernel<<<(D + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), nblocks, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
bool vectorizable(int D, std::initializer_list<const void*> ptrs) {
  if (D % kVec<T> != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

// x, out (rows, D) in dtype; scale (D,) fp32; rstd (rows,) fp32 or null.
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* out, void* rstd,
                                  int dtype, long long rows, int D, float eps,
                                  void* stream) {
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    if (vectorizable<float>(D, {x, out}))
      return fwd_vec<float, kVec<float>>(x, scale, out, rstd, rows, D, eps, s);
    return fwd_vec<float, 1>(x, scale, out, rstd, rows, D, eps, s);
  }
  if (dtype == DT_BF16) {
    if (vectorizable<__nv_bfloat16>(D, {x, out}))
      return fwd_vec<__nv_bfloat16, kVec<__nv_bfloat16>>(x, scale, out, rstd, rows, D, eps, s);
    return fwd_vec<__nv_bfloat16, 1>(x, scale, out, rstd, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, dy, dx (rows, D) in dtype; scale (D,), rstd (rows,), dscale (D,) fp32;
// partial an (nblocks, D) fp32 workspace, nblocks the backward's grid.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy,
                                  const void* rstd, void* dx, void* dscale, void* partial,
                                  int dtype, long long rows, int D, int nblocks,
                                  void* stream) {
  if (D < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    if (vectorizable<float>(D, {x, dy, dx}))
      return bwd_vec<float, kVec<float>>(x, scale, dy, rstd, dx, dscale, partial, rows, D,
                                         nblocks, s);
    return bwd_vec<float, 1>(x, scale, dy, rstd, dx, dscale, partial, rows, D, nblocks, s);
  }
  if (dtype == DT_BF16) {
    if (vectorizable<__nv_bfloat16>(D, {x, dy, dx}))
      return bwd_vec<__nv_bfloat16, kVec<__nv_bfloat16>>(x, scale, dy, rstd, dx, dscale,
                                                         partial, rows, D, nblocks, s);
    return bwd_vec<__nv_bfloat16, 1>(x, scale, dy, rstd, dx, dscale, partial, rows, D,
                                     nblocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
