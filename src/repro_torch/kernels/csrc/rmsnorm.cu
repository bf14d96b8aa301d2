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
// bf16) for 4 operations; the backward reads x and dy and writes dx. Both
// reduce each row in fp32, 16-byte loads a thread (8 bf16 or 4 fp32 values)
// when D is a multiple of that width and the pointers are aligned, one value
// a thread otherwise.
//
// Forward, for rows of up to 256 vectors (the block, final and qk-norms of
// every RMSNorm model of the port): a fixed grid, a function of (rows, D)
// alone, of blocks that take contiguous runs of rows. A warp, or a
// power-of-two slice of one for rows of up to 32 vectors, takes whole rows;
// each lane holds its vectors of x in registers from the load to the store,
// so x is read once, and reduces with shuffles; with four or more blocks an
// SM, other warps' rows are in flight while one is reduced. The scale is
// read once a block (into shared memory, or a lane's share into registers).
// Other rows (wider, unaligned, a D that is not a whole number of vectors,
// or fewer than 1024 rows of more than 32 vectors, where one warp's serial
// work on a row is the latency: the wrapper's rule) take a block a row
// (rmsnorm_fwd_kernel): a row of at most 32
// vectors a power-of-two slice of a warp, a wider one a whole block reduced
// through shared memory, x read twice. Both add the squares in the same
// order, so y and rstd do not depend on the path or the launch.
//
// Backward, for rows of up to 256 vectors (D 2048 in bf16, 1024 in fp32):
// a fixed grid of one block an SM, a function of (rows, D) alone, takes
// contiguous runs of rows. Each warp, or each power-of-two slice of a warp
// for rows of up to 32 vectors, takes whole rows in turn; its lanes own
// fixed columns. Rows go in batches (one D-2048 row, or four qk-norm rows):
// a lane copies its vectors of x and dy into its own slots of a two-stage
// ring in shared memory with cp.async, so the next batch is in flight while
// this one is reduced, with shuffles and no block barrier, and its dx
// stored. Each row is read from device memory once. Each lane adds its
// dscale partial in registers across all its rows; at the end the groups
// of a warp add with shuffles and the warps in a fixed tree through shared
// memory into the block's row of an (nblocks, D) fp32 workspace, about 1 MB
// at D 2048. Rows wider than that keep a block a row (rmsnorm_bwd_kernel):
// two reads of x and dy, and dscale accumulators in shared memory.
//
// dscale is a sum over all rows, made without atomics so that it is the
// same in every run: the workspace's rows are summed per column by a second
// kernel with a block per 32 columns, 32 warps each adding a fixed,
// contiguous run of the rows, then the 32 runs in order; it is launched to
// start as the first kernel drains (programmatic dependent launch).
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

// Wide rows: dx for the rows of this block, and this block's row of the
// dscale workspace. Shared memory: ``groups * D`` floats, one dscale accumulator
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

// The backward's block: a ring of kBwdStages batches a warp, each batch
// kVecs vectors of x and of dy a lane (a whole row at least), 128 KB of
// shared memory a block: 8 warps for rows of 8 vectors a lane (a D-2048
// row), 16 for narrower rows (the qk-norm's: four rows a batch).
constexpr int kBwdStages = 2;  // batches in flight a warp
constexpr int kBwdMaxVpl = 8;  // rows of up to 32 * 8 vectors take this path
template <int VPL>
struct BwdShape {
  static constexpr int kVecs = VPL > 4 ? VPL : 4;
  static constexpr int kWarps = 64 / kVecs;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = kVecs / VPL;  // rows a group stages in one batch
};

// The scale of vector v from shared memory, 16 bytes a read where the
// vector is: a lane's 4-byte reads of its own 8 columns would fall 8 ways on
// the same banks.
template <int VEC>
__device__ __forceinline__ void scale_vec(const float* sc, int v, float (&s)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(sc + v * VEC)[j];
      s[4 * j] = t.x;
      s[4 * j + 1] = t.y;
      s[4 * j + 2] = t.z;
      s[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = sc[v * VEC + k];
  }
}

// VEC floats between registers and memory, 16 bytes at a time where VEC
// allows (the addresses are then 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      reinterpret_cast<float4*>(p)[j] = make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2],
                                                    f[4 * j + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = f[k];
  }
}

template <int VEC>
__device__ __forceinline__ void add_floats(float (&f)[VEC], const float* p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(p)[j];
      f[4 * j] = __fadd_rn(f[4 * j], t.x);
      f[4 * j + 1] = __fadd_rn(f[4 * j + 1], t.y);
      f[4 * j + 2] = __fadd_rn(f[4 * j + 2], t.z);
      f[4 * j + 3] = __fadd_rn(f[4 * j + 3], t.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = __fadd_rn(f[k], p[k]);
  }
}

// An asynchronous 16-byte copy from device memory into shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// One vector into this lane's staging slot: asynchronously where the
// vector is 16 bytes, a plain load and store on the scalar path.
template <typename T, int VEC>
__device__ __forceinline__ void stage_vec(Vec<T, VEC>* dst, const Vec<T, VEC>* src) {
  if constexpr (sizeof(Vec<T, VEC>) == 16) {
    cp_async16(dst, src);
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void staged_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until this thread's copies of all but the newest kBwdStages - 1
// committed batches have landed.
__device__ __forceinline__ void staged_wait_older() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kBwdStages - 1) : "memory");
}

__host__ __device__ constexpr int floats16(int n) { return (n + 3) & ~3; }

// The register-path forward's block: 4 warps, at least four blocks an SM.
// A lane holds RB rows of VPL vectors: one D-2048 row in bf16, four
// qk-norm rows.
constexpr int kFwdWarps = 4, kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdMaxD = 2048;  // 256 vectors of 8 bf16; 1024 in fp32
template <int VPL>
struct FwdShape {
  static constexpr int kRows = (VPL > 4 ? VPL : 4) / VPL;
};

// Rows of at most 32 * VPL vectors, each read from device memory once:
// lane `sub` of a row's 2^lpr_log2 lanes holds vectors sub, sub + lpr, ...
// (VPL of them) of x from its load to its store. Block b takes rows
// [b * rpb, (b + 1) * rpb); its groups take them in batches of RB rows
// (`batches` of them, from the host). The loads of a batch are issued
// together and the row is reduced with shuffles only: the one block
// barrier is for the scale, which the block reads once into shared memory,
// or, where a lane's share is at most 16 values (the qk-norm's), each lane
// into registers. The sum of squares is added in the block-a-row kernel's
// order (rmsnorm_fwd_kernel: each vector's squares in k order, an xor tree
// across the 32 lanes for each set of 32 vectors, the sets in order from
// 0; a row of at most 32 vectors is that kernel's slice of lpr lanes), so
// y and rstd are its bits.
template <typename T, int VEC, int VPL>
__global__ void __launch_bounds__(kFwdThreads, 4) rmsnorm_fwd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
    float* __restrict__ rstd, long long rows, int D, int lpr_log2, float eps, long long rpb,
    int batches) {
  constexpr int RB = FwdShape<VPL>::kRows;
  constexpr bool kScaleInRegs = VPL * VEC <= 16;
  using V = Vec<T, VEC>;
  __shared__ __align__(16) float sc[kScaleInRegs ? 4 : kFwdMaxD];
  float sr[kScaleInRegs ? VPL : 1][kScaleInRegs ? VEC : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = D / VEC;
  const int lpr = 1 << lpr_log2, rpw = 32 >> lpr_log2;
  const int sub = lane & (lpr - 1), ng = kFwdWarps * rpw;
  const int grp = warp * rpw + (lane >> lpr_log2);
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  const long long step = static_cast<long long>(RB) * ng;  // rows a batch covers
  auto row_of = [&](int j, int u) { return r0 + j * step + u * ng + grp; };

  // batch j's vectors of this lane; zeros past the rows and the row's end
  auto load = [&](V (&a)[RB][VPL], int j) {
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const long long row = row_of(j, u);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = sub + i * lpr;
        a[u][i] = row < r1 && v < nvec ? reinterpret_cast<const V*>(x + row * D)[v] : V{};
      }
    }
  };
  V a[RB][VPL];
  if (batches > 0) load(a, 0);  // the first rows are in flight while the scale is read
  const bool scale16 = D % 4 == 0 && (reinterpret_cast<uintptr_t>(scale) & 15) == 0;
  if constexpr (kScaleInRegs) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = sub + i * lpr < nvec ? sub + i * lpr : 0;
      if (scale16) {
#pragma unroll
        for (int j = 0; j < VEC / 4; ++j) {
          const float4 t = reinterpret_cast<const float4*>(scale + v * VEC)[j];
          sr[i][4 * j] = t.x;
          sr[i][4 * j + 1] = t.y;
          sr[i][4 * j + 2] = t.z;
          sr[i][4 * j + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) sr[i][k] = scale[v * VEC + k];
      }
    }
  } else {
    if (scale16) {
      for (int i = threadIdx.x; i < D / 4; i += kFwdThreads)
        reinterpret_cast<float4*>(sc)[i] = reinterpret_cast<const float4*>(scale)[i];
    } else {
      for (int i = threadIdx.x; i < D; i += kFwdThreads) sc[i] = scale[i];
    }
    __syncthreads();
  }
  // The trip count is the block's, so every lane reaches every shuffle.
  for (int j = 0; j < batches; ++j) {
    if (j > 0) load(a, j);
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      float ci[VPL];  // vector i's squares, in k order
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        ci[i] = 0.f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float f = load_f(a[u][i].v, k);
          ci[i] += f * f;
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)  // the VPL trees side by side
#pragma unroll
        for (int i = 0; i < VPL; ++i) ci[i] += __shfl_xor_sync(0xffffffffu, ci[i], o);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) ss += ci[i];
      const long long row = row_of(j, u);
      if (row >= r1) continue;
      const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(D)), eps));
      if (rstd != nullptr && sub == 0) rstd[row] = r;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = sub + i * lpr;
        if (v >= nvec) continue;
        float sv[VEC];
        if constexpr (kScaleInRegs) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) sv[k] = sr[i][k];
        } else {
          scale_vec<VEC>(sc, v, sv);
        }
        V o;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          store_f(o.v, k, __fmul_rn(__fmul_rn(reload_f(a[u][i].v, k), r), sv[k]));
        reinterpret_cast<V*>(out + row * D)[v] = o;
      }
    }
  }
}

// Rows of at most 32 * VPL vectors: lane `sub` of a row's 2^lpr_log2 lanes
// owns vectors sub, sub + lpr, ... (VPL of them) and adds their dscale
// partial in registers. Block b takes rows [b * rpb, (b + 1) * rpb); its
// groups take them in batches of RB rows each. A lane copies its vectors of
// x and dy for a batch into its own slots of the warp's ring, so batch
// j + 1 is in flight while batch j is reduced and its dx stored. Only
// the lane that staged a slot reads it, so no barrier is needed between
// warps or lanes. Shared memory: the scale, then the warps' rings, which
// the final merge reuses as kBwdWarps / 2 rows of D floats.
template <typename T, int VEC, int VPL>
__global__ void __launch_bounds__(BwdShape<VPL>::kThreads, 1) rmsnorm_bwd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
    const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ partial,
    long long rows, int D, int lpr_log2) {
  constexpr int kBwdWarps = BwdShape<VPL>::kWarps, kBwdThreads = BwdShape<VPL>::kThreads;
  constexpr int RB = BwdShape<VPL>::kRows;
  constexpr int kSlots = 2 * BwdShape<VPL>::kVecs * 32;  // [x, dy][RB][VPL][32 lanes]
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) float sh[];
  float* sc = sh;                  // [D]
  float* buf = sh + floats16(D);  // the rings, then the merge rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V* ring = reinterpret_cast<V*>(buf) + warp * kBwdStages * kSlots;
  const int nvec = D / VEC;
  const int lpr = 1 << lpr_log2, rpw = 32 >> lpr_log2;
  const int sub = lane & (lpr - 1), ng = kBwdWarps * rpw;
  const int grp = warp * rpw + (lane >> lpr_log2);
  const long long rpb = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  const long long step = static_cast<long long>(RB) * ng;  // rows a batch covers
  const int batches = r1 > r0 ? static_cast<int>((r1 - r0 + step - 1) / step) : 0;
  auto row_of = [&](int j, int u) { return r0 + j * step + u * ng + grp; };
  const float fd = static_cast<float>(D);

  // batch j's rows of this group into ring stage j % kBwdStages
  auto issue = [&](int j) {
    V* st = ring + (j % kBwdStages) * kSlots;
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const long long row = row_of(j, u);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = sub + i * lpr;
        if (j < batches && row < r1 && v < nvec) {
          stage_vec(st + (u * VPL + i) * 32 + lane, reinterpret_cast<const V*>(x + row * D) + v);
          stage_vec(st + ((RB + u) * VPL + i) * 32 + lane,
                    reinterpret_cast<const V*>(dy + row * D) + v);
        }
      }
    }
    staged_commit();
  };
  // the scale first, so it lands ahead of the rows; then two batches
  const bool scale_async = D % 4 == 0 && (reinterpret_cast<uintptr_t>(scale) & 15) == 0;
  if (scale_async) {
    for (int i = threadIdx.x; i < D / 4; i += kBwdThreads)
      cp_async16(reinterpret_cast<float4*>(sc) + i, reinterpret_cast<const float4*>(scale) + i);
  }
  staged_commit();
#pragma unroll
  for (int j = 0; j < kBwdStages; ++j) issue(j);
  if (!scale_async)
    for (int i = threadIdx.x; i < D; i += kBwdThreads) sc[i] = scale[i];

  float ds[VPL][VEC];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) ds[i][k] = 0.f;

  // each batch's rstd, loaded a batch ahead
  auto rstd_of = [&](int j, float (&r)[RB]) {
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const long long row = row_of(j, u);
      r[u] = j < batches && row < r1 ? rstd[row] : 0.f;
    }
  };
  float r_next[RB];
  rstd_of(0, r_next);

  // The trip count is the block's, so every lane reaches every shuffle.
  for (int j = 0; j < batches; ++j) {
    const V* st = ring + (j % kBwdStages) * kSlots;
    float r[RB];
    bool live[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      r[u] = r_next[u];
      live[u] = row_of(j, u) < r1;
    }
    rstd_of(j + 1, r_next);
    staged_wait_older();  // the scale and batch j have landed; j + 1 may be in flight
    if (j == 0) __syncthreads();  // every thread's share of the scale
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      // c = sum_j g_j s_j x_j, added in group_sum's order for a block a row
      // (rmsnorm_bwd_kernel), so dx is the same bits at every width: each
      // vector's columns in order, each set of 32 vectors (vector i of
      // every lane) in an xor tree, the sets in order from 0
      float xf[VPL][VEC], gf[VPL][VEC];  // the row, unpacked once for both passes
      float ci[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = sub + i * lpr;
        const bool mine = live[u] && v < nvec;
        const V xv = mine ? st[(u * VPL + i) * 32 + lane] : V{};
        const V gv = mine ? st[((RB + u) * VPL + i) * 32 + lane] : V{};
        float sv[VEC];
        scale_vec<VEC>(sc, mine ? v : 0, sv);
        ci[i] = 0.f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          xf[i][k] = load_f(xv.v, k);
          gf[i][k] = load_f(gv.v, k);
          ci[i] += __fmul_rn(gf[i][k], sv[k]) * xf[i][k];
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)  // the VPL trees side by side
#pragma unroll
        for (int i = 0; i < VPL; ++i) ci[i] += __shfl_xor_sync(0xffffffffu, ci[i], o);
      float c = VPL == 1 ? ci[0] : 0.f + ci[0];
#pragma unroll
      for (int i = 1; i < VPL; ++i) c += ci[i];
      if (!live[u]) continue;
      const long long row = row_of(j, u);
      const float r3 = __fmul_rn(__fmul_rn(r[u], r[u]), r[u]);
      const float cd = __fdiv_rn(c, fd);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = sub + i * lpr;
        if (v >= nvec) continue;
        float sv[VEC];
        scale_vec<VEC>(sc, v, sv);
        V out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float gs = __fmul_rn(gf[i][k], sv[k]);
          store_f(out.v, k, __fsub_rn(__fmul_rn(r[u], gs), __fmul_rn(__fmul_rn(xf[i][k], r3), cd)));
          ds[i][k] = __fadd_rn(ds[i][k], __fmul_rn(__fmul_rn(gf[i][k], xf[i][k]), r[u]));
        }
        reinterpret_cast<V*>(dx + row * D)[v] = out;
      }
    }
    issue(j + kBwdStages);  // into the stage just read (only this lane reads its slots)
  }

  griddep_launch_dependents();  // the column sum may be scheduled; it waits for this grid
  // the warp's groups add with shuffles; then the upper half of the warps
  // into the lower, halving again down to warp 0, through shared memory
  for (int o = lpr; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        ds[i][k] = __fadd_rn(ds[i][k], __shfl_xor_sync(0xffffffffu, ds[i][k], o));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int half = kBwdWarps / 2; half > 0; half >>= 1) {
    __syncthreads();  // the rings, then the previous round, are consumed
    if (warp >= half && warp < 2 * half && lane < lpr) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = sub + i * lpr;
        if (v < nvec) store_floats<VEC>(buf + (warp - half) * D + v * VEC, ds[i]);
      }
    }
    __syncthreads();
    if (warp < half && lane < lpr) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = sub + i * lpr;
        if (v < nvec) add_floats<VEC>(ds[i], buf + warp * D + v * VEC);
      }
    }
  }
  if (warp == 0 && lane < lpr) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = sub + i * lpr;
      if (v < nvec) store_floats<VEC>(partial + static_cast<long long>(blockIdx.x) * D + v * VEC,
                                      ds[i]);
    }
  }
}

constexpr int kColTile = 32, kColRuns = 32;

// dscale[c] = sum over the workspace's rows of partial[b, c]: warp w of a
// block adds run w of the rows (contiguous, in order), then warp 0 adds the
// runs in order.
__global__ void __launch_bounds__(kColTile * kColRuns) rmsnorm_colsum_kernel(
    const float* __restrict__ partial, float* __restrict__ dscale, int nblocks, int D) {
  __shared__ float run[kColRuns][kColTile];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = blockIdx.x * kColTile + lane;
  const int per = (nblocks + kColRuns - 1) / kColRuns;
  griddep_wait();  // the workspace is the previous kernel's
  const int b1 = min(nblocks, (w + 1) * per);
  float t = 0.f;
  if (col < D)
    for (int b = w * per; b < b1; ++b) t += partial[static_cast<long long>(b) * D + col];
  run[w][lane] = t;
  __syncthreads();
  if (w == 0 && col < D) {
    float s = 0.f;
    for (int i = 0; i < kColRuns; ++i) s += run[i][lane];
    dscale[col] = s;
  }
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

// The register path: lpr lanes of VPL vectors a row, nblocks blocks (the
// wrapper's fwd_blocks), each a contiguous run of rows in whole batches.
template <typename T, int VEC, int VPL>
int fwd_rows_vpl(const void* x, const void* scale, void* out, void* rstd, long long rows, int D,
                 float eps, int nblocks, int lpr_log2, cudaStream_t s) {
  const long long rpb = (rows + nblocks - 1) / nblocks;
  const long long step = static_cast<long long>(FwdShape<VPL>::kRows) * kFwdWarps *
                         (32 >> lpr_log2);
  const int batches = static_cast<int>((rpb + step - 1) / step);
  rmsnorm_fwd_rows_kernel<T, VEC, VPL><<<nblocks, kFwdThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(rstd), rows, D, lpr_log2, eps, rpb, batches);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int fwd_rows(const void* x, const void* scale, void* out, void* rstd, long long rows, int D,
             float eps, int nblocks, cudaStream_t s) {
  const int nvec = D / VEC;
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < nvec && lpr_log2 < 5) ++lpr_log2;
  const int vpl = (nvec + 31) / 32;
  const auto launch = vpl <= 1   ? fwd_rows_vpl<T, VEC, 1>
                      : vpl <= 2 ? fwd_rows_vpl<T, VEC, 2>
                      : vpl <= 4 ? fwd_rows_vpl<T, VEC, 4>
                                 : fwd_rows_vpl<T, VEC, 8>;
  return launch(x, scale, out, rstd, rows, D, eps, nblocks, lpr_log2, s);
}

int colsum(const void* partial, void* dscale, int nblocks, int D, cudaStream_t s) {
  return static_cast<int>(launch_dependent(
      rmsnorm_colsum_kernel, dim3((D + kColTile - 1) / kColTile), dim3(kColTile * kColRuns), 0,
      s, static_cast<const float*>(partial), static_cast<float*>(dscale), nblocks, D));
}

// The backward's shared memory: the scale, then the larger of the staging
// areas and the merge rows (D <= 2048 in bf16: 8 + 128 KB).
template <typename T, int VEC, int VPL>
size_t bwd_rows_smem(int D) {
  const size_t stage =
      sizeof(Vec<T, VEC>) * 2 * BwdShape<VPL>::kVecs * BwdShape<VPL>::kWarps * kBwdStages * 32;
  const size_t merge = sizeof(float) * BwdShape<VPL>::kWarps / 2 * static_cast<size_t>(D);
  return sizeof(float) * floats16(D) + (stage > merge ? stage : merge);
}

template <typename T, int VEC, int VPL>
int bwd_rows(const void* x, const void* scale, const void* dy, const void* rstd, void* dx,
             void* partial, long long rows, int D, int nblocks, int lpr_log2, cudaStream_t s) {
  // once per instantiation: room for the widest row the register path takes
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      rmsnorm_bwd_rows_kernel<T, VEC, VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_rows_smem<T, VEC, VPL>(32 * VPL * VEC)));
  if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  const size_t smem = bwd_rows_smem<T, VEC, VPL>(D);
  rmsnorm_bwd_rows_kernel<T, VEC, VPL><<<nblocks, BwdShape<VPL>::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
      static_cast<const float*>(rstd), static_cast<T*>(dx), static_cast<float*>(partial), rows,
      D, lpr_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int bwd_vec(const void* x, const void* scale, const void* dy, const void* rstd, void* dx,
            void* dscale, void* partial, long long rows, int D, int nblocks, cudaStream_t s) {
  const int nvec = D / VEC;
  int err;
  if (nvec <= 32 * kBwdMaxVpl) {  // the register path: lpr lanes of VPL vectors a row
    int lpr_log2 = 0;
    while ((1 << lpr_log2) < nvec && lpr_log2 < 5) ++lpr_log2;
    const int vpl = (nvec + 31) / 32;
    const auto launch = vpl <= 1   ? bwd_rows<T, VEC, 1>
                        : vpl <= 2 ? bwd_rows<T, VEC, 2>
                        : vpl <= 4 ? bwd_rows<T, VEC, 4>
                                   : bwd_rows<T, VEC, 8>;
    err = launch(x, scale, dy, rstd, dx, partial, rows, D, nblocks, lpr_log2, s);
  } else {  // a block a row
    const Layout l = layout_for(nvec);
    const size_t smem = sizeof(float) * static_cast<size_t>(l.threads / l.G) * D;
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    rmsnorm_bwd_kernel<T, VEC><<<nblocks, l.threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
        static_cast<const float*>(rstd), static_cast<T*>(dx), static_cast<float*>(partial),
        rows, D, l.G);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  return colsum(partial, dscale, nblocks, D, s);
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

// The register path: x, out (rows, D) in dtype, 16-byte aligned, D a whole
// number of 16-byte vectors and at most kFwdMaxD values (256 vectors);
// scale (D,) fp32; rstd (rows,) fp32 or null; nblocks the forward's grid;
// all on card `device`. Any other shape returns cudaErrorInvalidValue (the
// wrapper routes it to rmsnorm_fwd_rowblock_launch).
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* out, void* rstd,
                                  int dtype, long long rows, int D, float eps, int nblocks,
                                  int device, void* stream) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (D < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32 && vectorizable<float>(D, {x, out}) && D <= kFwdMaxD / 2)
    return fwd_rows<float, kVec<float>>(x, scale, out, rstd, rows, D, eps, nblocks, s);
  if (dtype == DT_BF16 && vectorizable<__nv_bfloat16>(D, {x, out}) && D <= kFwdMaxD)
    return fwd_rows<__nv_bfloat16, kVec<__nv_bfloat16>>(x, scale, out, rstd, rows, D, eps,
                                                        nblocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A block a row (rmsnorm_fwd_kernel) at any shape: x, out (rows, D) in
// dtype; scale (D,) fp32; rstd (rows,) fp32 or null; all on card `device`.
// The wrapper takes it for rows the register path does not; chip_smoke.py
// holds the register path's bits against it.
extern "C" int rmsnorm_fwd_rowblock_launch(const void* x, const void* scale, void* out,
                                           void* rstd, int dtype, long long rows, int D,
                                           float eps, int device, void* stream) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
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
// partial an (nblocks, D) fp32 workspace, nblocks the backward's grid; all
// on card `device`.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy,
                                  const void* rstd, void* dx, void* dscale, void* partial,
                                  int dtype, long long rows, int D, int nblocks, int device,
                                  void* stream) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
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
