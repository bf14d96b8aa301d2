// FlashAttention-2 style forward, written by hand for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_kernel (launched by
// _flash_attention_pallas), the TPU kernel of the prefill's attention. The
// reference has no Pallas backward (its training attention is XLA's); the
// backward kernels (flash_attention_bwd.cu) give the port's training path a
// gradient through the same kernel (kernels/flash_attention.py:
// FlashAttentionFn).
//
// Computes, for q (B,S,H,hd) and k/v (B,Skv,Hkv,hd) in one float dtype,
//   o = softmax(mask(softcap(q k^T * 1/sqrt(hd)))) v      -> (B,S,H,hd)
// with an fp32 online softmax (m, l, acc), the query head h reading kv head
// h / (H / Hkv), and the masks of the reference kernel: keys past Skv,
// causal (k <= q), window (q - k < window). Skv equals S but for an
// encoder-decoder's cross-attention, which has no mask (the wrapper
// refuses Skv != S with a causal mask or a window). With a non-null `lse` the
// forward also writes each row's log-sum-exp, m + log(max(l, 1e-30)), in
// fp32 (B, H, S), in the same scaled, softcapped score domain; the backward
// recomputes P from it.
//
// Bound: operations at long S (4 S^2 hd H / 2 for causal), bytes at short
// S. This first version runs its products on the CUDA cores in fp32, not
// on the tensor cores, so it sits far below the bf16 tensor-core roofline;
// wgmma/TMA tiles are later work. Design: one thread block per (64-query
// tile, b*H); 8 warps own 8 query rows each. K/V tiles of 32 keys are
// staged in shared memory as fp32 (K transposed and padded, so both the
// lane-per-key score loop and the loads are free of bank conflicts). The
// score loop gives each lane one key and reads the query rows as float4
// broadcasts; the P.V loop gives each lane output dims lane + 32c and
// reads P as float4 broadcasts. Key tiles wholly above the causal diagonal
// or before the window are never visited, and the query tiles with the
// most work are launched first. Any S >= 1 is taken: rows past S and keys
// past Skv are masked here, not padded by the caller.

#include "flash_attention.cuh"

namespace {

constexpr int kBatch = 8;             // loads a thread issues before it waits

template <typename T, int NC>  // NC = ceil(hd / 32): output dims per lane
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int Skv, int H, int Hkv, int hd,
    int causal, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [kBQ][hd]
  float* Kt = Qs + kBQ * hd;        // [hd][kKtLd]
  float* Vs = Kt + hd * kKtLd;      // [kBK][hd]
  float* Ps = Vs + kBK * hd;        // [kWarps][kRows][kBK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int b = bh / H, h = bh - (bh / H) * H;
  const int hk = h / (H / Hkv);
  const long long q_ld = static_cast<long long>(H) * hd;    // per position
  const long long kv_ld = static_cast<long long>(Hkv) * hd;
  const T* qb = q + static_cast<long long>(b) * S * q_ld + static_cast<long long>(h) * hd;
  const T* kb = k + static_cast<long long>(b) * Skv * kv_ld + static_cast<long long>(hk) * hd;
  const T* vb = v + static_cast<long long>(b) * Skv * kv_ld + static_cast<long long>(hk) * hd;
  T* ob = o + static_cast<long long>(b) * S * q_ld + static_cast<long long>(h) * hd;

  // Tiles are staged kBatch elements per thread at a time: all loads of a
  // batch are issued before the first store, so they wait on memory once.
  for (int base = tid; base < kBQ * hd; base += kThreads * kBatch) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      const int r = e / hd, d = e - r * hd;
      const int qi = q0 + r;
      x[u] = (e < kBQ * hd && qi < S) ? load_f(qb, static_cast<long long>(qi) * q_ld + d) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      if (e < kBQ * hd) Qs[e] = x[u];
    }
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = NEG_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int r0 = warp * kRows;
  const int k_end = causal ? min(S, q0 + kBQ) : Skv;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  float* P = Ps + warp * kRows * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q loaded / previous K,V tile consumed
    for (int base = tid; base < kBK * hd; base += kThreads * kBatch) {
      float kx[kBatch], vx[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        const int j = e / hd, d = e - j * hd;
        const int kj = k0 + j;
        kx[u] = vx[u] = 0.f;
        if (e < kBK * hd && kj < Skv) {
          const long long off = static_cast<long long>(kj) * kv_ld + d;
          kx[u] = load_f(kb, off);
          vx[u] = load_f(vb, off);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        if (e < kBK * hd) {
          const int j = e / hd, d = e - j * hd;
          Kt[d * kKtLd + j] = kx[u];
          Vs[j * hd + d] = vx[u];
        }
      }
    }
    __syncthreads();

    // scores: lane = key, kRows query rows per warp
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      const float k0v = Kt[(d + 0) * kKtLd + lane];
      const float k1v = Kt[(d + 1) * kKtLd + lane];
      const float k2v = Kt[(d + 2) * kKtLd + lane];
      const float k3v = Kt[(d + 3) * kKtLd + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[(r0 + r) * hd + d]);
        s[r] += qv.x * k0v + qv.y * k1v + qv.z * k2v + qv.w * k3v;
      }
    }

    // online softmax, one row at a time across the warp
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r;
      float sc = s[r] * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      bool ok = kj < Skv;
      if (causal) ok = ok && kj <= qi;
      if (window > 0) ok = ok && (qi - kj) < window;
      sc = ok ? sc : NEG_INF_F;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      P[r * kBK + lane] = p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += P V: lane owns output dims lane + 32 c
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < hd ? Vs[(j + jj) * hd + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&P[r * kBK + j]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] += pv.x * vv[0][c] + pv.y * vv[1][c] + pv.z * vv[2][c] +
                       pv.w * vv[3][c];
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store_f(ob, static_cast<long long>(qi) * q_ld + d, acc[r][c] / denom);
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<long long>(bh) * S + qi] = m[r] + logf(denom);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Skv, int H, int Hkv, int hd, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ) * hd + static_cast<size_t>(hd) * kKtLd +
                       static_cast<size_t>(kBK) * hd + kWarps * kRows * kBK);
  auto kern = flash_fwd_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, Skv, H, Hkv, hd, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_nc(const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int S, int Skv, int H, int Hkv, int hd, int causal, int window,
              float softcap, float scale, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
#define REPRO_FA_CASE(NC) \
  case NC:                \
    return launch<T, NC>(q, k, v, o, lse, B, S, Skv, H, Hkv, hd, causal, window, softcap, scale, \
                         stream);
    REPRO_FA_CASE(1)
    REPRO_FA_CASE(2)
    REPRO_FA_CASE(3)
    REPRO_FA_CASE(4)
    REPRO_FA_CASE(5)
    REPRO_FA_CASE(6)
    REPRO_FA_CASE(7)
    REPRO_FA_CASE(8)
#undef REPRO_FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,Skv,Hkv,hd) of `dtype` on card `device`; o like q;
// lse fp32 (B,H,S) or null. Skv != S only with causal 0 and window 0.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int dtype, int B, int S, int H,
                                          int Hkv, int hd, int Skv, int causal,
                                          int window, float softcap,
                                          float scale, int device, void* stream) {
  // bind the calling thread to the tensors' card (autograd's thread may
  // have no current context yet)
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (Skv < 1 || (Skv != S && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == DT_F32)
    return launch_nc<float>(q, k, v, o, l, B, S, Skv, H, Hkv, hd, causal, window, softcap,
                            scale, s);
  if (dtype == DT_BF16)
    return launch_nc<__nv_bfloat16>(q, k, v, o, l, B, S, Skv, H, Hkv, hd, causal, window,
                                    softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
