// FlashAttention-2 style backward, written by hand for Hopper.
//
// The gradient of src/repro/kernels/flash_attention.py:_attn_kernel's
// function (the reference has no Pallas backward: its training attention is
// XLA's, differentiated by JAX). The forward is flash_attention.cu, which
// writes the log-sum-exp this file reads. Three launches for fp32, two for
// bf16:
//   1. D per (b, h, query row), fp32 (B, H, S). For fp32 inputs a kernel of
//      its own takes D = rowsum(dO * O). For bf16 the dQ kernel (2.) sums
//      D = rowsum(P * dP) over every key the row sees, in a first sweep over
//      the key tiles, as the tensor-core backward does
//      (flash_attention_bwd_tc.cu's header): O's bf16 rounding moves
//      rowsum(dO * O), and with it the small difference dP - D, where a
//      near-uniform softmax makes O nearly the same vector in every row;
//   2. dQ: one thread block per (b, h, 64-row query tile), looping over the
//      key tiles the forward visits (twice for bf16: D, then dQ);
//   3. dK, dV: one thread block per (b, kv head, 32-key tile). It loops over
//      the G query heads of its kv head and over the 64-row query tiles that
//      can see its keys, so GQA sums over the group inside the block and
//      needs no atomics. It reads the D of 1. or 2.
// Both recompute the scores as the forward does (same dot-product order,
// scale, softcap and masks) and P = exp(s - lse) from the forward's own
// log-sum-exp; then dP = dO V^T, dS = P (dP - D) * scale, times
// 1 - tanh^2(s / c) with a softcap c. Products run in fp32 on the CUDA
// cores and sums are fp32 whatever the input dtype. Deterministic: no
// atomics, every sum in a fixed order.
//
// Keys may be of another length Skv than the queries' S (an
// encoder-decoder's cross-attention), then without a mask: the dK/dV grid
// runs over Skv / 32 key tiles and each over all S queries, dQ over all Skv
// keys, and keys past Skv are masked as rows past S are.
//
// Bound: operations at long S. The gradient needs 5 products of 2 hd flops
// per unmasked pair (the scores again, dP, dV, dK, dQ); this version does 7
// (9 for bf16, whose dQ kernel sweeps twice), since the dK/dV and dQ kernels
// each recompute the scores and dP, against the forward's 2. Like the
// forward it uses CUDA cores, not the tensor cores. Layout: in the score loop a lane owns a
// key and a warp owns query rows (K and V staged transposed and padded, as
// in the forward); in the accumulation loops a lane owns output dims
// lane + 32 c and reads P / dS as float4 broadcasts.

#include <type_traits>

#include "flash_attention.cuh"

namespace {

constexpr int kDotWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kDotWarps * 32) flash_bwd_dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
    long long rows, int S, int H, int hd) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kDotWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // row = (b * S + s) * H + h
  const long long base = row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += load_f(o, base + d) * load_f(dout, base + d);
  acc = warp_sum(acc);
  const long long h = row % H, bs = row / H;
  const long long s = bs % S, b = bs / S;
  if (lane == 0) D[(b * H + h) * S + s] = acc;
}

// Score-side work shared by the two gradient kernels: for the kRows query
// rows r0.. of this warp (rows of the staged Q / dO tiles) and key lane,
// the forward's scores and dP, turned into P, dS and P * dP (the terms of
// D = rowsum(P dP); a caller that does not read them lets them go).
template <int NROWS>
__device__ __forceinline__ void bwd_scores(
    const float* Qs, const float* dOs, const float* Kt, const float* Vt, int hd,
    int r0, int lane, int qrow0, int kj, int S, int Skv, int causal, int window,
    float softcap, float scale, const float* Lrow, const float* Drow,
    float* p_out, float* ds_out, float* pdp_out) {
  float s[NROWS], dp[NROWS];
#pragma unroll
  for (int r = 0; r < NROWS; ++r) s[r] = dp[r] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    const float k0v = Kt[(d + 0) * kKtLd + lane];
    const float k1v = Kt[(d + 1) * kKtLd + lane];
    const float k2v = Kt[(d + 2) * kKtLd + lane];
    const float k3v = Kt[(d + 3) * kKtLd + lane];
    const float v0v = Vt[(d + 0) * kKtLd + lane];
    const float v1v = Vt[(d + 1) * kKtLd + lane];
    const float v2v = Vt[(d + 2) * kKtLd + lane];
    const float v3v = Vt[(d + 3) * kKtLd + lane];
#pragma unroll
    for (int r = 0; r < NROWS; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[(r0 + r) * hd + d]);
      s[r] += qv.x * k0v + qv.y * k1v + qv.z * k2v + qv.w * k3v;
      const float4 ov = *reinterpret_cast<const float4*>(&dOs[(r0 + r) * hd + d]);
      dp[r] += ov.x * v0v + ov.y * v1v + ov.z * v2v + ov.w * v3v;
    }
  }
#pragma unroll
  for (int r = 0; r < NROWS; ++r) {
    const int qi = qrow0 + r;
    float sc = s[r] * scale;
    float dcap = 1.f;
    if (softcap > 0.f) {
      const float t = tanhf(sc / softcap);
      sc = softcap * t;
      dcap = 1.f - t * t;
    }
    bool ok = kj < Skv && qi < S;
    if (causal) ok = ok && kj <= qi;
    if (window > 0) ok = ok && (qi - kj) < window;
    const float p = ok ? expf(sc - Lrow[r]) : 0.f;
    p_out[r] = p;
    ds_out[r] = p * (dp[r] - Drow[r]) * scale * dcap;
    pdp_out[r] = p * dp[r];
  }
}

// Stage rows [row0, row0 + nrows) of a (., ld)-strided tensor into a dense
// fp32 [nrows][hd] tile (zeros past S).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ld,
                                           int row0, int nrows, int hd, int S, int tid) {
  for (int e = tid; e < nrows * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const int i = row0 + r;
    dst[e] = i < S ? load_f(src, static_cast<long long>(i) * ld + d) : 0.f;
  }
}

// Stage keys [k0, k0 + kBK) transposed into a [hd][kKtLd] tile (zeros
// past Skv).
template <typename T>
__device__ __forceinline__ void stage_keys_t(float* dst, const T* src, long long ld,
                                             int k0, int hd, int Skv, int tid) {
  for (int e = tid; e < kBK * hd; e += kThreads) {
    const int j = e / hd, d = e - j * hd;
    const int kj = k0 + j;
    dst[d * kKtLd + j] = kj < Skv ? load_f(src, static_cast<long long>(kj) * ld + d) : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ Dg, T* __restrict__ dk, T* __restrict__ dv, int S,
    int Skv, int H, int Hkv, int hd, int causal, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                  // [hd][kKtLd]
  float* Vt = Kt + hd * kKtLd;       // [hd][kKtLd]
  float* Qs = Vt + hd * kKtLd;       // [kBQ][hd]
  float* dOs = Qs + kBQ * hd;        // [kBQ][hd]
  float* Ps = dOs + kBQ * hd;        // [kBQ][kBK]
  float* dSs = Ps + kBQ * kBK;       // [kBQ][kBK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x - (blockIdx.x / Hkv) * Hkv;
  const int k0 = blockIdx.y * kBK;  // low y = most query tiles: launched first
  const int G = H / Hkv;
  const long long q_ld = static_cast<long long>(H) * hd;
  const long long kv_ld = static_cast<long long>(Hkv) * hd;
  const long long kv_off = static_cast<long long>(b) * Skv * kv_ld + static_cast<long long>(hk) * hd;

  stage_keys_t(Kt, k + kv_off, kv_ld, k0, hd, Skv, tid);
  stage_keys_t(Vt, v + kv_off, kv_ld, k0, hd, Skv, tid);

  // this thread's accumulators: keys warp * 4 + jj, dims lane + 32 c
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[jj][c] = dv_acc[jj][c] = 0.f;

  // the query rows that can see a key of this tile
  int q_begin = causal ? k0 : 0;
  q_begin = (q_begin / kBQ) * kBQ;
  const int q_end = window > 0 ? min(S, k0 + kBK - 1 + window) : S;
  const int r0 = warp * kRows;

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const long long q_off = static_cast<long long>(b) * S * q_ld + static_cast<long long>(h) * hd;
    const float* lrow = lse + (static_cast<long long>(b) * H + h) * S;
    const float* drow = Dg + (static_cast<long long>(b) * H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // K/V staged, or the previous tile consumed
      stage_rows(Qs, q + q_off, q_ld, q0, kBQ, hd, S, tid);
      stage_rows(dOs, dout + q_off, q_ld, q0, kBQ, hd, S, tid);
      __syncthreads();

      float L[kRows], Dr[kRows], p[kRows], ds[kRows], pdp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int qi = q0 + r0 + r;
        L[r] = qi < S ? lrow[qi] : 0.f;
        Dr[r] = qi < S ? drow[qi] : 0.f;
      }
      bwd_scores<kRows>(Qs, dOs, Kt, Vt, hd, r0, lane, q0 + r0, k0 + lane, S, Skv, causal,
                        window, softcap, scale, L, Dr, p, ds, pdp);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        Ps[(r0 + r) * kBK + lane] = p[r];
        dSs[(r0 + r) * kBK + lane] = ds[r];
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows
      for (int i = 0; i < kBQ; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[i * kBK + warp * 4]);
        const float4 d4 = *reinterpret_cast<const float4*>(&dSs[i * kBK + warp * 4]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) {
            const float ov = dOs[i * hd + d];
            const float qv = Qs[i * hd + d];
            dv_acc[0][c] += p4.x * ov;
            dv_acc[1][c] += p4.y * ov;
            dv_acc[2][c] += p4.z * ov;
            dv_acc[3][c] += p4.w * ov;
            dk_acc[0][c] += d4.x * qv;
            dk_acc[1][c] += d4.y * qv;
            dk_acc[2][c] += d4.z * qv;
            dk_acc[3][c] += d4.w * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int kj = k0 + warp * 4 + jj;
    if (kj >= Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        const long long off = kv_off + static_cast<long long>(kj) * kv_ld + d;
        store_f(dk, off, dk_acc[jj][c]);
        store_f(dv, off, dv_acc[jj][c]);
      }
    }
  }
}

// D_FROM_P: sweep the key tiles twice, the first summing D = rowsum(P dP)
// (written to Dg for the dK/dV kernel), the second accumulating dQ; else
// one sweep that reads Dg.
template <typename T, int NC, bool D_FROM_P>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ Dg, T* __restrict__ dq, int S, int Skv, int H, int Hkv,
    int hd, int causal, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [kBQ][hd]
  float* dOs = Qs + kBQ * hd;        // [kBQ][hd]
  float* Kt = dOs + kBQ * hd;        // [hd][kKtLd]
  float* Vt = Kt + hd * kKtLd;       // [hd][kKtLd]
  float* Ws = Vt + hd * kKtLd;       // [kWarps][kRows][kBK]: dS per warp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int b = bh / H, h = bh - (bh / H) * H;
  const int hk = h / (H / Hkv);
  const long long q_ld = static_cast<long long>(H) * hd;
  const long long kv_ld = static_cast<long long>(Hkv) * hd;
  const long long q_off = static_cast<long long>(b) * S * q_ld + static_cast<long long>(h) * hd;
  const long long kv_off = static_cast<long long>(b) * Skv * kv_ld + static_cast<long long>(hk) * hd;

  stage_rows(Qs, q + q_off, q_ld, q0, kBQ, hd, S, tid);
  stage_rows(dOs, dout + q_off, q_ld, q0, kBQ, hd, S, tid);

  const int r0 = warp * kRows;
  float L[kRows], Dr[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    L[r] = qi < S ? lse[static_cast<long long>(bh) * S + qi] : 0.f;
    Dr[r] = !D_FROM_P && qi < S ? Dg[static_cast<long long>(bh) * S + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : Skv;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  float* W = Ws + warp * kRows * kBK;

  if (D_FROM_P) {  // sweep 1: each lane sums its keys' P dP, then the warp its lanes'
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.f;
    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
      __syncthreads();  // Q/dO staged, or the previous K/V tile consumed
      stage_keys_t(Kt, k + kv_off, kv_ld, k0, hd, Skv, tid);
      stage_keys_t(Vt, v + kv_off, kv_ld, k0, hd, Skv, tid);
      __syncthreads();
      float p[kRows], ds[kRows], pdp[kRows];
      bwd_scores<kRows>(Qs, dOs, Kt, Vt, hd, r0, lane, q0 + r0, k0 + lane, S, Skv, causal,
                        window, softcap, scale, L, Dr, p, ds, pdp);
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] += pdp[r];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      Dr[r] = warp_sum(part[r]);
      const int qi = q0 + r0 + r;
      if (lane == 0 && qi < S) Dg[static_cast<long long>(bh) * S + qi] = Dr[r];
    }
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q/dO staged, or the previous K/V tile consumed
    stage_keys_t(Kt, k + kv_off, kv_ld, k0, hd, Skv, tid);
    stage_keys_t(Vt, v + kv_off, kv_ld, k0, hd, Skv, tid);
    __syncthreads();

    float p[kRows], ds[kRows], pdp[kRows];
    bwd_scores<kRows>(Qs, dOs, Kt, Vt, hd, r0, lane, q0 + r0, k0 + lane, S, Skv, causal,
                      window, softcap, scale, L, Dr, p, ds, pdp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) W[r * kBK + lane] = ds[r];
    __syncwarp();

    // dQ += dS K: lane owns dims lane + 32 c (K^T rows are conflict-free)
    for (int j = 0; j < kBK; j += 4) {
      float kk[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          kk[jj][c] = d < hd ? Kt[d * kKtLd + j + jj] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 d4 = *reinterpret_cast<const float4*>(&W[r * kBK + j]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] += d4.x * kk[0][c] + d4.y * kk[1][c] + d4.z * kk[2][c] + d4.w * kk[3][c];
      }
    }
    __syncwarp();  // W is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store_f(dq + q_off, static_cast<long long>(qi) * q_ld + d, acc[r][c]);
    }
  }
}

template <typename T, int NC>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* D, void* dq, void* dk,
               void* dv, int B, int S, int Skv, int H, int Hkv, int hd, int causal,
               int window, float softcap, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  // fp32 takes D from the output; bf16 from P and dP, in the dQ kernel
  constexpr bool kDFromP = !std::is_same<T, float>::value;
  cudaError_t err;
  if (!kDFromP) {
    const long long rows = static_cast<long long>(B) * S * H;
    flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + kDotWarps - 1) / kDotWarps),
                              kDotWarps * 32, 0, stream>>>(
        static_cast<const T*>(o), dop, D, rows, S, H, hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // dQ first: for bf16 it writes the D that the dK/dV kernel reads
  const size_t smem_q = sizeof(float) * (2 * static_cast<size_t>(kBQ) * hd +
                                         2 * static_cast<size_t>(hd) * kKtLd +
                                         kWarps * kRows * kBK);
  auto q_kern = flash_bwd_dq_kernel<T, NC, kDFromP>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  q_kern<<<grid_q, kThreads, smem_q, stream>>>(
      qp, kp, vp, dop, lse, D, static_cast<T*>(dq), S, Skv, H, Hkv, hd, causal, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = sizeof(float) * (2 * static_cast<size_t>(hd) * kKtLd +
                                          2 * static_cast<size_t>(kBQ) * hd + 2 * kBQ * kBK);
  auto kv_kern = flash_bwd_dkdv_kernel<T, NC>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>(B * Hkv),
                     static_cast<unsigned>((Skv + kBK - 1) / kBK));
  kv_kern<<<grid_kv, kThreads, smem_kv, stream>>>(
      qp, kp, vp, dop, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), S, Skv, H, Hkv, hd,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_nc(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* D, void* dq, void* dk,
                  void* dv, int B, int S, int Skv, int H, int Hkv, int hd, int causal,
                  int window, float softcap, float scale, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
#define REPRO_FA_BWD_CASE(NC)                                                               \
  case NC:                                                                                  \
    return launch_bwd<T, NC>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, Skv, H, Hkv, hd,   \
                             causal, window, softcap, scale, stream);
    REPRO_FA_BWD_CASE(1)
    REPRO_FA_BWD_CASE(2)
    REPRO_FA_BWD_CASE(3)
    REPRO_FA_BWD_CASE(4)
    REPRO_FA_BWD_CASE(5)
    REPRO_FA_BWD_CASE(6)
    REPRO_FA_BWD_CASE(7)
    REPRO_FA_BWD_CASE(8)
#undef REPRO_FA_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout, o (B,S,H,hd), k/v (B,Skv,Hkv,hd) of `dtype`; lse fp32 (B,H,S)
// from the forward; d_scratch: fp32 (B, H, S) for D. Skv != S only with
// causal 0 and window 0. dq/dk/dv are written in full (every element, zeros
// where no query sees a key), in q's dtype. The output o is read for fp32
// only.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* d_scratch, void* dq, void* dk,
                                          void* dv, int dtype, int B, int S,
                                          int H, int Hkv, int hd, int Skv, int causal,
                                          int window, float softcap,
                                          float scale, int device, void* stream) {
  // bind the calling thread to the tensors' card (autograd's thread may
  // have no current context yet)
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  if (Skv < 1 || (Skv != S && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* D = static_cast<float*>(d_scratch);
  if (dtype == DT_F32)
    return launch_bwd_nc<float>(q, k, v, o, dout, l, D, dq, dk, dv, B, S, Skv, H, Hkv, hd,
                                causal, window, softcap, scale, s);
  if (dtype == DT_BF16)
    return launch_bwd_nc<__nv_bfloat16>(q, k, v, o, dout, l, D, dq, dk, dv, B, S, Skv, H,
                                        Hkv, hd, causal, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
