// Flash-attention backward on Hopper's tensor cores (bf16, head_dim 64 or
// 128), written by hand.
//
// The gradient of src/repro/kernels/flash_attention.py:_attn_kernel's
// function (the reference has no Pallas backward: its training attention is
// XLA's, differentiated by JAX). The forward is flash_attention_tc.cu,
// whose log-sum-exp this file reads; every other dtype and head_dim keeps
// the CUDA-core backward (flash_attention_bwd.cu). Deterministic, no
// atomics, so two runs give the same bits. Two launches:
//   1. dQ: one block per (b, h, 64-row query tile) over the key tiles the
//      forward visits, twice. Sweep 1 recomputes S = Q K^T, P = exp(S -
//      lse) and dP = dO V^T and sums D = rowsum(P dP) in fp32, and writes
//      it, fp32 (B, H, S). Sweep 2 forms dS = P (dP - D) scale (times
//      1 - tanh^2 with a softcap) and accumulates dQ += dS K. D is taken
//      from P and dP, not as rowsum(dO O) from the bf16 output: where a
//      near-uniform softmax makes O nearly the same vector in every row
//      (a model at initialization), dP - D is a small difference, and O's
//      bf16 rounding error in D moves it; the CUDA-core backward, which
//      takes D so, moved GPT-2 XL's query-projection gradient by 1.7%
//      (RMS) against the plain attention (chip_smoke.py --flash-precision);
//   2. dK, dV: one block per (b, kv head, 64-key tile). K and V stay in
//      shared memory; the block loops over the G query heads of its kv head
//      and the query tiles that see its keys, with Q and dO (and the rows'
//      lse and D) loaded through a 2-stage ring. Per tile it recomputes
//      S^T = K Q^T, P^T and dP^T = V dO^T, forms dS^T, and accumulates
//      dV += P^T dO and dK += dS^T Q in fp32 registers. GQA sums over the
//      group inside the block.
// Keys may be of another length Skv than the queries' S (an
// encoder-decoder's cross-attention, Whisper's 448 tokens over 1 500
// frames), then without a mask: the K / V maps span Skv rows, the dK/dV
// grid runs over Skv / 64 key tiles and each of them over all S queries,
// the dQ sweeps over all Skv keys, and keys past Skv are masked on the
// edge tiles as rows past S are. lse and D keep S.
//
// Bound: operations at long S. The gradient needs 5 products of 2 hd flops
// per unmasked pair; this design does 9 (the scores and dP in each sweep),
// all of them on the tensor cores (989 bf16 TFLOP/s), where the CUDA-core
// backward ran 7 fp32 products on at most 67 TFLOP/s. Each
// kernel is built like the forward (flash_tc.cuh): a producer warp issues
// the TMA loads into a 2-stage ring with full and empty mbarriers, and one
// consumer warpgroup runs wgmma: the score-side products with both operands
// in shared memory (K-major), the accumulating products with P^T / dS^T /
// dS as bf16 A fragments straight from the score accumulator and the other
// operand read MN-major through the transpose bit. Masks are evaluated only
// on tiles that cross the diagonal, the window edge or S.

#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr int kThreads = 160;  // one consumer warpgroup and a producer warp
constexpr int kBK = 64;        // keys per dK/dV block and per dQ key tile
constexpr int kBQ = 64;        // query rows per dQ block and per dK/dV query tile

// P of one score element from its raw product x (lse2 = lse * log2(e)),
// and the softcap's derivative factor.
struct Prob {
  float p, dcap;
};
__device__ __forceinline__ Prob prob_of(float x, float lse2, float scale, float softcap) {
  x *= scale;
  float dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  return {exp2f(x * kLog2e - lse2), dcap};
}

// The score-side products of one tile: acc_a = A B^T and acc_b = C D^T,
// all four operands K-major (hd the reduction), waited for.
template <int HD, int NR>
__device__ __forceinline__ void two_products(float (&acc_a)[NR], const bf16* a, int a_rows,
                                             const bf16* b, float (&acc_b)[NR], const bf16* c,
                                             const bf16* d, int b_rows) {
#pragma unroll
  for (int j = 0; j < NR; ++j) acc_a[j] = acc_b[j] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(acc_a, desc_k(a, a_rows, kk), desc_k(b, b_rows, kk));
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(acc_b, desc_k(c, a_rows, kk), desc_k(d, b_rows, kk));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc_a);
  fence_regs(acc_b);
}

// ---------------------------------------------------------------------------
// 2. dK, dV
// ---------------------------------------------------------------------------

template <int HD>
struct KvLayout {
  static constexpr int kKV = kBK * HD;  // values of the K or V tile
  static constexpr int kQ = kBQ * HD;   // values of one Q or dO tile
  static constexpr size_t kBytes = 2 * (2 * kKV + 4 * kQ) + 4 * 4 * kBQ + 8 * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_tc_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ Dg, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int Skv, int H, int Hkv, int causal, int window,
    float softcap, float scale) {
  using L = KvLayout<HD>;
  bf16* sK = reinterpret_cast<bf16*>(smem_base());
  bf16* sV = sK + L::kKV;
  bf16* sQ = sV + L::kKV;       // [2 stages][HD/64 chunks][kBQ][64]
  bf16* sdO = sQ + 2 * L::kQ;   // the same
  float* sL = reinterpret_cast<float*>(sdO + 2 * L::kQ);  // [2][kBQ] lse * log2(e)
  float* sD = sL + 2 * kBQ;                                // [2][kBQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + 2 * kBQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;   // [2]
  uint64_t* empty = bars + 3;  // [2]

  const int b = blockIdx.x / Hkv, hk = blockIdx.x - b * Hkv;
  const int k0 = blockIdx.y * kBK;  // low y = most query tiles: launched first
  const int G = H / Hkv;
  const int q_begin = (causal ? k0 : 0) / kBQ * kBQ;
  const int q_end = window > 0 ? min(S, k0 + kBK - 1 + window) : S;
  const int nq = (q_end - q_begin + kBQ - 1) / kBQ;
  const int n_iter = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's bytes and the warp's lse / D stores
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 4 * L::kKV);
      tma_tile<HD>(sK, kBK, &tm_k, kv_full, hk, k0, b);
      tma_tile<HD>(sV, kBK, &tm_v, kv_full, hk, k0, b);
    }
    for (int i = 0; i < n_iter; ++i) {
      const int s = i & 1;
      if (i >= 2) mbar_wait(&empty[s], ((i >> 1) - 1) & 1);
      const int h = hk * G + i / nq;
      const int q0 = q_begin + (i % nq) * kBQ;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 4 * L::kQ);
        tma_tile<HD>(sQ + s * L::kQ, kBQ, &tm_q, &full[s], h, q0, b);
        tma_tile<HD>(sdO + s * L::kQ, kBQ, &tm_do, &full[s], h, q0, b);
      }
      const long long row0 = (static_cast<long long>(b) * H + h) * S;
      for (int r = lane; r < kBQ; r += 32) {
        const int qi = q0 + r;
        sL[s * kBQ + r] = qi < S ? lse[row0 + qi] * kLog2e : 0.f;
        sD[s * kBQ + r] = qi < S ? Dg[row0 + qi] : 0.f;
      }
      mbar_arrive(&full[s]);  // releases this lane's stores
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = k0 + warp * 16 + (lane >> 2);  // this thread's keys: key, key + 8
  const int col = 2 * (lane & 3);
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i & 1;
    const int q0 = q_begin + (i % nq) * kBQ;
    const bf16* tQ = sQ + s * L::kQ;
    const bf16* tdO = sdO + s * L::kQ;
    const float* tL = sL + s * kBQ;
    const float* tD = sD + s * kBQ;
    mbar_wait(&full[s], (i >> 1) & 1);

    float st[kBQ / 2], dpt[kBQ / 2];  // S^T = K Q^T, dP^T = V dO^T
    two_products<HD>(st, sK, kBK, tQ, dpt, sV, tdO, kBQ);

    const bool edge = q0 + kBQ > S || k0 + kBK > Skv || (causal && q0 < k0 + kBK - 1) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + col + (e & 1);
        Prob pr = prob_of(st[4 * j + e], tL[c], scale, softcap);
        if (edge && !visible(q0 + c, key + 8 * (e >> 1), S, Skv, causal, window)) pr.p = 0.f;
        st[4 * j + e] = pr.p;
        dpt[4 * j + e] = pr.p * (dpt[4 * j + e] - tD[c]) * scale * pr.dcap;
      }
    }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
    to_a_frags(st, pa);
    to_a_frags(dpt, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) wgmma_rs_tb(dva, pa[kk], desc_mn(tdO, kBQ, kk));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) wgmma_rs_tb(dka, da[kk], desc_mn(tQ, kBQ, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    fence_frags(pa);
    fence_frags(da);
    mbar_arrive(&empty[s]);
  }

  const long long ld = static_cast<long long>(Hkv) * HD;
  const long long off = static_cast<long long>(b) * Skv * ld + static_cast<long long>(hk) * HD;
  const float one[2] = {1.f, 1.f};
  store_rows(dk + off, ld, key, Skv, dka, one);
  store_rows(dv + off, ld, key, Skv, dva, one);
}

// ---------------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------------

template <int HD>
struct QLayout {
  static constexpr int kQ = kBQ * HD;
  static constexpr int kKV = kBK * HD;
  static constexpr size_t kBytes = 2 * (2 * kQ + 4 * kKV) + 8 * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_tc_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, float* __restrict__ Dg, bf16* __restrict__ dq, int S, int Skv,
    int H, int Hkv, int causal, int window, float softcap, float scale) {
  using L = QLayout<HD>;
  bf16* sQ = reinterpret_cast<bf16*>(smem_base());
  bf16* sdO = sQ + L::kQ;
  bf16* sK = sdO + L::kQ;      // [2 stages][HD/64 chunks][kBK][64]
  bf16* sV = sK + 2 * L::kKV;  // the same
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + 2 * L::kKV);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;   // [2]
  uint64_t* empty = bars + 3;  // [2]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int k_end = causal ? min(S, q0 + kBQ) : Skv;
  const int k_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kBK * kBK;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: the key tiles twice, one sweep each
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_full, 4 * L::kQ);
      tma_tile<HD>(sQ, kBQ, &tm_q, q_full, h, q0, b);
      tma_tile<HD>(sdO, kBQ, &tm_do, q_full, h, q0, b);
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(&empty[s], ((i >> 1) - 1) & 1);
        const int k0 = k_begin + (i % n_tiles) * kBK;
        mbar_expect_tx(&full[s], 4 * L::kKV);
        tma_tile<HD>(sK + s * L::kKV, kBK, &tm_k, &full[s], hk, k0, b);
        tma_tile<HD>(sV + s * L::kKV, kBK, &tm_v, &full[s], hk, k0, b);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row, row + 8
  const int col = 2 * (lane & 3);
  float lse2[2], Dr[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    lse2[r] = qi < S ? lse[static_cast<long long>(bh) * S + qi] * kLog2e : 0.f;
  }
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const int s = i & 1;
    const bool second = i >= n_tiles;  // sweep 1 sums D, sweep 2 accumulates dQ
    const int k0 = k_begin + (i % n_tiles) * kBK;
    const bf16* tK = sK + s * L::kKV;
    mbar_wait(&full[s], (i >> 1) & 1);
    float sc[kBK / 2], dp[kBK / 2];  // S = Q K^T, dP = dO V^T
    two_products<HD>(sc, sQ, kBQ, tK, dp, sdO, sV + s * L::kKV, kBK);

    const bool edge = q0 + kBQ > S || k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        Prob pr = prob_of(sc[4 * j + e], lse2[r], scale, softcap);
        if (edge && !visible(row + 8 * r, k0 + 8 * j + col + (e & 1), S, Skv, causal, window))
          pr.p = 0.f;
        if (second)
          sc[4 * j + e] = pr.p * (dp[4 * j + e] - Dr[r]) * scale * pr.dcap;
        else
          Dr[r] += pr.p * dp[4 * j + e];
      }
    }
    if (second) {
      uint32_t da[kBK / 16][4];
      to_a_frags(sc, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs_tb(dqa, da[kk], desc_mn(tK, kBK, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dqa);
      fence_frags(da);
    }
    mbar_arrive(&empty[s]);
    if (i == n_tiles - 1) {  // D = rowsum(P dP) over every key the row sees
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Dr[r] = quad_sum(Dr[r]);
        const int qi = row + 8 * r;
        if (qi < S && (lane & 3) == 0) Dg[static_cast<long long>(bh) * S + qi] = Dr[r];
      }
    }
  }

  const long long ld = static_cast<long long>(H) * HD;
  const float one[2] = {1.f, 1.f};
  store_rows(dq + static_cast<long long>(b) * S * ld + static_cast<long long>(h) * HD, ld, row,
             S, dqa, one);
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, float* D, void* dq, void* dk, void* dv, int B, int S, int Skv,
               int H, int Hkv, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  // maps: Q and dO boxes of kBQ rows over S, K and V boxes of kBK rows over Skv
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = tensor_map(&tq, q, B, S, H, HD, kBQ);
  if (err == cudaSuccess) err = tensor_map(&tdo, dout, B, S, H, HD, kBQ);
  if (err == cudaSuccess) err = tensor_map(&tk, k, B, Skv, Hkv, HD, kBK);
  if (err == cudaSuccess) err = tensor_map(&tv, v, B, Skv, Hkv, HD, kBK);
  if (err != cudaSuccess) return static_cast<int>(err);

  // dynamic shared memory above 48 KB
  auto kv_kern = flash_bwd_tc_dkdv_kernel<HD>;
  auto q_kern = flash_bwd_tc_dq_kernel<HD>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(KvLayout<HD>::kBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(QLayout<HD>::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // dQ first: its first sweep writes D, which the dK/dV kernel reads
  const dim3 grid_q(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  q_kern<<<grid_q, kThreads, QLayout<HD>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, D, static_cast<bf16*>(dq), S, Skv, H, Hkv, causal, window, softcap,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv(static_cast<unsigned>(B * Hkv),
                     static_cast<unsigned>((Skv + kBK - 1) / kBK));
  kv_kern<<<grid_kv, kThreads, KvLayout<HD>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, D, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Skv, H, Hkv,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, dout (B,S,H,hd), k/v (B,Skv,Hkv,hd), hd 64 or 128, 16-byte
// aligned; lse fp32 (B,H,S) from the forward; d_scratch fp32 (B,H,S), where
// D is written; all on card `device`. Skv != S only with causal 0 and
// window 0. dq/dk/dv are written in full (zeros where no query sees a key).
// The forward's output is not read.
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             void* d_scratch, void* dq, void* dk, void* dv,
                                             int B, int S, int H, int Hkv, int hd, int Skv,
                                             int causal, int window, float softcap, float scale,
                                             int device, void* stream) {
  // autograd runs the backward on its own thread, which may have no current
  // context before its first CUDA work: bind it to the tensors' card (the
  // first launch of a fresh thread was refused without)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Skv < 1 || (Skv != S && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* D = static_cast<float*>(d_scratch);
  if (hd == 64)
    return launch_bwd<64>(q, k, v, dout, l, D, dq, dk, dv, B, S, Skv, H, Hkv, causal, window,
                          softcap, scale, s);
  if (hd == 128)
    return launch_bwd<128>(q, k, v, dout, l, D, dq, dk, dv, B, S, Skv, H, Hkv, causal, window,
                           softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
