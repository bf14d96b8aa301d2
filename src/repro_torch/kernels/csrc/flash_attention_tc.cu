// Flash-attention forward on Hopper's tensor cores (bf16, head_dim 64, 112
// or 128), written by hand. Its entry point also takes head_dim 256, which
// flash_attention_tc256.cu computes with its own design.
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_kernel (launched by
// _flash_attention_pallas at :187), the TPU kernel of the prefill's and the
// training forward's attention. Its function is that of the CUDA-core
// kernel (flash_attention.cu), which keeps every other dtype and head_dim:
// for q (B,S,H,hd) and k/v (B,Skv,Hkv,hd),
//   o = softmax(mask(softcap(q k^T / sqrt(hd)))) v,
// query head h reading kv head h / (H / Hkv); keys past Skv, causal and
// window masked; with a non-null `lse`, each row's fp32 log-sum-exp in the
// scaled, softcapped natural-log domain, which the backward reads. Skv is S
// but for an encoder-decoder's cross-attention, which has no mask: its K /
// V maps span Skv rows, so a key tile past Skv reads zeros (masked at the
// edge, as keys past S are), and each query tile walks every key tile.
//
// Bound: operations at long S (4 S^2 hd H / 2 multiply-adds for causal),
// bytes at short S; either way the products must run on the tensor cores
// (989 bf16 TFLOP/s against 67 fp32 TFLOP/s on the CUDA cores, which bound
// the CUDA-core kernel). Design (kernels/csrc/flash_tc.cuh has the layout
// contract):
// - one thread block per (64-query tile, b * H), the heaviest causal tiles
//   launched first; 64 rows give one consumer warpgroup (4 warps) and fill
//   the card at the prefill (GPT-2 XL 200 blocks, Qwen3-1.7B 128);
// - a fifth warp is the producer: one thread issues TMA loads, Q once and
//   K / V tiles of BK keys through a 2-stage ring with full and empty
//   mbarriers, so the loads of the next tile overlap this tile's products;
//   TMA zero-fills positions past S, so any S >= 1 is taken;
// - head_dim 112 (Kimi-K2) runs the head_dim-128 instance on a tile padded
//   to 128 columns: the tensor maps span the real 112 columns, so the
//   second 64-column box of each row reads columns 112-127 past the map
//   and TMA fills them with zeros, as it fills rows past S. Zero columns
//   of Q and K add nothing to Q K^T (its k-steps stop at 112), zero
//   columns of V give output columns that are never stored, and the store
//   ends at column 111, where the next head's columns begin;
// - S = Q K^T is wgmma with both operands in shared memory (K-major); the
//   online softmax runs on the fp32 accumulator in registers (row max and
//   sum over 4 threads; exp2 with scale * log2(e) folded in); P goes to
//   bf16 A fragments in registers and O += P V is wgmma with V read
//   MN-major through the transpose bit;
// - P enters P V as three bf16 terms (hi, mid, lo: P to fp32 precision),
//   three products instead of one, so 4 products a tile, not 2. Rounded
//   once to bf16, as F.scaled_dot_product_attention rounds it, P's error
//   (2^-9 of each weight) reaches O and, through the layers above, the
//   training gradients: at initialization, where the softmax is
//   near-uniform, the query and key projections' gradients are small
//   differences that move by 1.9-2.0% (RMS) through SDPA against the plain
//   attention, by 1.0% through this kernel, and by 0.8% through the plain
//   attention with its keys summed in another fp32 order (chip_smoke.py
//   --flash-precision);
// - masks are evaluated only on tiles that cross the diagonal, the window
//   edge or S; tiles wholly masked are never visited;
// - O / l is stored as bf16 from registers, the log-sum-exp as fp32.

#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr int kBQ = 64;        // query rows per block: one warpgroup
constexpr int kThreads = 160;  // the consumer warpgroup and the producer warp
// Two blocks an SM, so at most 204 registers a thread, and the compiler
// spills a few hundred bytes: left alone it takes more registers and fits
// one block an SM, and the training forward (800 blocks) ran slower so.

// The tile's width in shared memory and in registers: head_dim rounded up
// to the 64-value TMA box (128 at head_dim 112).
template <int HD>
constexpr int kWidth = (HD + 63) / 64 * 64;

template <int HD, int BK>
struct FwdLayout {
  static constexpr int kQ = kBQ * kWidth<HD>;  // values of the Q tile
  static constexpr int kKV = BK * kWidth<HD>;  // values of one K or V tile
  static constexpr size_t kBytes = 2 * (kQ + 4 * kKV) + 8 * 8 + 1024;
};

template <int HD, int BK>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ lse,
    int S, int Skv, int H, int Hkv, int causal, int window, float softcap, float scale) {
  using L = FwdLayout<HD, BK>;
  constexpr int W = kWidth<HD>;
  bf16* sQ = reinterpret_cast<bf16*>(smem_base());
  bf16* sK = sQ + L::kQ;       // [2 stages][W/64 chunks][BK][64]
  bf16* sV = sK + 2 * L::kKV;  // the same
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + 2 * L::kKV);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;   // [2]
  uint64_t* empty = bars + 3;  // [2]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int k_end = causal ? min(S, q0 + kBQ) : Skv;
  const int k_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / BK * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_full, 2 * L::kQ);
      tma_tile<W>(sQ, kBQ, &tm_q, q_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(&empty[s], ((i >> 1) - 1) & 1);
        const int k0 = k_begin + i * BK;
        mbar_expect_tx(&full[s], 4 * L::kKV);
        tma_tile<W>(sK + s * L::kKV, BK, &tm_k, &full[s], hk, k0, b);
        tma_tile<W>(sV + s * L::kKV, BK, &tm_v, &full[s], hk, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup: this thread's rows r and r + 8 of the tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = q0 + warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;                   // no softcap: x * sl2
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;             // softcap: tanh(x cap_in) cap_out

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const int k0 = k_begin + i * BK;
    const bf16* tK = sK + s * L::kKV;
    const bf16* tV = sV + s * L::kKV;
    mbar_wait(&full[s], (i >> 1) & 1);

    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    wgmma_fence();
    // 7 k-steps at hd 112: the padding's would add zeros
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(sc, desc_k(sQ, kBQ, kk), desc_k(tK, BK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in the log2 domain, masked where this tile needs it
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        x = softcap > 0.f ? tanhf(x * cap_in) * cap_out : x * sl2;
        if (edge &&
            !visible(row + 8 * (e >> 1), k0 + 8 * j + col + (e & 1), S, Skv, causal, window))
          x = NEG_INF_F;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      // a row that sees no key yet keeps p = 0 and alpha = 0
      base[r] = mx[r] == NEG_INF_F ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    float lt[2] = {0.f, 0.f};  // this tile's sums, then added to l
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - base[e >> 1]);
        sc[4 * j + e] = p;
        lt[e >> 1] += p;
      }
    }
    l[0] += lt[0];
    l[1] += lt[1];
    // P as three bf16 terms, P V as three products (O sees P as an fp32
    // product would), into a zeroed accumulator whose sum is then added to
    // O in fp32, rounded to nearest, rather than accumulated onto the
    // running O inside the tensor core
    uint32_t ph[BK / 16][4], pm[BK / 16][4], pl[BK / 16][4];
    to_a_frags_split3(sc, ph, pm, pl);
    float pv[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) pv[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_tb(pv, ph[kk], desc_mn(tV, BK, kk));
      wgmma_rs_tb(pv, pm[kk], desc_mn(tV, BK, kk));
      wgmma_rs_tb(pv, pl[kk], desc_mn(tV, BK, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    fence_frags(ph);
    fence_frags(pm);
    fence_frags(pl);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * j + e] = __fmaf_rn(acc[4 * j + e], alpha[e >> 1], pv[4 * j + e]);
    }
    mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l[r];
  }
  // the head's HD / 8 groups of 8 columns; the padding is not stored
  const long long ld = static_cast<long long>(H) * HD;
  bf16* o_bh = o + static_cast<long long>(b) * S * ld + static_cast<long long>(h) * HD;
  store_rows<W / 2, HD / 8>(o_bh, ld, row, S, acc, inv);
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      if (qi < S) lse[static_cast<long long>(bh) * S + qi] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int HD, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int Skv, int H, int Hkv, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // over the real head_dim: a tile's columns past it read as zeros; the
  // K / V maps over the Skv keys: their rows past it too
  cudaError_t err = tensor_map(&tq, q, B, S, H, HD, kBQ);
  if (err == cudaSuccess) err = tensor_map(&tk, k, B, Skv, Hkv, HD, BK);
  if (err == cudaSuccess) err = tensor_map(&tv, v, B, Skv, Hkv, HD, BK);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = flash_fwd_tc_kernel<HD, BK>;
  constexpr size_t smem = FwdLayout<HD, BK>::kBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, S, Skv, H,
                                         Hkv, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B,S,H,hd), k/v (B,Skv,Hkv,hd), hd 64, 112, 128 or 256 (the last
// in flash_attention_tc256.cu), 16-byte aligned pointers on card `device`;
// o like q; lse fp32 (B,H,S) or null. Skv != S only with causal 0 and
// window 0.
extern "C" int flash_attention_fwd_tc_launch(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int B, int S, int H, int Hkv,
                                             int hd, int Skv, int causal, int window,
                                             float softcap, float scale, int device,
                                             void* stream) {
  // the calling thread may have no current context yet (autograd's own
  // thread, before its first CUDA work): bind it to the tensors' card
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (Skv < 1 || (Skv != S && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 64)
    return launch<64, 128>(q, k, v, o, l, B, S, Skv, H, Hkv, causal, window, softcap, scale, s);
  if (hd == 112)  // the head_dim-128 design on a tile padded to 128
    return launch<112, 64>(q, k, v, o, l, B, S, Skv, H, Hkv, causal, window, softcap, scale, s);
  if (hd == 128)
    return launch<128, 64>(q, k, v, o, l, B, S, Skv, H, Hkv, causal, window, softcap, scale, s);
  if (hd == 256)
    return flash_tc::fwd_hd256(q, k, v, o, l, B, S, Skv, H, Hkv, causal, window, softcap,
                               scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
