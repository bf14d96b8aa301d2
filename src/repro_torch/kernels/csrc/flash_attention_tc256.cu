// Flash-attention forward on Hopper's tensor cores at head_dim 256 (bf16),
// written by hand: RecurrentGemma-9B's local attention (MQA 16:1, window
// 2048) in its prefill.
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_kernel (launched by
// _flash_attention_pallas at :187) at head_dim 256, which the CUDA-core
// kernel (flash_attention.cu) ran until now. The same function as the
// other two forward kernels: for q (B,S,H,256) and k/v (B,Skv,Hkv,256),
//   o = softmax(mask(softcap(q k^T / 16))) v,
// query head h reading kv head h / (H / Hkv); keys past Skv, causal and
// window masked; with a non-null `lse`, each row's fp32 log-sum-exp in the
// scaled, softcapped natural-log domain, which the CUDA-core backward
// reads. Reached through flash_attention_fwd_tc_launch
// (flash_attention_tc.cu), which hands head_dim 256 to fwd_hd256 below.
//
// Bound: bytes at a serving prefill (B 4, S 512: q and o are 34 of its 36
// MB), operations from a few thousand keys on (4 hd H per visible pair);
// on the CUDA cores the products ran at about 9 TFLOP/s. Design
// (flash_tc.cuh has the layout contract):
// - P is rounded once to bf16 and O accumulates inside the tensor core:
//   before each tile's P V the running O is scaled by alpha in registers,
//   and the m64n256k16 wgmma adds P V onto it, as FlashAttention-2/3 and
//   SDPA do. flash_attention_tc.cu's three-term P with a separate P V
//   accumulator (chosen for training gradients, its header) does not fit
//   here: O alone is 128 fp32 registers a thread at hd 256, and a second
//   such accumulator and three sets of P fragments would spill. Training
//   RecurrentGemma runs this kernel too: its lse comes from the fp32
//   scores, so only O carries P's one rounding, and the CUDA-core backward
//   at hd 256 recomputes P from lse and takes D from P and dP, not from
//   O (flash_attention_bwd.cu). chip_smoke.py's train_tc_vs_plain holds a
//   bf16 training step through both against the plain attention's
//   autograd;
// - a block takes 64 query rows of two query heads that share a kv head,
//   one warpgroup each, both reading the same K / V stage, so the K / V
//   bytes that every query head re-reads from L2 are halved (RecurrentGemma
//   has one kv head for 16 query heads); where H / Hkv is odd, one head and
//   one warpgroup a block;
// - no producer warp: the block's threads are its consumer warpgroups, so
//   the launch bound of 256 threads leaves each up to 255 registers (O 128,
//   the score tile 32, P's fragments 16; ptxas takes 195). A warp or a
//   warpgroup beside them made ptxas budget 168 registers a thread (384
//   threads' worth), with or without setmaxnreg handing the consumers 240:
//   it spilled and serialized the wgmmas. Instead thread 0 loads Q and the
//   first two K / V tiles, and the last warpgroup to finish its products on
//   a stage (a shared counter) issues the TMA load of the tile two ahead
//   into it: K / V tiles of 64 keys through a 2-stage ring, Q 32 KB a head,
//   a K or V tile 32 KB, 192 KB with two heads. The two warpgroups drift
//   apart by up to a tile, so one's softmax runs beside the other's
//   products. Issuing the next tile's Q K^T ahead of this tile's softmax
//   inside a warpgroup (FlashAttention-3's order) ran slower here, and
//   turns between the two warpgroups' Q K^T (named barriers) or separate
//   K and V barriers no faster by more than a few percent;
// - S = Q K^T is 16 wgmma m64n64k16 with both operands in shared memory
//   (K-major); the online softmax runs on the fp32 scores in registers
//   (exp2 with scale * log2(e) folded in); P V is 4 wgmma m64n256k16 with
//   P from registers and V read MN-major through the transpose bit;
// - the heaviest causal tiles are launched first; wholly masked key tiles
//   are never visited, and masks are evaluated only on tiles that cross
//   the diagonal, the window's edge or S;
// - O / l is stored as bf16 from registers, the log-sum-exp as fp32.

#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr int kHD = 256;
constexpr int kBQ = 64;  // query rows of a head a block: one warpgroup
constexpr int kBK = 64;  // keys a K / V tile
constexpr int kStages = 2;

template <int NH>  // query heads a block, one warpgroup each
struct Tc256Layout {
  static constexpr int kQ = kBQ * kHD;   // values of one head's Q tile
  static constexpr int kKV = kBK * kHD;  // values of one K or V tile
  static constexpr size_t kBytes =
      2 * (NH * kQ + 2 * kStages * kKV) + 8 * (1 + kStages) + 4 * kStages + 1024;
};

template <int NH>
__global__ void __launch_bounds__(128 * NH, 1) flash_fwd_tc256_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ lse,
    int S, int Skv, int H, int Hkv, int causal, int window, float softcap, float scale) {
  using L = Tc256Layout<NH>;
  bf16* sQ = reinterpret_cast<bf16*>(smem_base());  // [NH][4 chunks][kBQ][64]
  bf16* sK = sQ + NH * L::kQ;                          // [kStages][4 chunks][kBK][64]
  bf16* sV = sK + kStages * L::kKV;                    // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * L::kKV);
  uint64_t* full = q_full + 1;                              // [kStages]
  int* released = reinterpret_cast<int*>(full + kStages);  // [kStages]

  const int per_b = H / NH;
  const int b = blockIdx.x / per_b;
  const int h0 = (blockIdx.x - b * per_b) * NH;  // NH heads of one kv head
  const int hk = h0 / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int k_end = causal ? min(S, q0 + kBQ) : Skv;
  const int k_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / kBK * kBK;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  // K and V of key tile j into stage j % kStages
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [=](int j) {
    const int s = j % kStages;
    mbar_expect_tx(&full[s], 4 * L::kKV);
    tma_tile<kHD>(sK + s * L::kKV, kBK, map_k, &full[s], hk, k_begin + j * kBK, b);
    tma_tile<kHD>(sV + s * L::kKV, kBK, map_v, &full[s], hk, k_begin + j * kBK, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, 2 * NH * L::kQ);
    for (int j = 0; j < NH; ++j) tma_tile<kHD>(sQ + j * L::kQ, kBQ, &tm_q, q_full, h0 + j, q0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  // warpgroup wg: head h0 + wg, this thread's rows r and r + 8
  const int wg = threadIdx.x >> 7;
  const int h = h0 + wg;
  const bf16* sQh = sQ + wg * L::kQ;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row = q0 + warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;  // no softcap: x * sl2
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;  // softcap: tanh(x cap_in) cap_out

  // After this warpgroup's products on tile i have completed: the last of
  // the NH warpgroups to be done with its stage loads tile i + kStages there.
  auto release = [&](int i) {
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if ((threadIdx.x & 127) == 0 && atomicAdd(&released[i % kStages], 1) % NH == NH - 1 &&
        i + kStages < n_tiles)
      load_kv(i + kStages);
  };

  float acc[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};
  float sc[kBK / 2];
  uint32_t pf[kBK / 16][4];

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = k_begin + i * kBK;
    mbar_wait(&full[s], (i / kStages) & 1);
    // S = Q K^T, both operands in shared memory
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk)
      wgmma_ss(sc, desc_k(sQh, kBQ, kk), desc_k(sK + s * L::kKV, kBK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in the log2 domain, masked where this tile needs it
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
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
    float lt[2] = {0.f, 0.f};  // this tile's sums of the fp32 P, then added to l
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - base[e >> 1]);
        sc[4 * j + e] = p;
        lt[e >> 1] += p;
      }
    }
    l[0] += lt[0];
    l[1] += lt[1];
    // O *= alpha, then O += bf16(P) V inside the tensor core
#pragma unroll
    for (int j = 0; j < kHD / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
    to_a_frags(sc, pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_tb(acc, pf[kk], desc_mn(sV + s * L::kKV, kBK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(pf);
    release(i);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l[r];
  }
  const long long ld = static_cast<long long>(H) * kHD;
  store_rows(o + static_cast<long long>(b) * S * ld + static_cast<long long>(h) * kHD, ld, row,
             S, acc, inv);
  if (lse != nullptr && (lane & 3) == 0) {
    const long long bh = static_cast<long long>(b) * H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      if (qi < S) lse[bh * S + qi] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int NH>
int launch_nh(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
              float* lse, int B, int S, int Skv, int H, int Hkv, int causal, int window,
              float softcap, float scale, cudaStream_t stream) {
  using L = Tc256Layout<NH>;
  auto kern = flash_fwd_tc256_kernel<NH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * (H / NH)), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  kern<<<grid, 128 * NH, L::kBytes, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, S, Skv, H,
                                               Hkv, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_tc::fwd_hd256(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int Skv, int H, int Hkv, int causal, int window, float softcap,
                        float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, B, S, H, kHD, kBQ);
  if (err == cudaSuccess) err = tensor_map(&tk, k, B, Skv, Hkv, kHD, kBK);
  if (err == cudaSuccess) err = tensor_map(&tv, v, B, Skv, Hkv, kHD, kBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((H / Hkv) % 2 == 0)  // two query heads of one kv head a block
    return launch_nh<2>(tq, tk, tv, o, lse, B, S, Skv, H, Hkv, causal, window, softcap, scale,
                        stream);
  return launch_nh<1>(tq, tk, tv, o, lse, B, S, Skv, H, Hkv, causal, window, softcap, scale,
                      stream);
}
