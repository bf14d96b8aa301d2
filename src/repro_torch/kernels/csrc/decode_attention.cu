// Paged single-query decode attention, written by hand for Hopper.
//
// Replaces: src/repro/kernels/decode_attention.py:_decode_kernel (launched
// by _paged_decode_pallas), the TPU kernel every decode step runs once per
// layer.
//
// q (B,H,hd); pools (N,bs,Hkv,hd) in fp32, bf16 or int8 with fp32 scales
// (N,bs,Hkv) per (slot, kv head); block_tables (B,T) int32; context_lens
// (B,) int32. Position p of sequence b lives in block block_tables[b, p/bs]
// slot p % bs. Output (B,H,hd) in q's dtype:
//   softmax over p < cl (and p >= cl - window) of softcap(q.k * 1/sqrt(hd))
// applied to v, with an fp32 online softmax; cl == 0 gives zeros. Negative
// table entries are clamped to block 0, as the reference does; they only
// ever belong to masked positions.
//
// Bound: bytes. The work is reading each live position's K and V once
// (about 4 G flops per 2 hd bytes of bf16 pool). Design: one thread block
// per (kv head, sequence), so a block serves the G query heads of its kv
// head and reads their shared K/V once. The block walks the live positions
// in chunks of 32, loading each position's block id from the table itself
// (the TPU's scalar prefetch), and dequantizes int8 rows with their scale as
// it stages the chunk in shared memory (K transposed and padded). One warp
// per query head then takes one position per lane for the scores and the
// online softmax, and all threads update the fp32 accumulators in shared
// memory. Chunks before the window are never visited. Any block size and
// any G work, because chunks are counted in positions, not in blocks.
// Split-K over the context and TMA loads are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;          // positions per chunk: one per lane
constexpr int kKtLd = kChunk + 1;   // padded row of the transposed K chunk
constexpr int kBatch = 8;           // loads a thread issues before it waits

// Query rows and K rows are padded to a multiple of 4 dims (zeros), so the
// score loop reads whole float4s for any head_dim.
__host__ __device__ inline int padded_hd(int hd) { return (hd + 3) & ~3; }

size_t smem_bytes(int G, int hd) {
  const int qld = padded_hd(hd);
  const size_t floats = static_cast<size_t>(G) * qld        // Qs
                        + static_cast<size_t>(qld) * kKtLd  // Kt
                        + static_cast<size_t>(kChunk) * hd // Vs
                        + static_cast<size_t>(G) * kChunk  // Ps
                        + static_cast<size_t>(G) * hd      // Acc
                        + 3 * static_cast<size_t>(G);      // m, l, alpha
  return kChunk * sizeof(long long) + floats * sizeof(float);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ cls, TQ* __restrict__ out, int H, int Hkv, int hd,
    int bs, int T, int window, float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  // pool row (block * bs + slot) of each position of the chunk, -1 = masked
  long long* Row = reinterpret_cast<long long*>(smem_raw);
  const int qld = padded_hd(hd);
  float* Qs = reinterpret_cast<float*>(smem_raw + kChunk * sizeof(long long));  // [G][qld]
  float* Kt = Qs + G * qld;         // [qld][kKtLd]
  float* Vs = Kt + qld * kKtLd;     // [kChunk][hd]
  float* Ps = Vs + kChunk * hd;     // [G][kChunk]
  float* Acc = Ps + G * kChunk;     // [G][hd]
  float* Ms = Acc + G * hd;         // [G]
  float* Ls = Ms + G;               // [G]
  float* Al = Ls + G;               // [G]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = cls[b];
  const long long kv_ld = static_cast<long long>(Hkv) * hd;  // per pool slot
  const long long q_off = (static_cast<long long>(b) * H + static_cast<long long>(hk) * G) * hd;

  for (int e = tid; e < G * qld; e += kThreads) {
    const int g = e / qld, d = e - g * qld;
    Qs[e] = d < hd ? load_f(q, q_off + static_cast<long long>(g) * hd + d) : 0.f;
  }
  for (int e = tid; e < (qld - hd) * kKtLd; e += kThreads) Kt[hd * kKtLd + e] = 0.f;
  for (int e = tid; e < G * hd; e += kThreads) Acc[e] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = NEG_INF_F;
    Ls[g] = 0.f;
  }

  const int p_lo = window > 0 ? max(0, cl - window) : 0;
  for (int p0 = p_lo; p0 < cl; p0 += kChunk) {
    __syncthreads();  // previous chunk consumed (Qs, state initialized)
    if (tid < kChunk) {
      const int p = p0 + tid;
      long long row = -1;
      if (p < cl) {
        const int blk = max(tables[static_cast<long long>(b) * T + p / bs], 0);
        row = static_cast<long long>(blk) * bs + p % bs;
      }
      Row[tid] = row;
    }
    __syncthreads();
    // stage kBatch elements per thread at a time: every load of a batch is
    // issued before the first store, so the batch waits on memory once
    for (int base = tid; base < kChunk * hd; base += kThreads * kBatch) {
      float kx[kBatch], vx[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        const int j = e / hd, d = e - j * hd;
        kx[u] = vx[u] = 0.f;
        const long long row = e < kChunk * hd ? Row[j] : -1;
        if (row >= 0) {
          const long long off = row * kv_ld + static_cast<long long>(hk) * hd + d;
          kx[u] = load_f(kp, off);
          vx[u] = load_f(vp, off);
          if (ksc != nullptr) {
            const long long so = row * Hkv + hk;
            kx[u] *= ksc[so];
            vx[u] *= vsc[so];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        if (e < kChunk * hd) {
          const int j = e / hd, d = e - j * hd;
          Kt[d * kKtLd + j] = kx[u];
          Vs[j * hd + d] = vx[u];
        }
      }
    }
    __syncthreads();

    // scores and online softmax: one warp per query head, lane = position
    const bool ok = p0 + lane < cl;  // p >= cl - window holds from p_lo on
    for (int g = warp; g < G; g += kWarps) {
      const float* qg = Qs + g * qld;
      float s = 0.f;
      for (int d = 0; d < qld; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(&qg[d]);
        s += qv.x * Kt[(d + 0) * kKtLd + lane] + qv.y * Kt[(d + 1) * kKtLd + lane] +
             qv.z * Kt[(d + 2) * kKtLd + lane] + qv.w * Kt[(d + 3) * kKtLd + lane];
      }
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      s = ok ? s : NEG_INF_F;
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p);
      Ps[g * kChunk + lane] = p;
      if (lane == 0) {
        Ms[g] = m_new;
        Ls[g] = alpha * Ls[g] + psum;
        Al[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, one output element per thread
    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, d = e - g * hd;
      const float* pg = Ps + g * kChunk;
      float a = Acc[e] * Al[g];
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) a += pg[j] * Vs[j * hd + d];
      Acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * hd; e += kThreads)
    store_f(out, q_off + e, Acc[e] / fmaxf(Ls[e / hd], 1e-30f));
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* tables, const void* cls, void* out,
           int B, int H, int Hkv, int hd, int bs, int T, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, hd);
  auto kern = paged_decode_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(Hkv), static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(cls), static_cast<TQ*>(out), H, Hkv, hd, bs, T,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
              const void* ksc, const void* vsc, const void* tables,
              const void* cls, void* out, int B, int H, int Hkv, int hd,
              int bs, int T, int window, float softcap, float scale,
              cudaStream_t stream) {
  if (kv_dtype == DT_F32)
    return launch<TQ, float>(q, kp, vp, ksc, vsc, tables, cls, out, B, H, Hkv, hd, bs, T,
                             window, softcap, scale, stream);
  if (kv_dtype == DT_BF16)
    return launch<TQ, __nv_bfloat16>(q, kp, vp, ksc, vsc, tables, cls, out, B, H, Hkv, hd,
                                     bs, T, window, softcap, scale, stream);
  if (kv_dtype == DT_I8)
    return launch<TQ, int8_t>(q, kp, vp, ksc, vsc, tables, cls, out, B, H, Hkv, hd, bs, T,
                              window, softcap, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int paged_decode_attention_launch(
    const void* q, const void* kp, const void* vp, const void* ksc,
    const void* vsc, const void* tables, const void* cls, void* out,
    int q_dtype, int kv_dtype, int B, int H, int Hkv, int hd, int N, int bs,
    int T, int window, float softcap, float scale, void* stream) {
  (void)N;  // the pool's block count bounds the table entries, not the launch
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_F32)
    return launch_kv<float>(kv_dtype, q, kp, vp, ksc, vsc, tables, cls, out, B, H, Hkv, hd,
                            bs, T, window, softcap, scale, s);
  if (q_dtype == DT_BF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, kp, vp, ksc, vsc, tables, cls, out, B, H,
                                    Hkv, hd, bs, T, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
