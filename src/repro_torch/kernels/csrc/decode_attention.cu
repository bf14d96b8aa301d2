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
// Bound: bytes. The work is reading each live position's K and V row once
// (about 4 G flops per 2 hd bytes of bf16 pool, G = H / Hkv). Design, split
// over the context:
// - Grid (splits, Hkv x query chunks, B). Split s takes the positions
//   [s * span, (s + 1) * span). The wrapper picks span from the table's
//   capacity T * bs alone (kernels/decode_attention.py:split_size), so it
//   never reads context_lens on the host; a block whose span lies wholly
//   past cl, or wholly before cl - window, returns at once.
// - A block serves up to GC query heads of one kv head (all G of them at
//   G <= 8), so their shared K/V is read once. It reads the pool block ids
//   of its span from the table once, into shared memory.
// - Each row is taken by a group of lanes, 8 columns a lane: one 16-byte
//   load of bf16, two of fp32 or one 8-byte load of int8 (scalar loads where
//   hd is not a multiple of 8 or a pool is not aligned), and the int8 scale
//   once a row. A group walks its own positions U rows at a time, issuing
//   all U rows' loads before it reduces the first, and, where its span holds
//   more than one batch, the next batch's loads before it reduces this one
//   (two batches in registers); rows stay packed until used. The G dot
//   products are reduced with shuffles over the row's lanes, and each group
//   keeps its own (m, l, acc) in registers. No block barrier runs inside
//   the walk.
// - At the end the groups merge: shuffles within a warp, then shared memory
//   across the block's warps. The block writes its split's (acc, m, l) to an
//   fp32 workspace (B, Hkv, splits, G, hd + 2), and a second kernel merges
//   each (sequence, kv head)'s live splits in index order and normalises.
//   Every sum has a fixed order, so a run repeats to the bit.
// Neither TMA nor the tensor cores: at G <= 8 a row's scores are G dot
// products of hd values, about 2G flops a loaded element, which the CUDA
// cores take in stride; a wgmma tile of 64 query rows would be almost all
// padding, and the table gather picks rows one at a time, which 16-byte
// loads follow as cheaply as a TMA box would.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;  // columns of a row a lane holds
constexpr int kCombineThreads = 128;

// Columns [c0, c0 + 8) of a pool row as stored: 16 bytes of bf16, 32 of
// fp32 or 8 of int8 on the vector path, 8 values on the scalar one (where
// columns at or past hd read as 0). Rows stay packed until they are used,
// so a lane holds U rows of K and V in few registers.
template <typename T, bool kVec>
struct RowBits {
  T v[kCols];
};
template <>
struct RowBits<float, true> {
  float4 a, b;
};
template <>
struct RowBits<__nv_bfloat16, true> {
  uint4 a;
};
template <>
struct RowBits<int8_t, true> {
  uint2 a;
};

template <typename T, bool kVec>
__device__ __forceinline__ void load_row(RowBits<T, kVec>& r, const T* p, int c0, int hd) {
  if constexpr (!kVec) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) r.v[k] = c0 + k < hd ? p[c0 + k] : T(0.f);
  } else if constexpr (sizeof(T) == 4) {
    r.a = *reinterpret_cast<const float4*>(p + c0);
    r.b = *reinterpret_cast<const float4*>(p + c0 + 4);
  } else if constexpr (sizeof(T) == 2) {
    r.a = *reinterpret_cast<const uint4*>(p + c0);
  } else {
    r.a = *reinterpret_cast<const uint2*>(p + c0);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void unpack(const RowBits<T, kVec>& r, float (&f)[kCols]) {
  if constexpr (!kVec) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) f[k] = load_f(r.v, k);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
    f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
  } else if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
    for (int k = 0; k < kCols / 2; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  } else {
    const int8_t* c = reinterpret_cast<const int8_t*>(&r.a);
#pragma unroll
    for (int k = 0; k < kCols; ++k) f[k] = static_cast<float>(c[k]);
  }
}

// One block: split blockIdx.x of kv head hk's query chunk, sequence
// blockIdx.z. Shared memory: [kWarps][GC][hd + 2] floats for the merge,
// then the span's block ids.
template <typename TKV, bool kVec, int GC, bool kPipe>
__global__ void __launch_bounds__(kThreads, GC > 2 ? 2 : kPipe ? 4 : 6)
    paged_decode_split_kernel(
    const void* __restrict__ q, int q_bf16, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ksc, const float* __restrict__ vsc,
    const int* __restrict__ tables, const int* __restrict__ cls, float* __restrict__ partial,
    int H, int Hkv, int hd, int bs, int T, int span, int lpr_log2, int window,
    float softcap, float scale) {
  constexpr int U = GC <= 2 ? 4 : 2;  // rows a group loads before it reduces the first
  extern __shared__ __align__(16) float smem[];
  const int G = H / Hkv, chunks = (G + GC - 1) / GC;
  const int split = blockIdx.x, hk = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * GC;
  const int b = blockIdx.z;
  const int ld = hd + 2;
  // the span's block ids, read together with cl rather than after it
  int* blk = reinterpret_cast<int*>(smem + kWarps * GC * ld);
  const int first = split * span / bs;
  const int nblk = min(T, ((split + 1) * span - 1) / bs + 1) - first;
  const int cl = cls[b];
  for (int i = threadIdx.x; i < nblk; i += kThreads)
    blk[i] = max(tables[static_cast<long long>(b) * T + first + i], 0);
  // the live positions of this split: past cl - window, before cl
  const int lo = max(split * span, window > 0 ? cl - window : 0);
  const int hi = min(min(cl, T * bs), (split + 1) * span);
  if (lo >= hi) return;  // the same for the whole block
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpr = 1 << lpr_log2, rpw = 32 >> lpr_log2;  // lanes a row, rows a warp
  const int grp = warp * rpw + (lane >> lpr_log2), ng = kWarps * rpw;
  const int c0 = (lane & (lpr - 1)) * kCols;
  const bool has_cols = c0 < hd;
  const long long kv_ld = static_cast<long long>(Hkv) * hd;  // per pool slot

  float qr[GC][kCols];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const long long qo = (static_cast<long long>(b) * H + hk * G + g0 + g) * hd;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int d = c0 + k;
      float v = 0.f;
      if (g0 + g < G && d < hd)
        v = q_bf16 ? load_f(static_cast<const __nv_bfloat16*>(q), qo + d)
                   : load_f(static_cast<const float*>(q), qo + d);
      qr[g][k] = v;
    }
  }
  float m[GC], l[GC], acc[GC][kCols];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[g][k] = 0.f;
  }

  // A batch: U rows of this group, still packed, with their int8 scales.
  struct Batch {
    RowBits<TKV, kVec> kr[U], vr[U];
    float ks[U], vs[U];
    bool live[U];
  };
  // every load of the batch's U rows before any of them is used
  auto fetch = [&](Batch& t, int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * ng + grp;
      t.live[u] = p < hi;
      t.ks[u] = t.vs[u] = 1.f;
      t.kr[u] = t.vr[u] = RowBits<TKV, kVec>{};
      if (t.live[u] && has_cols) {
        const long long row = static_cast<long long>(blk[p / bs - first]) * bs + p % bs;
        const long long off = row * kv_ld + static_cast<long long>(hk) * hd;
        load_row(t.kr[u], kp + off, c0, hd);
        load_row(t.vr[u], vp + off, c0, hd);
        if (ksc != nullptr) {
          t.ks[u] = ksc[row * Hkv + hk];
          t.vs[u] = vsc[row * Hkv + hk];
        }
      }
    }
  };
  auto consume = [&](const Batch& t) {
    float s[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[kCols];
      unpack(t.kr[u], kf);
#pragma unroll
      for (int k = 0; k < kCols; ++k) kf[k] *= t.ks[u];  // int8: as the reference dequantizes
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) d += qr[g][k] * kf[k];
        for (int o = lpr >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        d *= scale;
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        s[u][g] = t.live[u] ? d : NEG_INF_F;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      float pu[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pu[u] = t.live[u] ? expf(s[u][g] - mx) : 0.f;
        psum += pu[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[g][k] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[kCols];
        unpack(t.vr[u], vf);
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[g][k] += pu[u] * (vf[k] * t.vs[u]);
      }
      m[g] = mx;
    }
  };

  // The trip count is the block's, so every lane reaches every shuffle.
  const int stride = U * ng;  // positions a batch covers
  if constexpr (kPipe) {  // two batches in flight: the next loads while this one is reduced
    Batch b0, b1;
    fetch(b0, lo);
    for (int base = lo; base < hi; base += 2 * stride) {
      fetch(b1, base + stride);
      consume(b0);
      fetch(b0, base + 2 * stride);
      consume(b1);
    }
  } else {  // the span is one batch a group, or G is large
    for (int base = lo; base < hi; base += stride) {
      Batch t;
      fetch(t, base);
      consume(t);
    }
  }

  griddep_launch_dependents();  // the merge may be scheduled; it waits for this grid
  // merge the warp's row groups (lanes lpr, 2 lpr, ... apart hold the same
  // columns), then the warps through shared memory
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_other = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo), a = expf(m[g] - mx), c = expf(mo - mx);
      l[g] = l[g] * a + lo_other * c;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        acc[g][k] = acc[g][k] * a + __shfl_xor_sync(0xffffffffu, acc[g][k], o) * c;
      m[g] = mx;
    }
  }
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float* r = smem + (warp * GC + g) * ld;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (c0 + k < hd) r[c0 + k] = acc[g][k];
      if (lane == 0) {
        r[hd] = m[g];
        r[hd + 1] = l[g];
      }
    }
  }
  __syncthreads();
  const int gn = min(GC, G - g0);
  float* out = partial + ((static_cast<long long>(b) * Hkv + hk) * gridDim.x + split) * G * ld +
               static_cast<long long>(g0) * ld;
  for (int e = threadIdx.x; e < gn * ld; e += kThreads) {
    const int g = e / ld, d = e - g * ld;
    float mx = NEG_INF_F;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, smem[(w * GC + g) * ld + hd]);
    float t = mx;
    if (d != hd) {
      const int src = d < hd ? d : hd + 1;  // acc column, or l
      t = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* r = smem + (w * GC + g) * ld;
        t += r[src] * expf(r[hd] - mx);
      }
    }
    out[e] = t;
  }
}

// One block per (kv head, sequence): its live splits merged in index order.
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads) paged_decode_combine_kernel(
    const float* __restrict__ partial, const int* __restrict__ cls, TQ* __restrict__ out,
    int H, int Hkv, int hd, int bs, int T, int span, int splits, int window) {
  const int hk = blockIdx.x, b = blockIdx.y, G = H / Hkv, ld = hd + 2;
  const int cl = cls[b];
  const int lo = window > 0 ? max(0, cl - window) : 0, hi = min(cl, T * bs);
  // the splits whose positions meet [lo, hi), as the split kernel finds them
  const int s_lo = lo / span, s_hi = hi > lo ? (hi + span - 1) / span : s_lo;
  const float* base = partial + (static_cast<long long>(b) * Hkv + hk) * splits * G * ld;
  griddep_wait();  // the partials are the split kernel's
  for (int e = threadIdx.x; e < G * hd; e += kCombineThreads) {
    const int g = e / hd, d = e - g * hd;
    float mx = NEG_INF_F, lsum = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = s_lo; s < s_hi; ++s) {  // online, so a split's three loads go together
      const float* r = base + (static_cast<long long>(s) * G + g) * ld;
      const float ms = r[hd], mn = fmaxf(mx, ms);
      const float c_old = expf(mx - mn), c_new = expf(ms - mn);
      lsum = lsum * c_old + r[hd + 1] * c_new;
      a = a * c_old + r[d] * c_new;
      mx = mn;
    }
    store_f(out, (static_cast<long long>(b) * H + hk * G + g) * hd + d, a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void *q, *kp, *vp, *ksc, *vsc, *tables, *cls;
  void *out, *partial;
  int q_dtype, B, H, Hkv, hd, bs, T, span, splits, window;
  float softcap, scale;
  cudaStream_t stream;
  int lpr_log2;  // lanes a row: 8 columns a lane, at most 32 lanes (hd <= 256)
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TKV, bool kVec, int GC, bool kPipe>
int launch_split(const Args& a) {
  const int G = a.H / a.Hkv, chunks = (G + GC - 1) / GC;
  const size_t smem = sizeof(float) * kWarps * GC * (a.hd + 2) +
                      sizeof(int) * (a.span / a.bs + 2);  // <= 37 KB: no opt-in needed
  const dim3 grid(static_cast<unsigned>(a.splits), static_cast<unsigned>(a.Hkv * chunks),
                  static_cast<unsigned>(a.B));
  paged_decode_split_kernel<TKV, kVec, GC, kPipe><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.q_dtype == DT_BF16, static_cast<const TKV*>(a.kp), static_cast<const TKV*>(a.vp),
      static_cast<const float*>(a.ksc), static_cast<const float*>(a.vsc),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.cls),
      static_cast<float*>(a.partial), a.H, a.Hkv, a.hd, a.bs, a.T, a.span, a.lpr_log2,
      a.window, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// At G <= 2 a group whose span holds more than one batch of rows (hd above
// 64, or a long span) takes the kernel that keeps two batches in flight; a
// span that is one batch (GPT-2's heads at span 64) takes the one with the
// fewer registers, and so more blocks an SM.
template <typename TKV, bool kVec>
int by_group(const Args& a) {
  const int G = a.H / a.Hkv;
  // a group's rows in a span: span / (kWarps * 32 / lanes a row); more than one batch of 4?
  const bool pipe = (a.span << a.lpr_log2) > 4 * 32 * kWarps;
  if (G <= 1)
    return pipe ? launch_split<TKV, kVec, 1, true>(a) : launch_split<TKV, kVec, 1, false>(a);
  if (G <= 2)
    return pipe ? launch_split<TKV, kVec, 2, true>(a) : launch_split<TKV, kVec, 2, false>(a);
  if (G <= 4) return launch_split<TKV, kVec, 4, false>(a);
  return launch_split<TKV, kVec, 8, false>(a);  // larger G: chunks of 8 query heads
}

template <typename TKV>
int by_alignment(const Args& a) {
  if (a.hd % kCols == 0 && aligned16(a.kp) && aligned16(a.vp)) return by_group<TKV, true>(a);
  return by_group<TKV, false>(a);
}

template <typename TQ>
int launch_combine(const Args& a) {
  // scheduled while the split kernel drains; it reads cl before it waits
  return static_cast<int>(launch_dependent(
      paged_decode_combine_kernel<TQ>, dim3(a.Hkv, a.B), dim3(kCombineThreads), 0, a.stream,
      static_cast<const float*>(a.partial), static_cast<const int*>(a.cls),
      static_cast<TQ*>(a.out), a.H, a.Hkv, a.hd, a.bs, a.T, a.span, a.splits, a.window));
}

}  // namespace

// partial: the fp32 workspace (B, Hkv, splits, H / Hkv, hd + 2), splits =
// ceil(T * bs / span); span a multiple of 32 up to 1024; hd <= 256; all on
// card `device`.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kp, const void* vp, const void* ksc, const void* vsc,
    const void* tables, const void* cls, void* out, void* partial, int q_dtype, int kv_dtype,
    int B, int H, int Hkv, int hd, int bs, int T, int span, int window, float softcap,
    float scale, int device, void* stream) {
  // bind the calling thread to the tensors' card (autograd's thread may
  // have no current context yet)
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (span < 1 || span > 1024 || hd < 1 || hd > 256 || (q_dtype != DT_F32 && q_dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  int lpr_log2 = 0;
  while ((kCols << lpr_log2) < hd) ++lpr_log2;
  const Args a{q, kp, vp, ksc, vsc, tables, cls, out, partial, q_dtype, B, H, Hkv, hd, bs, T,
               span, (T * bs + span - 1) / span, window, softcap, scale,
               static_cast<cudaStream_t>(stream), lpr_log2};
  if (a.splits > 0) {
    int e = static_cast<int>(cudaErrorInvalidValue);
    if (kv_dtype == DT_F32) e = by_alignment<float>(a);
    if (kv_dtype == DT_BF16) e = by_alignment<__nv_bfloat16>(a);
    if (kv_dtype == DT_I8) e = by_alignment<int8_t>(a);
    if (e != 0) return e;
  }
  return q_dtype == DT_F32 ? launch_combine<float>(a) : launch_combine<__nv_bfloat16>(a);
}
