// Hopper building blocks of the tensor-core flash-attention kernels
// (flash_attention_tc.cu, flash_attention_tc256.cu,
// flash_attention_bwd_tc.cu): TMA tensor maps and loads, mbarriers, wgmma
// and its shared-memory descriptors, and the register layouts that tie
// them together. bf16 only; head_dim 64 or 128, and in the forward 112 and
// 256 (a 64 x 256 P V product with A from registers, and four chunks of 64
// columns in the layout below).
//
// Layout contract, which the TMA box, the wgmma descriptors and the
// transpose bit must agree on (a mismatch gives plausible wrong numbers,
// not a fault):
// - A (rows, hd) tile of q, k, v or dO lives in shared memory as W / 64
//   chunks, each [rows][64] bf16 = rows x 128 bytes, written by one TMA box
//   of 64 x rows with 128-byte swizzle, every chunk 1024-byte aligned. The
//   tile width W is hd rounded up to 64: at hd 112 the tile is 128 wide,
//   the map spans the tensor's 112 columns, and the second box reads
//   columns 112-127 past it, which TMA fills with zeros (a 224-byte row
//   stride is a multiple of the 16 bytes TMA asks of a stride). Products
//   over the zero columns add nothing; a store ends at column hd - 1.
// - As a K-major operand (hd is the reduction: Q K^T, dO V^T, K Q^T, V dO^T)
//   its descriptor starts at the chunk of k-step kk / 4 plus (kk % 4) x 32
//   bytes, with SBO = 1024 bytes (8 rows of 128 bytes).
// - As an MN-major B operand (rows are the reduction: P V, P^T dO, dS^T Q,
//   dS K) it is read with the transpose bit: start = chunk 0 + kk x 16 rows
//   x 128 bytes, SBO = 1024 bytes (the next 8 rows), LBO = one chunk (the
//   next 64 columns of hd).
// - The fp32 accumulator of m64nNk16 gives thread t of warp w rows
//   16 w + t / 4 and that + 8, columns 8 j + 2 (t % 4) + {0, 1}:
//   d[4 j + e] is row + 8 (e / 2), column + (e % 2). Those are exactly the
//   positions of the bf16 A fragment of a k16 step, so a score tile turns
//   into the A operand of the next product without leaving the registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <mutex>

#include "common.cuh"

namespace flash_tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// host: TMA tensor maps over a (B, S, heads, hd) bf16 tensor
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the
// library needs no link against libcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map over (hd, heads, S, B), innermost first; a box is 64 values of
// one head's row by `rows` positions, 128-byte swizzled. Rows past S read
// as zeros. Maps are cached by (pointer, shape, box): the caching allocator
// hands the same addresses to the same layer's tensors step after step, so
// a model's launches reuse their maps instead of encoding each anew.
// Returns cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t tensor_map(CUtensorMap* out, const void* ptr, int B, int S, int heads,
                              int hd, int rows) {
  struct Entry {
    const void* ptr;
    int B, S, heads, hd, rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 512;
  static Entry cache[kEntries];
  static std::mutex mu;
  const uint64_t key = reinterpret_cast<uintptr_t>(ptr) ^ (uint64_t(S) << 40) ^
                       (uint64_t(heads) << 20) ^ (uint64_t(B) << 8) ^ uint64_t(hd + rows);
  Entry& e = cache[(key ^ (key >> 17) ^ (key >> 31)) % kEntries];
  std::lock_guard<std::mutex> lock(mu);
  if (e.ptr == ptr && e.B == B && e.S == S && e.heads == heads && e.hd == hd && e.rows == rows) {
    *out = e.map;
    return cudaSuccess;
  }
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 2, cuuint64_t(heads) * hd * 2,
                                 cuuint64_t(S) * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    e.ptr = nullptr;
    return cudaErrorInvalidValue;
  }
  e.ptr = ptr;
  e.B = B;
  e.S = S;
  e.heads = heads;
  e.hd = hd;
  e.rows = rows;
  *out = e.map;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory window, rounded up to 1024 bytes (the 128-byte
// swizzle's period); launches ask for 1024 bytes more than they use.
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A phase that has not completed 10 s after the wait began means a fault
// (a lost TMA, a wrong byte count): trap, so the launch fails with an
// error instead of hanging the card.
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(a, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > kWaitLimitNs) __trap();
  }
}

// One TMA box (64 values x rows positions of head `head`, from position
// `pos` of batch row `b`, column `col`) into `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int head, int pos, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(pos),
      "r"(b)
      : "memory");
}

// Load a (rows, HD) tile: HD / 64 boxes into consecutive chunks of
// rows x 64 values.
template <int HD>
__device__ __forceinline__ void tma_tile(bf16* dst, int rows, const CUtensorMap* map,
                                         uint64_t* bar, int head, int pos, int b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) tma_load(dst + c * rows * 64, map, bar, c * 64, head, pos, b);
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo_bytes) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo_bytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);  // SBO 1024, 128B swizzle
}

// K-major operand of k-step kk over a (rows, HD) tile (hd is the reduction).
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * rows * 64 + (kk & 3) * 16, 16);
}

// MN-major B operand of k-step kk over a (rows, HD) tile (rows are the
// reduction, hd the N dimension).
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows, int kk) {
  return desc(tile + kk * 16 * 64, rows * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Make the compiler treat an accumulator as read and written here, so it
// does not move uses of the registers across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) += A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, smem) * B (16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, registers) * B (16 x 256, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep A fragments live (in their registers) until here: an RS wgmma reads
// them asynchronously, after the asm statement that names them.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// bf16 pair (lo = the lower column) as one 32-bit register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of a 64 x N product as bf16 A fragments of its N / 16
// k-steps (see the layout contract above).
template <int NR>
__device__ __forceinline__ void to_a_frags(const float (&d)[NR], uint32_t (&a)[NR / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NR / 8; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// The same, split in three bf16 terms: hi = bf16(d), mid = bf16(d - hi),
// lo = bf16(d - hi - mid), so that products with all three see d to about
// 24 bits, as an fp32 product would.
template <int NR>
__device__ __forceinline__ void to_a_frags_split3(const float (&d)[NR], uint32_t (&hi)[NR / 8][4],
                                                  uint32_t (&mid)[NR / 8][4],
                                                  uint32_t (&lo)[NR / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NR / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
      const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      mid[kk][r] = *reinterpret_cast<const uint32_t*>(&m);
      lo[kk][r] = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
    }
  }
}

// Store an accumulator of 64 rows x N columns as bf16 rows of a (., ld)
// strided tensor at `base` (row `row0` of this thread, rows >= S skipped),
// each value times `mul[e / 2]` (its row's factor). Only the first NG
// groups of 8 columns are stored (all N / 8 by default): a tile padded past
// head_dim stores the head's columns and not a value past them.
template <int NR, int NG = NR / 4>
__device__ __forceinline__ void store_rows(bf16* base, long long ld, int row0, int S,
                                           const float (&d)[NR], const float (&mul)[2]) {
  static_assert(NG >= 1 && NG <= NR / 4, "store_rows: more column groups than the tile has");
  const int col0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    bf16* p = base + static_cast<long long>(row) * ld + col0;
#pragma unroll
    for (int j = 0; j < NG; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(d[4 * j + 2 * half] * mul[half], d[4 * j + 2 * half + 1] * mul[half]);
  }
}

// Max and sum over the four threads that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The masks of the reference kernel: keys past Skv, causal (k <= q), window
// (q - k < window); rows past S see nothing. Skv is S but in the forward of
// an encoder-decoder's cross-attention, which has neither mask.
__device__ __forceinline__ bool visible(int qi, int kj, int S, int Skv, int causal,
                                        int window) {
  return kj < Skv && qi < S && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// The head_dim-256 forward (flash_attention_tc256.cu), reached through
// flash_attention_fwd_tc_launch: bf16 q (B,S,H,256), k/v (B,Skv,Hkv,256),
// o like q, lse fp32 (B,H,S) or null. Returns a cudaError_t.
int fwd_hd256(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
              int Skv, int H, int Hkv, int causal, int window, float softcap, float scale,
              cudaStream_t stream);

}  // namespace flash_tc
