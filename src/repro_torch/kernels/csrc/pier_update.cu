// Fused Pier outer update, written by hand for Hopper.
//
// Replaces: src/repro/kernels/pier_update.py:_update_kernel (launched by
// _pier_update_pallas), the TPU kernel of the outer Nesterov/SGD step that
// every outer sync runs once per parameter leaf (Alg. 2 lines 20-21):
//   m' = mu m + d
//   step = mu m' + d   (nesterov_torch) | mu m + d (nesterov_classic) | m' (sgd)
//   p  = a + lr step   (fp32)
// with a, m, d read in their own dtype (fp32 or bf16) and widened to fp32,
// p written in fp32 and m' in the momentum's dtype (round to nearest even).
//
// mu and lr are runtime scalars, rounded to fp32 once on the host, so one
// build serves every step of the mu-decay and outer-LR schedules. Every
// product and sum is written with __fmul_rn / __fadd_rn: nvcc may not
// contract them into FMAs, so the kernel agrees bit for bit with the plain
// version (kernels/ref.py:pier_update_ref), which runs separate mul and
// add kernels.
//
// Bound: bytes. Per element it reads a, m, d and writes p and m' (20 bytes
// in fp32) for 5 floating-point operations. Design: a grid-stride loop, one
// element per thread per iteration, neighbouring threads on neighbouring
// addresses. The outputs may alias the inputs (p over a, m' over m): each
// element is read before it is written by the same thread, so the caller
// can update the outer state in place and save a model-sized buffer.

#include "common.cuh"

namespace {

enum Formulation : int { NESTEROV_TORCH = 0, NESTEROV_CLASSIC = 1, SGD = 2 };

template <typename TA, typename TM, typename TD, int FORM>
__global__ void __launch_bounds__(256) pier_update_kernel(
    const TA* a, const TM* m, const TD* __restrict__ d, float* p_out,
    TM* m_out, long long n, float mu, float lr) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float af = load_f(a, i);
    const float mf = load_f(m, i);
    const float df = load_f(d, i);
    const float m_new = __fadd_rn(__fmul_rn(mu, mf), df);
    float step;
    if (FORM == NESTEROV_TORCH) {
      step = __fadd_rn(__fmul_rn(mu, m_new), df);
    } else if (FORM == NESTEROV_CLASSIC) {
      step = __fadd_rn(__fmul_rn(mu, mf), df);
    } else {
      step = m_new;
    }
    p_out[i] = __fadd_rn(af, __fmul_rn(lr, step));
    store_f(m_out, i, m_new);
  }
}

template <typename TA, typename TM, typename TD>
int launch_form(const void* a, const void* m, const void* d, void* p_out,
                void* m_out, long long n, float mu, float lr, int form,
                cudaStream_t stream) {
  constexpr int kThreads = 256;
  // enough blocks to fill the card many times over; the loop covers the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
  const TA* ap = static_cast<const TA*>(a);
  const TM* mp = static_cast<const TM*>(m);
  const TD* dp = static_cast<const TD*>(d);
  float* pp = static_cast<float*>(p_out);
  TM* mo = static_cast<TM*>(m_out);
  if (form == NESTEROV_TORCH)
    pier_update_kernel<TA, TM, TD, NESTEROV_TORCH><<<grid, kThreads, 0, stream>>>(
        ap, mp, dp, pp, mo, n, mu, lr);
  else if (form == NESTEROV_CLASSIC)
    pier_update_kernel<TA, TM, TD, NESTEROV_CLASSIC><<<grid, kThreads, 0, stream>>>(
        ap, mp, dp, pp, mo, n, mu, lr);
  else if (form == SGD)
    pier_update_kernel<TA, TM, TD, SGD><<<grid, kThreads, 0, stream>>>(
        ap, mp, dp, pp, mo, n, mu, lr);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TM>
int launch_d(const void* a, const void* m, const void* d, int d_dt, void* p_out,
             void* m_out, long long n, float mu, float lr, int form, cudaStream_t s) {
  if (d_dt == DT_F32)
    return launch_form<TA, TM, float>(a, m, d, p_out, m_out, n, mu, lr, form, s);
  if (d_dt == DT_BF16)
    return launch_form<TA, TM, __nv_bfloat16>(a, m, d, p_out, m_out, n, mu, lr, form, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TA>
int launch_m(const void* a, const void* m, int m_dt, const void* d, int d_dt,
             void* p_out, void* m_out, long long n, float mu, float lr, int form,
             cudaStream_t s) {
  if (m_dt == DT_F32)
    return launch_d<TA, float>(a, m, d, d_dt, p_out, m_out, n, mu, lr, form, s);
  if (m_dt == DT_BF16)
    return launch_d<TA, __nv_bfloat16>(a, m, d, d_dt, p_out, m_out, n, mu, lr, form, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pier_update_launch(const void* a, int a_dt, const void* m,
                                  int m_dt, const void* d, int d_dt,
                                  void* p_out, void* m_out, long long n,
                                  float mu, float lr, int formulation,
                                  int device, void* stream) {
  // bind the calling thread to the tensors' card (autograd's thread may
  // have no current context yet)
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dt == DT_F32)
    return launch_m<float>(a, m, m_dt, d, d_dt, p_out, m_out, n, mu, lr, formulation, s);
  if (a_dt == DT_BF16)
    return launch_m<__nv_bfloat16>(a, m, m_dt, d, d_dt, p_out, m_out, n, mu, lr,
                                   formulation, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
