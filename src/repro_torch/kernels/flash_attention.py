"""Flash attention forward and backward: the CUDA kernels' wrapper.

Counterpart of ``repro/kernels/flash_attention.py:flash_attention``. A CPU
tensor takes the plain version ``kernels/ref.py:flash_attention_ref``,
whose gradient is autograd's. A CUDA tensor launches the forward kernel (or
raises); when autograd needs a gradient it goes through
:class:`FlashAttentionFn`, whose forward also writes the log-sum-exp and
whose backward launches the hand-written backward kernels. The reference
has no Pallas backward (its training attention is XLA's), so the backward
has no TPU kernel to mirror.

Two routes, chosen from dtype and head_dim alone before the launch (not a
fallback: each raises on its own failure), by one rule for the forward and
one for the backward:

- the forward of bf16 at head_dim 64, 112, 128 or 256, the shapes of the
  models' main paths, runs the tensor-core kernels (wgmma fed by TMA),
  through one C entry point: ``csrc/flash_attention_tc.cu`` at 64 and
  128, and at 112 (Kimi-K2's prefill) on a tile padded to 128 columns
  whose padding TMA reads as zeros; ``csrc/flash_attention_tc256.cu`` at
  256 (RecurrentGemma-9B's prefill);
- the backward of bf16 at head_dim 64 or 128 runs
  ``csrc/flash_attention_bwd_tc.cu``;
- every other dtype and head_dim run the CUDA-core kernels
  (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), and so
  does the bf16 backward at 112 (Kimi-K2) and 256 (RecurrentGemma-9B's
  local attention), which takes its D from P and dP as the tensor-core
  backward does.

Forward and backward, on both routes, also take keys of another length
``Skv`` than the queries' ``S`` (an encoder-decoder's cross-attention),
only without a mask (``causal=False``, no window): every query sees every
key. The queries, the output, the log-sum-exp and D keep ``S``; dK and dV
have ``Skv`` rows.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

# Launches in this process: ``launches`` counts the forward kernel,
# ``bwd_launches`` the backward (one per backward pass, which runs the D,
# dK/dV and dQ kernels on the CUDA cores, the dQ and dK/dV kernels on the
# tensor cores), on either route; ``tc_launches`` and ``tc_bwd_launches``
# count those of them that took the tensor-core route, and
# ``tc112_launches`` and ``tc256_launches`` those of the forward's at
# head_dim 112 and at 256 (the kernel of its own), and ``cross_launches``
# and ``cross_bwd_launches`` the forwards and the backwards (either route)
# whose keys are of another length than the queries. Each wrapper adds one
# where it launches and nowhere else; a caller may reset them to 0.
launches = 0
bwd_launches = 0
tc_launches = 0
tc_bwd_launches = 0
tc112_launches = 0
tc256_launches = 0
cross_launches = 0
cross_bwd_launches = 0

# bf16 head_dims on the tensor cores: the forward's, the backward's
TC_HEAD_DIMS = (64, 112, 128, 256)
TC_BWD_HEAD_DIMS = (64, 128)


def tensor_core_route(q) -> bool:
    """Whether ``q``'s dtype and head_dim take the tensor-core forward."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS


def tensor_core_bwd_route(q) -> bool:
    """Whether ``q``'s dtype and head_dim take the tensor-core backward."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in TC_BWD_HEAD_DIMS


def check_shapes(q, k, v, *, causal: bool = True, window: int = 0) -> None:
    """Raise on a layout the kernel does not take (any device). Keys of
    another length than the queries go without a mask only."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,S,H,hd), k/v (B,Skv,Hkv,hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    Skv = k.shape[1]
    if Skv != S and (causal or window > 0 or Skv < 1):
        raise ValueError(f"flash_attention: keys of length {Skv} for {S} queries are taken "
                         f"only without a mask (causal=False, no window), got "
                         f"causal={causal}, window={window}")
    Hkv = k.shape[2]
    if Hkv < 1 or H % Hkv != 0:
        raise ValueError(f"flash_attention: H={H} not a multiple of Hkv={Hkv}")
    if hd % 8 != 0 or hd > 256:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple of 8 and <= 256")


def _check_cuda(*ts) -> None:
    q = ts[0]
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 tensors of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention kernel needs contiguous tensors")
    B, S, H, hd = q.shape
    Skv = ts[1].shape[1]
    if B * H >= 2 ** 31 or (S + 63) // 64 > 65535 or Skv >= 2 ** 31 // 64:
        raise ValueError(f"flash_attention: grid too large for B*H={B * H}, S={S}, Skv={Skv}")


def _check_aligned(*ts) -> None:
    """The tensor-core kernels' TMA maps need 16-byte aligned bases."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention: the tensor-core kernels need 16-byte aligned "
                         "tensors")


def _launch_fwd(q, k, v, causal, window, softcap, want_lse):
    """Forward kernel -> (out in q.dtype, lse fp32 (B,H,S) or None)."""
    global launches, tc_launches, tc112_launches, tc256_launches, cross_launches
    _check_cuda(q, k, v)
    B, S, H, hd = q.shape
    Skv = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None)
    flags = (int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(hd))
    stream = _build.stream_ptr(q.device)
    tc = tensor_core_route(q)
    if tc:  # bf16 only
        _check_aligned(q, k, v, out)
        err = _build.lib().flash_attention_fwd_tc_launch(
            *ptrs, B, S, H, k.shape[2], hd, Skv, *flags, q.device.index or 0, stream)
    else:
        err = _build.lib().flash_attention_fwd_launch(
            *ptrs, _build.DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd, Skv, *flags,
            q.device.index or 0, stream)
    _build.check(err, "flash_attention")
    launches += 1
    tc_launches += tc
    tc112_launches += tc and hd == 112
    tc256_launches += tc and hd == 256
    cross_launches += Skv != S
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, causal, window, softcap):
    """Backward kernels -> (dq, dk, dv) in the inputs' dtype."""
    global bwd_launches, tc_bwd_launches, cross_bwd_launches
    check_shapes(q, k, v, causal=causal, window=window)
    _check_cuda(q, k, v, out, dout)
    B, S, H, hd = q.shape
    Skv = k.shape[1]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous():
        raise ValueError("flash_attention backward needs the forward's fp32 (B,H,S) lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    rest = (dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    flags = (int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(hd))
    stream = _build.stream_ptr(q.device)
    tc = tensor_core_bwd_route(q)
    if tc:  # recomputes D from P and dP, so the output is not read
        _check_aligned(q, k, v, dout, dq, dk, dv)
        err = _build.lib().flash_attention_bwd_tc_launch(
            *qkv, *rest, B, S, H, k.shape[2], hd, Skv, *flags, q.device.index or 0, stream)
    else:  # fp32 reads the output for D; bf16 takes D from P and dP
        err = _build.lib().flash_attention_bwd_launch(
            *qkv, out.data_ptr(), *rest, _build.DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd,
            Skv, *flags, q.device.index or 0, stream)
    _build.check(err, "flash_attention backward")
    bwd_launches += 1
    tc_bwd_launches += tc
    cross_bwd_launches += Skv != S
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward and backward are the hand-written kernels.

    The forward keeps q, k, v, the output and the fp32 log-sum-exp; the
    backward recomputes P from them (no S x S tensor is stored).
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        check_shapes(q, k, v, causal=causal, window=window)
        out, lse = _launch_fwd(q, k, v, causal, window, softcap, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout.contiguous(), *ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,Skv,Hkv,hd) -> (B,S,H,hd) in q.dtype; Skv
    other than S with ``causal=False`` and no window only."""
    check_shapes(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window), float(softcap))
    return _launch_fwd(q, k, v, causal, window, softcap, want_lse=False)[0]
