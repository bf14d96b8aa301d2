"""Thin wrappers with the reference's signatures (``repro/kernels/ops.py``).

The integration surface between the kernels and the model. Which
implementation runs follows the tensors' device, inside each kernel's
wrapper. The wire exchange's two kernels take an
:class:`~repro_torch.kernels.symm.Exchange` (a process group, its members,
this member's index and, on the card, the symmetric buffer).
"""

from __future__ import annotations

from repro_torch.kernels.decode_attention import paged_decode_attention as _paged_decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.pier_update import pier_update as _pier_update
from repro_torch.kernels.quantize import dequantize_blockwise as _dequantize
from repro_torch.kernels.quantize import quantize_blockwise as _quantize
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
# a module, not its names: ring_allreduce imports wire, which imports this
from repro_torch.kernels import ring_allreduce as _RA


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q (B,S,H,hd), k/v (B,S,Hkv,hd) -> (B,S,H,hd). Every S >= 1 is taken
    (the reference's ``S >= 16`` is a TPU tiling limit); a layout the
    kernel does not take raises on any device."""
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap)


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           k_scales=None, v_scales=None, *,
                           window: int = 0, softcap: float = 0.0):
    """Single-query attention through a block table (kernels/decode_attention).

    q (B, H, hd); pools (N, bs, Hkv, hd) [+ (N, bs, Hkv) fp32 scales when
    int8-quantized]; block_tables (B, T) int32; context_lens (B,) int32.
    """
    return _paged_decode(
        q, k_pool, v_pool, block_tables, context_lens, k_scales, v_scales,
        window=window, softcap=softcap)


def quantize_blockwise(x, *, bits: int = 8, block: int = 256):
    """Flat (N,) -> (q int8 (nblocks*block,), scales f32 (nblocks,))."""
    return _quantize(x, bits=bits, block=block)


def dequantize_blockwise(q, scales, *, block: int = 256):
    """Inverse of :func:`quantize_blockwise`; returns fp32 (nblocks*block,).
    A ragged payload raises ``ValueError``."""
    return _dequantize(q, scales, block=block)


def pier_update_leaf(a, m, d, tc, *, mu, lr, p_out=None, m_out=None):
    """Fused Pier outer update on one leaf (any shape) -> (p_f32, m_new).

    The single-leaf building block of ``core.outer.outer_reduce_leaves``.
    ``p_out`` / ``m_out`` are written in place when given (they may be
    ``a`` and ``m``: see ``kernels/pier_update.py``).
    """
    return _pier_update(a, m, d, mu, lr, tc.outer_optimizer, p_out=p_out, m_out=m_out)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """Row RMSNorm over the last axis: x (..., D), scale (D,) fp32 ->
    (..., D) in x.dtype (kernels/rmsnorm, ``csrc/rmsnorm.cu``)."""
    return _rmsnorm(x, scale, eps=eps)


def ring_allgather(x, ex):
    """(n,) uint8 of this member -> (E, n): every member's buffer in its
    canonical slot (kernels/ring_allreduce, ``csrc/ring_allgather.cu``)."""
    return _RA.ring_allgather(x, ex)


def shard_scatter(slots, ex):
    """(E, m) uint8, row e for member e -> (E, m), row j member j's slot for
    this member (kernels/ring_allreduce, ``csrc/shard_scatter.cu``)."""
    return _RA.shard_scatter(slots, ex)
