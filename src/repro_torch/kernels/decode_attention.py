"""Paged decode attention: the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/decode_attention.py:paged_decode_attention``;
the kernels are ``csrc/decode_attention.cu``. A CUDA tensor launches them
(or raises), a CPU tensor takes the plain version
``kernels/ref.py:paged_decode_attention_ref``.

The kernel splits each sequence's context into spans of
:func:`split_size` positions, one thread block each, and a second kernel
merges the spans. The span, and so the number of splits and the size of
the workspace, comes from the table's capacity ``T * bs`` alone: the
wrapper never reads ``context_lens`` or ``block_tables`` on the host, which
would stall every decode step on a device-to-host copy.

Layout (one attention layer), as in the reference:

    q             (B, H, hd)          one new query token per sequence
    k_pool/v_pool (N, bs, Hkv, hd)    the shared block pool (float or int8)
    k/v_scales    (N, bs, Hkv) fp32   per-row scales of int8 pools
    block_tables  (B, T) int32        logical block j of sequence b lives in
                                      physical block ``block_tables[b, j]``
                                      (< 0 = unallocated)
    context_lens  (B,) int32          tokens written for sequence b,
                                      *including* the query's own K/V slot
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

# Launches of the CUDA kernels in this process (the wrapper adds one per
# launch of the split and merge pair and nowhere else; a caller may reset it
# to 0).
launches = 0

# Spans are 64 positions, doubled while a table would need more than 16
# splits (a long span streams its rows, a short one pays a block's start),
# up to 1024 (the span's block ids are staged in shared memory).
MIN_SPAN, MAX_SPAN, MAX_SPLITS = 64, 1024, 16


def split_size(T: int, bs: int) -> int:
    """Positions a split takes, for a (B, T) table of ``bs``-slot blocks."""
    span = MIN_SPAN
    while span < MAX_SPAN and -(-T * bs // span) > MAX_SPLITS:
        span *= 2
    return span


def num_splits(T: int, bs: int) -> int:
    return -(-T * bs // split_size(T, bs))


def paged_decode_supported(num_heads: int, num_kv_heads: int,
                           head_dim: int) -> Tuple[bool, str]:
    """Whether the paged kernel covers this head layout (and why not)."""
    if num_kv_heads <= 0 or num_heads % num_kv_heads != 0:
        return False, f"H={num_heads} not a multiple of Hkv={num_kv_heads}"
    if head_dim > 256:
        return False, f"head_dim {head_dim} > 256"
    return True, ""


def _check(q, k_pool, v_pool, block_tables, context_lens, k_scales, v_scales):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("paged_decode_attention takes q (B,H,hd) and pools (N,bs,Hkv,hd)")
    B, H, hd = q.shape
    N, bs, Hkv, hd_p = k_pool.shape
    if hd_p != hd:
        raise ValueError(f"pool head_dim {hd_p} != q head_dim {hd}")
    ok, why = paged_decode_supported(H, Hkv, hd)
    if not ok:
        raise ValueError(f"paged_decode_attention: {why}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, T), got {tuple(block_tables.shape)}")
    if context_lens.shape != (B,):
        raise ValueError(f"context_lens must be (B={B},), got {tuple(context_lens.shape)}")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pools need k_scales and v_scales, float pools take none")
    if quantized and (k_scales.shape != (N, bs, Hkv) or v_scales.shape != (N, bs, Hkv)):
        raise ValueError(f"scales must be (N, bs, Hkv) = {(N, bs, Hkv)}")


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Paged single-query attention. Returns (B, H, hd) in q.dtype.

    Sequences with ``context_lens[b] == 0`` (empty decode slots) produce
    zeros.
    """
    _check(q, k_pool, v_pool, block_tables, context_lens, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, context_lens, k_scales, v_scales,
            window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    tensors = [k_pool, v_pool, block_tables, context_lens]
    if k_scales is not None:
        tensors += [k_scales, v_scales]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all tensors must be on q's device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_decode_attention kernel takes float32 or bfloat16 q, got {q.dtype}")
    if k_pool.dtype not in (torch.float32, torch.bfloat16, torch.int8) or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must be float32, bfloat16 or int8, got {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if k_scales is not None and (k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise TypeError("int8 pool scales must be float32")
    if not all(t.is_contiguous() for t in [q, *tensors]):
        raise ValueError("paged_decode_attention kernel needs contiguous tensors")
    return _launch(q, k_pool, v_pool, block_tables, context_lens, k_scales, v_scales,
                   window, softcap)


def _launch(q, k_pool, v_pool, block_tables, context_lens, k_scales, v_scales,
            window, softcap):
    """The split and merge kernels on checked tensors -> (B, H, hd)."""
    global launches
    B, H, hd = q.shape
    _, bs, Hkv, _ = k_pool.shape
    T = block_tables.shape[1]
    if B > 65535 or T * bs >= 2 ** 31:
        raise ValueError(f"paged_decode_attention: batch {B} > 65535 or capacity "
                         f"{T * bs} >= 2^31")
    span = split_size(T, bs)
    out = torch.empty_like(q)
    partial = torch.empty((B, Hkv, num_splits(T, bs), H // Hkv, hd + 2),
                          dtype=torch.float32, device=q.device)
    err = _build.lib().paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scales.data_ptr() if k_scales is not None else None,
        v_scales.data_ptr() if v_scales is not None else None,
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        partial.data_ptr(), _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_pool.dtype],
        B, H, Hkv, hd, bs, T, span, int(window), float(softcap), 1.0 / math.sqrt(hd),
        q.device.index or 0, _build.stream_ptr(q.device))
    _build.check(err, "paged_decode_attention")
    launches += 1
    return out
