"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in eager PyTorch. The
kernels' wrappers take these for CPU tensors, the CPU tests hold them
against the reference package's Pallas kernels, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """GQA attention. q: (B,S,H,hd); k/v: (B,S,Hkv,hd) -> (B,S,H,hd) in q.dtype.

    Counterpart of ``repro/kernels/ref.py:flash_attention_ref``.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _inv_qmax(bits: int) -> torch.Tensor:
    # 1/qmax computed in double and rounded once to float32, as the
    # reference's ``absmax * (1.0 / qmax)`` does with its Python constant
    qmax = float(2 ** (bits - 1) - 1)
    return torch.tensor(np.float32(1.0 / qmax))


def quantize_blockwise_ref(x, *, bits: int = 8, block: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric absmax quantization.

    x: flat (N,) float -> (q int8 (nblocks*block,), scales f32 (nblocks,)).
    The payload is padded to whole blocks (zero pad -> zero scale/values).
    Counterpart of ``repro/kernels/ref.py:quantize_blockwise_ref``:
    reciprocal-multiply scale, inverse 0 for an all-zero block, round half
    to even.
    """
    qmax = float(2 ** (bits - 1) - 1)
    (n,) = x.shape
    nb = (n + block - 1) // block
    xf = torch.nn.functional.pad(x.float(), (0, nb * block - n))
    xb = xf.reshape(nb, block)
    absmax = xb.abs().amax(dim=-1)
    scale = absmax * _inv_qmax(bits).to(x.device)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.clamp(torch.round(xb * inv[:, None]), -qmax, qmax)
    return q.to(torch.int8).reshape(nb * block), scale


def dequantize_blockwise_ref(q, scales, *, block: int = 256):
    """Inverse: (nblocks*block,) int8 + (nblocks,) f32 -> f32."""
    nb = q.shape[0] // block
    if nb * block != q.shape[0]:
        raise ValueError(
            f"ragged quantized payload: {q.shape[0]} values do not fill "
            f"whole blocks of {block}")
    qb = q.reshape(nb, block).float()
    return (qb * scales[:, None]).reshape(nb * block)


def paged_decode_attention_ref(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (N, bs, Hkv, hd), float or int8
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, T) int32, < 0 = unallocated
    context_lens: torch.Tensor,  # (B,) int32
    k_scales: Optional[torch.Tensor] = None,  # (N, bs, Hkv) f32 when int8
    v_scales: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Paged single-query attention as a gather plus a masked softmax.

    Computes what ``repro/kernels/decode_attention.py:_decode_kernel`` does:
    position ``p`` of sequence ``b`` lives in block ``block_tables[b, p //
    bs]`` slot ``p % bs``; positions at or past ``context_lens[b]`` (and,
    with a window, before ``context_lens[b] - window``) are masked, and a
    sequence with ``context_lens[b] == 0`` gives zeros. Unallocated (< 0)
    table entries are clamped to block 0, as the reference does; their
    positions are always masked. Returns (B, H, hd) in q.dtype.
    """
    B, H, hd = q.shape
    _, bs, Hkv, _ = k_pool.shape
    G = H // Hkv
    T = block_tables.shape[1]
    bt = block_tables.long().clamp_min(0)
    k = k_pool[bt].float()  # (B, T, bs, Hkv, hd)
    v = v_pool[bt].float()
    if k_scales is not None:
        k = k * k_scales[bt][..., None]
        v = v * v_scales[bt][..., None]
    k = k.reshape(B, T * bs, Hkv, hd)
    v = v.reshape(B, T * bs, Hkv, hd)
    qg = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * (1.0 / math.sqrt(hd))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(T * bs, device=q.device)[None, :]
    cl = context_lens.long()[:, None]
    mask = pos < cl
    if window > 0:
        mask &= pos >= cl - window
    mask = mask[:, None, None, :]  # (B, 1, 1, T*bs)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v) / l.clamp_min(1e-30)
    return out.reshape(B, H, hd).to(q.dtype)
