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


def _scores_and_mask(q, k, *, causal: bool, window: int, softcap: float):
    """fp32 scores (B, Hkv, G, S, Skv) after scale and softcap, and the mask.

    Keys of another length than the queries (``Skv != S``, cross-attention)
    are taken only without a mask: every query sees every key, as the
    reference's ``gqa_attention`` with ``q_positions = Skv`` gives
    (``repro/models/attention.py:241-244``).
    """
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Skv != S and (causal or window > 0):
        raise ValueError(f"flash_attention: keys of length {Skv} for {S} queries take "
                         f"neither a causal mask nor a window")
    qg = q.float().reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    pos = torch.arange(S, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    return s, mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """GQA attention. q: (B,S,H,hd); k/v: (B,Skv,Hkv,hd) -> (B,S,H,hd) in
    q.dtype (``Skv != S`` without a mask only).

    Counterpart of ``repro/kernels/ref.py:flash_attention_ref``.
    """
    B, S, H, hd = q.shape
    s, mask = _scores_and_mask(q, k, causal=causal, window=window, softcap=softcap)
    probs = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """The forward kernel's outputs when the backward needs them:
    (out (B,S,H,hd) in q.dtype, lse fp32 (B,H,S)), where lse is each row's
    log-sum-exp of the scaled, softcapped, masked scores."""
    B, S, H, hd = q.shape
    s, mask = _scores_and_mask(q, k, causal=causal, window=window, softcap=softcap)
    lse = torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)  # (B, Hkv, G, S)
    out = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return out, lse.reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """Plain version of the backward kernels (FlashAttention-2 algebra).

    Recomputes P = exp(s - lse) from the forward's log-sum-exp, then
    D = rowsum(dO * O), dS = P (dO V^T - D) / sqrt(hd) (times
    1 - tanh^2(s / c) with a softcap c), dQ = dS K, dK = dS^T Q summed over
    each kv head's query group, dV = P^T dO. fp32 math; (dq, dk, dv) in the
    inputs' dtypes.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    s, mask = _scores_and_mask(q, k, causal=causal, window=window, softcap=softcap)
    L = lse.float().reshape(B, Hkv, G, S)[..., None]
    p = torch.where(mask, torch.exp(s - L), 0.0)
    do = dout.float().reshape(B, S, Hkv, G, hd)
    dvals = (dout.float() * out.float()).sum(-1)  # (B, S, H)
    D = dvals.permute(0, 2, 1).reshape(B, Hkv, G, S)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - D) * (1.0 / math.sqrt(hd))
    if softcap > 0:
        ds = ds * (1.0 - torch.square(s / softcap))
    qg = q.float().reshape(B, S, Hkv, G, hd)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(B, S, H, hd)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def pier_update_ref(anchor, momentum, delta, *, mu, lr,
                    formulation: str = "nesterov_torch"):
    """Fused outer-update oracle (Alg. 2 lines 20-21), fp32 math.

    Counterpart of ``repro/kernels/ref.py:pier_update_ref``: returns
    (new_params fp32, new_momentum fp32). ``mu`` and ``lr`` are rounded to
    fp32 once, as the reference's traced fp32 scalars are; every product and
    sum is a separate fp32 operation.
    """
    mu = torch.tensor(np.float32(mu), device=momentum.device)
    lr = torch.tensor(np.float32(lr), device=momentum.device)
    mf = momentum.float()
    af = anchor.float()
    df = delta.float()
    m_new = mu * mf + df
    if formulation == "nesterov_torch":
        step = mu * m_new + df
    elif formulation == "nesterov_classic":
        step = mu * mf + df
    elif formulation == "sgd":
        step = m_new
    else:
        raise ValueError(formulation)
    return af + lr * step, m_new


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    """Row RMSNorm oracle. x: (..., D); scale: (D,).

    Counterpart of ``repro/kernels/ref.py:rmsnorm_ref``: x in fp32, the mean
    of squares, ``rsqrt(ms + eps)``, times the scale in fp32, cast back to
    x's dtype. Autograd through it is the CPU's gradient.
    """
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of :func:`rmsnorm_ref` -> (dx in x's dtype, dscale fp32).

    With r = rsqrt(mean(x^2) + eps) per row and g = dy:
    dx = r s g - x r^3 (sum_j g_j s_j x_j) / D, dscale = sum over rows of
    g x r, all in fp32. The reference has no such function (it
    differentiates XLA); this is what the backward kernel computes.
    """
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    gf = dy.float().reshape(-1, D)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gs = gf * scale.float()
    c = (gs * xf).sum(dim=-1, keepdim=True)
    dx = r * gs - xf * (r * r * r) * (c / D)
    dscale = (gf * xf * r).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dscale


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


def ring_allgather_ref(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Plain version of the ring all-gather: every member's flat ``x`` in
    canonical slots, ``(size, n)``. ``group`` is a ``torch.distributed``
    process group whose members, in rank order, are the canonical sources
    (``None`` when ``size`` is 1). Each member passes the same length."""
    import torch.distributed as dist

    if size == 1:
        return x.reshape(1, -1).clone()
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def shard_scatter_ref(slots: torch.Tensor, group, size: int, index: int) -> torch.Tensor:
    """Plain version of the shard scatter: ``slots`` (E, m), slot ``e``
    meant for member ``e`` -> (E, m), row ``j`` the slot ``index`` of member
    ``j``. An all-gather of the slot stacks and this member's column (the
    reference's one-hot lane; gloo has no all-to-all on every build)."""
    if size == 1:
        return slots.clone()
    every = ring_allgather_ref(slots.reshape(-1), group, size)  # (E, E*m)
    return every.reshape(size, size, -1)[:, index].contiguous()
