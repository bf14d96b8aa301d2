"""The compressed outer exchange's wire format and per-source reductions.

Counterparts of ``repro/kernels/ref.py:aligned_block_count`` through
``rs_ag_qs_ref``: int4 nibble packing, the per-source-scale sum (THE
reduction of the int8 wire, DESIGN.md §8) and the quantized
reduce-scatter + all-gather round trip (DESIGN.md §14). In the reference
these are the oracles that its distributed transports and its simulator
share; in the port they are the simulator's main path, so every
(de)quantize inside goes through the ``kernels.ops`` wrappers and a CUDA
tensor launches the quantize and dequantize kernels.

The reference's order of operations is kept exactly, so the results agree
bit for bit: sources are summed in canonical order (row 0 first) from a
zero accumulator and the sum is multiplied by ``np.float32(1/E)``; rs/ag
slots are padded with zero blocks and each slot is packed on its own.
Elastic-membership ``weights`` are not ported (ROADMAP.md queue 1, item 9)
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def no_weights(weights) -> None:
    if weights is not None:
        raise NotImplementedError(
            "elastic-membership weights are not ported yet (ROADMAP.md queue 1, item 9)")


def aligned_block_count(n: int, block: int, align: int = 1) -> int:
    """Blocks covering ``n`` values, rounded up to a multiple of ``align``."""
    if block < 1 or align < 1:
        raise ValueError(f"block={block}, align={align} must be >= 1")
    nb = (n + block - 1) // block
    return ((nb + align - 1) // align) * align


def pack_wire(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 values -> the bytes that cross the wire.

    ``bits >= 8`` is the identity; ``bits = 4`` packs two's-complement
    nibbles two to a byte (an odd length is zero-padded), low nibble first.
    """
    if bits >= 8:
        return q
    if q.shape[0] % 2:
        q = F.pad(q, (0, 1))
    u = q.view(torch.uint8) & 0xF
    return u[0::2] | (u[1::2] << 4)


def unpack_wire(w: torch.Tensor, bits: int, nq: int) -> torch.Tensor:
    """Inverse of :func:`pack_wire`: wire bytes -> (nq,) int8 values.

    The nibble's sign is extended explicitly (``x - 16`` where ``x >= 8``),
    not by int8 shifts, whose overflow torch does not define.
    """
    if bits >= 8:
        return w
    lo = w & 0xF
    hi = (w >> 4) & 0xF
    x = torch.stack([lo, hi], dim=-1).reshape(-1)[:nq].to(torch.int8)
    return torch.where(x >= 8, x - 16, x)


def dequant_sum_sources(wg: torch.Tensor, sg: torch.Tensor, *, bits: int, block: int,
                        weights=None) -> torch.Tensor:
    """(E, nw) wire bytes + (E, nb) scales -> fp32 (nb*block,) payload mean.

    Each source is unpacked and dequantized, and the partials are added in
    source order into a zero accumulator, then multiplied by ``1/E``
    rounded once to fp32. Eager PyTorch contracts nothing, so each partial
    is added as it is made instead of being stacked first (the reference
    stacks them to keep XLA from fusing the add into the multiply).
    """
    no_weights(weights)
    E, nb = sg.shape
    nq = nb * block
    acc = torch.zeros((nq,), dtype=torch.float32, device=sg.device)
    for j in range(E):
        acc.add_(kops.dequantize_blockwise(unpack_wire(wg[j], bits, nq), sg[j], block=block))
    return acc.mul_(torch.tensor(np.float32(1.0 / E), device=acc.device))


def _pack_rows(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack each row of (E, nq) values on its own -> (E, nw)."""
    if bits >= 8:
        return q
    return torch.stack([pack_wire(q[j], bits) for j in range(q.shape[0])])


def ring_allreduce_qs_ref(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
                          bits: int = 8, weights=None) -> torch.Tensor:
    """The int8 wire ring's result: (E, nb*block) int8 + (E, nb) scales ->
    (nb*block,) fp32, each row round-tripped through its wire packing."""
    return dequant_sum_sources(_pack_rows(q, bits), scales, bits=bits, block=block,
                               weights=weights)


def wire_shard_blocks(nb: int, endpoints: int) -> int:
    """Quantization blocks per reduce-scatter slot: ``ceil(nb / E)``."""
    if endpoints < 1:
        raise ValueError(f"endpoints must be >= 1, got {endpoints}")
    return -(-nb // endpoints)


def shard_slot_wire(q: torch.Tensor, scales: torch.Tensor, *, bits: int, block: int,
                    endpoints: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One endpoint's (q, scales) -> ((E, nw_slot) wire bytes, (E, sb) scales).

    Pads with zero blocks to ``E * wire_shard_blocks(nb, E)`` blocks and
    packs each slot on its own, so an int4 nibble pair never straddles two
    slots.
    """
    nb = scales.shape[0]
    sb = wire_shard_blocks(nb, endpoints)
    qp = F.pad(q, (0, (endpoints * sb - nb) * block))
    sp = F.pad(scales, (0, endpoints * sb - nb))
    return _pack_rows(qp.reshape(endpoints, sb * block), bits), sp.reshape(endpoints, sb)


def reduce_scatter_qs_ref(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
                          bits: int = 8, weights=None) -> torch.Tensor:
    """Every endpoint's reduced shard, stacked: row ``e`` of the (E,
    sb*block) result is :func:`dequant_sum_sources` over slot ``e`` of
    every source's per-slot wire stream."""
    E = q.shape[0]
    slots = [shard_slot_wire(q[j], scales[j], bits=bits, block=block, endpoints=E)
             for j in range(E)]
    rows = []
    for e in range(E):
        wg = torch.stack([slots[j][0][e] for j in range(E)])
        sg = torch.stack([slots[j][1][e] for j in range(E)])
        rows.append(dequant_sum_sources(wg, sg, bits=bits, block=block, weights=weights))
    return torch.stack(rows)


def dequant_concat_sources(wg: torch.Tensor, sg: torch.Tensor, *, bits: int,
                           block: int) -> torch.Tensor:
    """The all-gather's reconstruction: (E, nw_slot) wire + (E, sb) scales
    -> (E*sb*block,) fp32, each slot dequantized and concatenated in slot
    order (one contributor per slot, no sum)."""
    E, sb = sg.shape
    nq = sb * block
    return torch.cat([kops.dequantize_blockwise(unpack_wire(wg[j], bits, nq), sg[j],
                                                block=block) for j in range(E)])


def rs_ag_qs_ref(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256, bits: int = 8,
                 residual2: Optional[torch.Tensor] = None, weights=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce-scatter, re-quantize behind the second residual, all-gather.

    ``q`` (E, nb*block) int8 and ``scales`` (E, nb) per endpoint;
    ``residual2`` (E, sb*block) fp32, endpoint ``e``'s second residual over
    its own reduced shard (``None`` = zeros). Returns ``(payload
    (nb*block,), new_residual2 (E, sb*block))`` with ``reduced + r2 ==
    dequant(q2, s2) + new_r2`` per slot.
    """
    nbq = q.shape[1]
    E = q.shape[0]
    reduced = reduce_scatter_qs_ref(q, scales, block=block, bits=bits, weights=weights)
    if residual2 is None:
        residual2 = torch.zeros_like(reduced)
    c2 = reduced + residual2
    s2s, w2s, deq = [], [], []
    for e in range(E):
        q2, s2 = kops.quantize_blockwise(c2[e], bits=bits, block=block)
        s2s.append(s2)
        w2s.append(pack_wire(q2, bits))
        deq.append(kops.dequantize_blockwise(q2, s2, block=block))
    new_r2 = c2 - torch.stack(deq)
    payload = dequant_concat_sources(torch.stack(w2s), torch.stack(s2s), bits=bits,
                                     block=block)
    return payload[:nbq], new_r2
