"""The int8 wire's exchange between processes: the ring all-gather and
shard-scatter kernels' wrappers, and the quantized all-reduce,
reduce-scatter and all-gather built on them.

Counterpart of ``repro/kernels/ring_allreduce.py``. What crosses between
the members of an exchange is the packed wire (int8, or int4 nibbles two
to a byte) and the fp32 block scales; the reductions are the shared ones of
``kernels/wire.py`` (``dequant_sum_sources`` in canonical source order,
``dequant_concat_sources``), so the numbers cannot depend on the
transport, and they are the simulator's numbers bit for bit.

- :func:`ring_allgather` (``csrc/ring_allgather.cu``, replaces
  ``_ring_allgather_kernel``): every member's buffer in its canonical slot.
- :func:`shard_scatter` (``csrc/shard_scatter.cu``, replaces
  ``_shard_scatter_kernel``): slot ``e`` of every member's slot stack to
  member ``e``.

The transport follows the tensor's device: a CUDA tensor launches the
kernel over the exchange's symmetric buffer (``kernels/symm.py``) or
raises (a CUDA exchange without one cannot map its peers); a CPU tensor
takes the plain version in ``kernels/ref.py`` (``torch.distributed``
collectives). The port's exchange is one ring over the linearised exchange
index, where the reference nests one ring per mesh axis in the same
canonical order; so it has one transport where the reference has "dma",
"ring" and "psum".

Several leaves go through one launch: :class:`WireLayout` packs each
leaf's wire bytes and scales at fixed 16-byte aligned offsets of one
buffer, and the per-leaf reductions run on views of the gathered rows.
The reference launches per leaf; the kernels only move bytes, so this
changes no number and makes one launch (and one set of cross-process
waits) per exchange stage.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ring_allgather_ref, shard_scatter_ref
from repro_torch.kernels.symm import PEER_TIMEOUT_S, Exchange, align16
# a module, not its names: wire imports ops, which imports this
from repro_torch.kernels import wire as W

# Launches of each CUDA kernel in this process (each wrapper adds one per
# launch and nowhere else; a caller may reset them to 0).
ring_launches = 0
scatter_launches = 0
# When a list, every launch appends (kernel name, start event, end event)
# recorded on its stream around it: the time of each launch on the card,
# waits for the peers included. None (the default) records nothing.
event_log = None

# Blocks of a launch (<= csrc/symm.cuh:kMaxBlocks, all resident at once).
NUM_BLOCKS = 32


def resolve_transport(device) -> str:
    """``"cuda-ipc"`` (the kernels over mapped peer buffers) for a CUDA
    tensor, ``"plain"`` (``torch.distributed`` collectives) for a CPU one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda-ipc"
    if dev.type == "cpu":
        return "plain"
    raise ValueError(f"no wire transport for device {dev}")


def _check_cuda(x: torch.Tensor, ex: Exchange, nbytes_needed: int, what: str):
    if ex.symm is None:
        raise RuntimeError(
            f"{what}: a CUDA tensor needs the exchange's symmetric buffer (peers mapped "
            f"with CUDA IPC); this exchange has none")
    if x.dtype != torch.uint8 or not x.is_contiguous():
        raise ValueError(f"{what} kernel takes contiguous uint8 bytes, got {x.dtype}")
    if nbytes_needed > ex.symm.capacity:
        raise ValueError(f"{what}: {nbytes_needed} bytes exceed the symmetric buffer's "
                         f"{ex.symm.capacity}")


def _events():
    if event_log is None:
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start


def _log(name: str, start) -> None:
    if start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        event_log.append((name, start, end))


def ring_allgather(x: torch.Tensor, ex: Exchange, *, timeout_s: float = PEER_TIMEOUT_S
                   ) -> torch.Tensor:
    """(n,) uint8 of this member -> (E, n): every member's in canonical slots."""
    global ring_launches
    if x.dim() != 1:
        raise ValueError(f"ring_allgather takes a flat buffer, got {tuple(x.shape)}")
    E = ex.size
    if resolve_transport(x.device) == "plain":
        return ring_allgather_ref(x, ex.group, E)
    if E == 1:
        return x.reshape(1, -1).clone()
    n = x.shape[0]
    stride = align16(n)
    _check_cuda(x, ex, E * stride, "ring_allgather")
    out = torch.empty((E, n), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out
    s = ex.symm
    ev = _events()
    err = _build.lib().ring_allgather_launch(
        x.data_ptr(), n, out.data_ptr(), s.peers, stride, ex.index, E, s.next_epoch(),
        int(timeout_s * 1e9), s.flag, NUM_BLOCKS, x.device.index or 0,
        _build.stream_ptr(x.device))
    _build.check(err, "ring_allgather")
    ring_launches += 1
    _log("ring_allgather", ev)
    return out


def shard_scatter(slots: torch.Tensor, ex: Exchange, *, timeout_s: float = PEER_TIMEOUT_S
                  ) -> torch.Tensor:
    """(E, m) uint8, row ``e`` meant for member ``e`` -> (E, m), row ``j``
    member ``j``'s slot for this member (canonical source order)."""
    global scatter_launches
    E = ex.size
    if slots.dim() != 2 or slots.shape[0] != E:
        raise ValueError(f"shard_scatter takes ({E}, m) slots, got {tuple(slots.shape)}")
    if resolve_transport(slots.device) == "plain":
        return shard_scatter_ref(slots, ex.group, E, ex.index)
    if E == 1:
        return slots.clone()
    m = slots.shape[1]
    stride = align16(m)
    _check_cuda(slots, ex, E * stride, "shard_scatter")
    out = torch.empty_like(slots)
    if m == 0:
        return out
    s = ex.symm
    ev = _events()
    err = _build.lib().shard_scatter_launch(
        slots.data_ptr(), m, out.data_ptr(), s.peers, stride, ex.index, E, s.next_epoch(),
        int(timeout_s * 1e9), s.flag, NUM_BLOCKS, slots.device.index or 0,
        _build.stream_ptr(slots.device))
    _build.check(err, "shard_scatter")
    scatter_launches += 1
    _log("shard_scatter", ev)
    return out


# ---------------------------------------------------------------------------
# packing several leaves into one launch
# ---------------------------------------------------------------------------


class WireLayout:
    """Offsets of several (wire bytes, scales) pairs in one byte buffer.

    ``sizes``: per leaf ``(wire bytes, scale count)``. Every piece starts
    16-byte aligned, so a wire view feeds the dequantize kernel's vector
    path and a scale view reinterprets as float32.
    """

    def __init__(self, sizes: Sequence[Tuple[int, int]]):
        self.sizes = [(int(w), int(b)) for w, b in sizes]
        self.offsets, off = [], 0
        for nw, nb in self.sizes:
            self.offsets.append((off, off + align16(nw)))
            off += align16(nw) + align16(4 * nb)
        self.nbytes = off

    def pack(self, pairs, out: torch.Tensor) -> torch.Tensor:
        """Write each (wire (..., nw), scales (..., nb)) pair into ``out``
        (..., nbytes) at its offsets; leading dimensions carry through."""
        for (w, s), (wo, so), (nw, nb) in zip(pairs, self.offsets, self.sizes):
            out[..., wo:wo + nw].copy_(w.view(torch.uint8))
            out[..., so:so + 4 * nb].copy_(s.contiguous().view(torch.uint8))
        return out

    def unpack(self, buf: torch.Tensor, i: int, bits: int):
        """Leaf ``i`` of ``buf`` (..., nbytes) -> (wire (..., nw), scales
        (..., nb) float32) views; the wire is int8 for ``bits >= 8``."""
        (wo, so), (nw, nb) = self.offsets[i], self.sizes[i]
        w = buf[..., wo:wo + nw]
        if bits >= 8:
            w = w.view(torch.int8)
        return w, buf[..., so:so + 4 * nb].view(torch.float32)


def gather_wire(pairs, ex: Exchange, *, bits: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every member's (wire, scales) per leaf, in one ring launch:
    ``pairs`` [(wire (nw,), scales (nb,))] -> [((E, nw), (E, nb))]."""
    layout = WireLayout([(w.shape[0], s.shape[0]) for w, s in pairs])
    dev = pairs[0][1].device
    buf = layout.pack(pairs, torch.zeros((layout.nbytes,), dtype=torch.uint8, device=dev))
    got = ring_allgather(buf, ex)
    return [layout.unpack(got, i, bits) for i in range(len(pairs))]


def scatter_wire(slot_pairs, ex: Exchange, *, bits: int
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """My slot from every member per leaf, in one scatter launch:
    ``slot_pairs`` [(wire (E, nw_slot), scales (E, sb))] -> the same shapes,
    row ``j`` from member ``j``."""
    layout = WireLayout([(w.shape[1], s.shape[1]) for w, s in slot_pairs])
    E = ex.size
    dev = slot_pairs[0][1].device
    buf = layout.pack(slot_pairs,
                      torch.zeros((E, layout.nbytes), dtype=torch.uint8, device=dev))
    got = shard_scatter(buf, ex)
    return [layout.unpack(got, i, bits) for i in range(len(slot_pairs))]


# ---------------------------------------------------------------------------
# the quantized collectives (the reference's per-leaf signatures)
# ---------------------------------------------------------------------------


def ring_allreduce_quantized_many(qs, ex: Exchange, *, bits: int, block: int,
                                  weights=None) -> List[torch.Tensor]:
    """:func:`ring_allreduce_quantized` over several leaves, one launch."""
    W.no_weights(weights)
    gathered = gather_wire([(W.pack_wire(q, bits), s) for q, s in qs], ex, bits=bits)
    return [W.dequant_sum_sources(wg, sg, bits=bits, block=block) for wg, sg in gathered]


def ring_allreduce_quantized(q: torch.Tensor, s: torch.Tensor, ex: Exchange, *, bits: int,
                             block: int, weights=None) -> torch.Tensor:
    """All-reduce one endpoint's (q (nb*block,) int8, s (nb,) fp32): the
    fp32 (nb*block,) mean of every member's dequantized payload, summed in
    canonical source order (the same bits on every member)."""
    return ring_allreduce_quantized_many([(q, s)], ex, bits=bits, block=block,
                                         weights=weights)[0]


def reduce_scatter_qs_many(qs, ex: Exchange, *, bits: int, block: int,
                           weights=None) -> List[torch.Tensor]:
    """:func:`reduce_scatter_qs` over several leaves, one launch."""
    W.no_weights(weights)
    E = ex.size
    slots = [W.shard_slot_wire(q, s, bits=bits, block=block, endpoints=E) for q, s in qs]
    got = scatter_wire(slots, ex, bits=bits)
    return [W.dequant_sum_sources(wg, sg, bits=bits, block=block) for wg, sg in got]


def reduce_scatter_qs(q: torch.Tensor, s: torch.Tensor, ex: Exchange, *, bits: int,
                      block: int, weights=None) -> torch.Tensor:
    """Quantized reduce-scatter: this member's reduced slot, fp32
    (sb*block,), ``sb = wire_shard_blocks(nb, E)`` (zero blocks pad the
    tail; each slot packed on its own)."""
    return reduce_scatter_qs_many([(q, s)], ex, bits=bits, block=block, weights=weights)[0]


def allgather_qs_many(qs, ex: Exchange, *, bits: int, block: int) -> List[torch.Tensor]:
    """:func:`allgather_qs` over several leaves, one launch."""
    gathered = gather_wire([(W.pack_wire(q, bits), s) for q, s in qs], ex, bits=bits)
    return [W.dequant_concat_sources(wg, sg, bits=bits, block=block) for wg, sg in gathered]


def allgather_qs(q2: torch.Tensor, s2: torch.Tensor, ex: Exchange, *, bits: int,
                 block: int) -> torch.Tensor:
    """Quantized all-gather: member ``e`` holds reduced slot ``e`` (q2, s2);
    returns every slot dequantized and concatenated in slot order, fp32
    (E*sb*block,), the same on every member."""
    return allgather_qs_many([(q2, s2)], ex, bits=bits, block=block)[0]
