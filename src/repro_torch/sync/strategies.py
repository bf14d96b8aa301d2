"""Concrete outer-sync strategies and the config resolver
(``repro/sync/strategies.py``).

- :class:`FlatFP32`: the fp32 mean of Δθ over the groups, the seed
  collective.
- :class:`Quantized`: each group's Δθ plus its error-feedback residual is
  blockwise quantized and dequantized (``core.outer.compress_leaf``), and
  the dequantized payloads are meaned.
- :class:`Int8Wire`: the int8 (or int4) wire format: the per-source-scale
  sum of the packed payloads in canonical order (``kernels/wire.py``);
  with ``reduce_scatter`` the quantized reduce-scatter + all-gather round
  trip behind a second residual ("rs-ag").
- :class:`Hierarchical`: an fp32 mean inside each pod first, then the
  inner strategy's exchange between the pods.
- :class:`Chunked`: the leaves dispatch as contiguous spans; numerically
  the inner strategy.

Each carries the reference's simulator model of the strategy, with the
same numerics (``sim_dispatch`` / ``sim_reduce``), and its distributed
exchange for the multi-process Trainer (``reduce_leaves``, the reference's
``reduce_leaf``): fp32 means over ``torch.distributed`` for FlatFP32,
Quantized and the hierarchical stage 1, and the int8 wire through the ring
all-gather and shard-scatter kernels (``kernels/ring_allreduce.py``). The
distributed reductions are the simulator's, so at two groups a dispatch
gives the simulator's bits. On CUDA leaves every blockwise quantize and
dequantize launches its kernel. Elastic-membership ``weights`` run through
every reduction as in the reference (``sync/base.py:weighted_stack_mean``,
``ReduceCtx.weights``): every group still compresses its payload and keeps
its own residual, and a weight-0 source adds nothing to the mean. Still
raising ``NotImplementedError``: ``Sharded`` (ROADMAP.md queue 1,
"In-group TP/FSDP, ``Sharded`` and the memory dry run") and ``Chunked``
in the Trainer (ROADMAP.md queue 1, "``Chunked`` in the Trainer").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import OuterCommConfig
from repro_torch.core.outer import OuterState, compress_leaf, outer_reduce_leaves
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ring_allreduce as RA
from repro_torch.kernels import wire
from repro_torch.launch.mesh import MeanWork, WeightedMeanWork
from repro_torch.sync.base import (OuterSyncStrategy, PendingReduce, ReduceCtx, SyncPlan,
                                   _f32, _reciprocal, balanced_spans, done, leaf_sizes,
                                   weighted_stack_mean)


def _mean_pending(payloads, residuals, ctx: ReduceCtx) -> PendingReduce:
    """The fp32 mean of ``payloads`` over the exchange (the reference's
    ``pmean``, or with ``ctx.weight`` its ``weighted_psum_mean``), started
    now and finished in ``wait``."""
    if ctx.weight is not None:
        work = WeightedMeanWork(payloads, ctx.weight, ctx.exchange.group, ctx.size)
        return PendingReduce(lambda: (work.wait(), residuals))
    if ctx.size <= 1:
        return done(payloads, residuals)
    work = MeanWork(payloads, ctx.exchange.group, ctx.size)
    return PendingReduce(lambda: (work.wait(), residuals))


def _stack_mean(x: torch.Tensor, weights) -> torch.Tensor:
    """The mean over dim 0: plain, or weighted by the membership vector."""
    return x.mean(dim=0) if weights is None else weighted_stack_mean(x, weights)


def _quantize_local(d, r, *, bits: int, block: int):
    """One group's leaf: c = Δθ + r, its (q, s), its own dequantized copy
    and the new residual ``c − local`` (what ``_quantize_rows`` gives one
    row of the simulator's stack)."""
    c = d.float()
    if r is not None:
        c = c + r.float()
    flat = c.reshape(-1)
    q, s = kops.quantize_blockwise(flat, bits=bits, block=block)
    local = kops.dequantize_blockwise(q, s, block=block)[:flat.shape[0]].reshape(c.shape)
    return q, s, local, c - local


@dataclass(frozen=True)
class FlatFP32(OuterSyncStrategy):
    """Flat fp32 mean of Δθ over the groups — the seed collective."""

    @property
    def name(self) -> str:
        return "flat-fp32"

    @torch.no_grad()
    def sim_dispatch(self, group_leaves, outer: OuterState, tc, *, mu, lr, num_pods: int = 1,
                     weights=None, inplace: bool = False):
        """Mean the G replicas, subtract the anchor, run the outer update.

        As ``strategies.py:FlatFP32.sim_dispatch`` of the reference, the
        replicas are meaned BEFORE the anchor is subtracted (the two orders
        agree in exact arithmetic, not in floating point). The work goes one
        leaf at a time, so the fp32 mean, Δθ and target temporaries are one
        leaf's size. ``inplace`` updates the fp32 outer state in place
        (``core.outer.outer_reduce_leaves``). ``weights`` means the replicas
        by the membership vector (``weighted_stack_mean``).
        """
        if weights is not None:
            weights = _f32(weights, outer.anchor[0].device)
        targets, moms, anchors = [], [], []
        for i, (m, a) in enumerate(zip(outer.momentum, outer.anchor)):
            stacked = torch.stack([g[i].float() for g in group_leaves])
            delta = _stack_mean(stacked, weights) - a.float()
            del stacked
            t, mm, an = outer_reduce_leaves([m], [a], [delta], tc, mu=mu, lr=lr,
                                            inplace=inplace)
            targets += t
            moms += mm
            anchors += an
        return targets, outer._replace(momentum=moms, anchor=anchors,
                                       num_syncs=outer.num_syncs + 1)

    def sim_reduce_leaf(self, delta, residual, tc, *, num_pods=1, pod_grouped=False,
                        weights=None):
        return _stack_mean(delta, weights), residual

    def reduce_leaves(self, deltas, residuals, tc, ctx: ReduceCtx) -> PendingReduce:
        """The fp32 mean of Δθ over the exchange (the reference's ``pmean``).

        Δθ is taken before the mean here, after it in :meth:`sim_dispatch`,
        as in the reference; the two orders differ in the last bits."""
        return _mean_pending(list(deltas), residuals, ctx)


@dataclass(frozen=True)
class Quantized(OuterSyncStrategy):
    """Blockwise-quantized Δθ payload with error feedback: each group's
    dequantized payload (what int8 + scales deliver) is exchanged at fp32
    width, and what quantization dropped stays in its residual."""

    bits: int = 8
    block: int = 256

    needs_residual = True

    @property
    def name(self) -> str:
        return f"quantized(int{self.bits},block={self.block})"

    def sim_reduce_leaf(self, delta, residual, tc, *, num_pods=1, pod_grouped=False,
                        weights=None):
        payloads, new_r = [], []
        for g in range(delta.shape[0]):
            p, r = compress_leaf(delta[g], None if residual is None else residual[g],
                                 bits=self.bits, block=self.block)
            payloads.append(p)
            new_r.append(r)
        return _stack_mean(torch.stack(payloads), weights), torch.stack(new_r)

    def reduce_leaves(self, deltas, residuals, tc, ctx: ReduceCtx) -> PendingReduce:
        """Compress this group's Δθ with error feedback, then the fp32 mean
        of the dequantized payloads over the exchange."""
        rs = residuals if residuals is not None else [None] * len(deltas)
        out = [compress_leaf(d, r, bits=self.bits, block=self.block)
               for d, r in zip(deltas, rs)]
        return _mean_pending([p for p, _ in out], [r for _, r in out], ctx)


def _quantize_rows(c: torch.Tensor, *, bits: int, block: int):
    """(G, ...) fp32 -> (q (G, nq) int8, s (G, nb) fp32, local payload
    (G, ...) fp32): each group's quantize and its own dequantized copy."""
    G = c.shape[0]
    flat = c.reshape(G, -1)
    n = flat.shape[1]
    qs = [kops.quantize_blockwise(flat[g], bits=bits, block=block) for g in range(G)]
    q = torch.stack([x for x, _ in qs])
    s = torch.stack([x for _, x in qs])
    local = torch.stack([kops.dequantize_blockwise(q[g], s[g], block=block)[:n]
                         for g in range(G)])
    return q, s, local.reshape(c.shape)


@dataclass(frozen=True)
class Int8Wire(OuterSyncStrategy):
    """The int8 (or int4) wire format with per-source-scale sum semantics.

    Same quantization and error feedback as :class:`Quantized`, but the
    reduction is the wire ring's: every endpoint's packed payload is
    dequantized and summed in canonical source order, times ``1/E``
    (``kernels/wire.py:dequant_sum_sources``). ``reduce_scatter=True`` is
    the rs-ag path: endpoint ``e`` reduces slot ``e`` of every source,
    re-quantizes it behind a second residual (``OuterState.residual2``)
    and all-gathers the slots.
    """

    bits: int = 8
    block: int = 256
    reduce_scatter: bool = False

    needs_residual = True

    @property
    def needs_residual2(self) -> bool:  # type: ignore[override]
        return self.reduce_scatter

    @property
    def name(self) -> str:
        if self.reduce_scatter:
            return f"rs-ag(int{self.bits},block={self.block})"
        return f"int{self.bits}-wire(block={self.block})"

    @property
    def wire_format(self) -> str:  # type: ignore[override]
        if self.reduce_scatter:
            return f"int{self.bits}+scales/rs-ag"
        return f"int{self.bits}+scales"

    def wire_bytes_per_param(self, tc) -> float:
        return self.bits / 8.0 + 4.0 / self.block

    def sim_reduce_leaf(self, delta, residual, tc, *, num_pods=1, pod_grouped=False,
                        weights=None):
        """The ring's model: under ``pod_grouped`` its endpoints are the
        pods, one representative each (every group still quantizes, so its
        residual is its own), and so are their weights."""
        if self.reduce_scatter:
            return self._sim_reduce_rs_ag(delta, residual, pod_grouped=pod_grouped,
                                          weights=weights)
        bits, block = self.bits, self.block
        src_w = weights
        if weights is not None and pod_grouped:
            src_w = _f32(weights, delta.device).reshape(max(num_pods, 1), -1)[:, 0]
        c = delta.float()
        if residual is not None:
            c = c + residual.float()
        n = c[0].numel()
        q, s, local = _quantize_rows(c, bits=bits, block=block)
        new_r = c - local
        if pod_grouped:
            G, P = q.shape[0], max(num_pods, 1)
            q = q.reshape(P, G // P, -1)[:, 0]
            s = s.reshape(P, G // P, -1)[:, 0]
        avg = wire.ring_allreduce_qs_ref(q, s, block=block, bits=bits, weights=src_w)
        return avg[:n].reshape(c.shape[1:]), new_r

    def reduce_leaves(self, deltas, residuals, tc, ctx: ReduceCtx) -> PendingReduce:
        """Quantize this group's Δθ + residual, all-gather every member's
        packed wire and scales (one ring launch for all leaves on the card)
        and reduce them in canonical source order: ``sim_reduce_leaf``'s
        numbers. With one member the local dequantized payload returns, as
        the reference's ``reduce_leaf`` does."""
        if self.reduce_scatter:
            return self._reduce_leaves_rs_ag(deltas, residuals, ctx)
        bits, block = self.bits, self.block
        rs = residuals if residuals is not None else [None] * len(deltas)
        local = [_quantize_local(d, r, bits=bits, block=block) for d, r in zip(deltas, rs)]
        new_r = [x[3] for x in local]
        if ctx.size <= 1:
            return done([x[2] for x in local], new_r)
        avgs = RA.ring_allreduce_quantized_many([(q, s) for q, s, _, _ in local], ctx.exchange,
                                                bits=bits, block=block, weights=ctx.weights)
        return done([a[:d.numel()].reshape(d.shape) for a, d in zip(avgs, deltas)], new_r)

    def _reduce_leaves_rs_ag(self, deltas, residuals, ctx: ReduceCtx) -> PendingReduce:
        """The reduce-scatter + all-gather exchange (``_sim_reduce_rs_ag``
        per member): one scatter launch, the second error feedback on this
        member's reduced slot, one ring launch. Each residual pair comes in
        and goes out as ``(r1, r2)``; ``r2`` is stored full size, zero
        outside this member's own slot."""
        bits, block = self.bits, self.block
        rs = residuals if residuals is not None else [(None, None)] * len(deltas)
        local = [_quantize_local(d, r1, bits=bits, block=block)
                 for d, (r1, _) in zip(deltas, rs)]
        E, idx = ctx.size, ctx.index
        if E <= 1:
            return done([x[2] for x in local],
                        [(x[3], r2 if r2 is not None else torch.zeros_like(x[3]))
                         for x, (_, r2) in zip(local, rs)])
        reduced = RA.reduce_scatter_qs_many([(q, s) for q, s, _, _ in local], ctx.exchange,
                                            bits=bits, block=block, weights=ctx.weights)
        q2s, shards = [], []
        for (q, s, _, _), (_, r2), red, d in zip(local, rs, reduced, deltas):
            n = d.numel()
            slot = wire.wire_shard_blocks(s.shape[0], E) * block
            if r2 is None:
                r2_shard = torch.zeros((slot,), dtype=torch.float32, device=d.device)
            else:
                r2_shard = F.pad(r2.float().reshape(-1), (0, E * slot - n))[
                    idx * slot:(idx + 1) * slot]
            c2 = red + r2_shard
            q2, s2 = kops.quantize_blockwise(c2, bits=bits, block=block)
            shards.append(c2 - kops.dequantize_blockwise(q2, s2, block=block)[:slot])
            q2s.append((q2, s2))
        gathered = RA.allgather_qs_many(q2s, ctx.exchange, bits=bits, block=block)
        payloads, new_rs = [], []
        for (_, _, _, new_r1), shard, full, d in zip(local, shards, gathered, deltas):
            n, slot = d.numel(), shard.shape[0]
            new_r2 = torch.zeros((E * slot,), dtype=torch.float32, device=d.device)
            new_r2[idx * slot:(idx + 1) * slot] = shard
            payloads.append(full[:n].reshape(d.shape))
            new_rs.append((new_r1, new_r2[:n].reshape(d.shape)))
        return done(payloads, new_rs)

    def _sim_reduce_rs_ag(self, delta, residual, *, pod_grouped=False, weights=None):
        """The rs/ag round trip (``kernels/wire.py:rs_ag_qs_ref``): the G
        groups are the endpoints. Each group's second residual is stored
        full-size, zero outside its own slot."""
        if pod_grouped:
            raise ValueError(
                "the rs/ag wire path does not compose with the hierarchical two-stage "
                "reduce: the reduce-scatter already owns the slow-axis layout")
        bits, block = self.bits, self.block
        r1, r2 = residual if isinstance(residual, tuple) else (residual, None)
        c = delta.float()
        if r1 is not None:
            c = c + r1.float()
        G = c.shape[0]
        n = c[0].numel()
        q, s, local = _quantize_rows(c, bits=bits, block=block)
        new_r1 = c - local
        E = G
        if E <= 1:
            return local[0], (new_r1, r2 if r2 is not None else torch.zeros_like(c))
        sb = wire.wire_shard_blocks(s.shape[1], E)
        slot = sb * block
        diag = torch.arange(E, device=c.device)
        if r2 is None:
            r2_shards = torch.zeros((E, slot), dtype=torch.float32, device=c.device)
        else:  # endpoint g's full-size residual -> its own slot g
            r2_pad = F.pad(r2.float().reshape(G, -1), (0, E * slot - n))
            r2_shards = r2_pad.reshape(E, E, slot)[diag, diag]
        payload, new_r2_shards = wire.rs_ag_qs_ref(q, s, block=block, bits=bits,
                                                   residual2=r2_shards, weights=weights)
        new_r2 = torch.zeros((E, E, slot), dtype=torch.float32, device=c.device)
        new_r2[diag, diag] = new_r2_shards
        new_r2 = new_r2.reshape(E, E * slot)[:, :n].reshape(c.shape)
        return payload[:n].reshape(c.shape[1:]), (new_r1, new_r2)


@dataclass(frozen=True)
class Hierarchical(OuterSyncStrategy):
    """Two-stage reduce: an fp32 mean inside each pod, then ``inner``'s
    exchange between the pods (with one pod, the global mean once)."""

    inner: OuterSyncStrategy = FlatFP32()

    def __post_init__(self):
        if self.inner.needs_residual2:
            raise ValueError(
                "Hierarchical cannot compose the reduce-scatter wire path: the rs/ag "
                "exchange already owns the slow-axis layout; use int8-wire under "
                "Hierarchical, or rs-ag flat")

    @property
    def name(self) -> str:
        return f"hierarchical[{self.inner.name}]"

    @property
    def needs_residual(self) -> bool:  # type: ignore[override]
        return self.inner.needs_residual

    @property
    def wire_format(self) -> str:  # type: ignore[override]
        return self.inner.wire_format

    def wire_bytes_per_param(self, tc) -> float:
        return self.inner.wire_bytes_per_param(tc)

    def sim_reduce_leaf(self, delta, residual, tc, *, num_pods=1, pod_grouped=False,
                        weights=None):
        """Every group of a pod gets the pod's mean (so the residuals stay
        pod-identical), then the inner strategy reduces over the pods. With
        ``weights`` the pod mean is weighted, and the inner reduction weighs
        each pod by its live weight sum (on every entry of the pod)."""
        P = max(num_pods, 1)
        G = delta.shape[0]
        validate_pod_grouping(G, P)
        dp = delta.reshape(P, G // P, *delta.shape[1:])
        entry_w = None
        if weights is None:
            pod_mean = dp.mean(dim=1, keepdim=True)
        else:
            w = _f32(weights, delta.device)
            wp = w.reshape((P, G // P) + (1,) * (delta.dim() - 1))
            sw = wp.sum(dim=1, keepdim=True)
            pod_mean = (dp * wp).sum(dim=1, keepdim=True) * _reciprocal(sw)
            pw = w.reshape(P, -1)
            entry_w = pw.sum(dim=1, keepdim=True).expand(pw.shape).reshape(-1)
        delta = pod_mean.expand(P, G // P, *delta.shape[1:]).reshape(delta.shape)
        return self.inner.sim_reduce_leaf(delta, residual, tc, num_pods=num_pods,
                                          pod_grouped=True, weights=entry_w)

    def reduce_leaves(self, deltas, residuals, tc, ctx: ReduceCtx) -> PendingReduce:
        """Stage 1: the fp32 mean over this pod's groups (the fast
        exchange), finished before stage 2 starts; stage 2: the inner
        strategy over the pods (the slow exchange). With membership weights
        stage 1 is the weighted mean (a pod of one group scales and
        normalises too, as the reference's size-one axis does), and stage 2
        weighs each pod by its live weight sum (a dead pod exchanges a zero
        payload at weight 0)."""
        fast = ctx.fast
        inner_ctx = ctx.narrowed() if ctx.slow is not None else ctx
        if ctx.weight is not None:
            if fast is None:
                raise ValueError("a weighted hierarchical reduce needs the fast exchange")
            deltas = WeightedMeanWork(list(deltas), ctx.weight, fast.group, fast.size).wait()
            # per-pod weight sums in pod order (the group order is pod-major)
            pod_vec = np.asarray(ctx.weights, np.float32).reshape(inner_ctx.size, -1).sum(1)
            inner_ctx = inner_ctx.with_membership(pod_vec.tolist(),
                                                  float(pod_vec[inner_ctx.index]))
        elif fast is not None and fast.size > 1:
            deltas = MeanWork(list(deltas), fast.group, fast.size).wait()
        return self.inner.reduce_leaves(deltas, residuals, tc, inner_ctx)


@dataclass(frozen=True)
class Chunked(OuterSyncStrategy):
    """Span combinator: the leaves dispatch as ``num_chunks`` contiguous
    spans of about equal size. Numerically ``inner``: the simulator
    dispatches the plan as one computation, as the reference's does, and
    applies it span by span."""

    inner: OuterSyncStrategy = FlatFP32()
    num_chunks: int = 2

    def __post_init__(self):
        if self.inner.needs_residual2:
            raise ValueError(
                "Chunked cannot (yet) compose the reduce-scatter wire path; use rs-ag "
                "with chunks=1")

    @property
    def name(self) -> str:
        return f"chunked({self.num_chunks})[{self.inner.name}]"

    @property
    def needs_residual(self) -> bool:  # type: ignore[override]
        return self.inner.needs_residual

    @property
    def wire_format(self) -> str:  # type: ignore[override]
        return self.inner.wire_format

    def wire_bytes_per_param(self, tc) -> float:
        return self.inner.wire_bytes_per_param(tc)

    def plan(self, leaves, tc) -> SyncPlan:
        sizes = leaf_sizes(leaves)
        # no more chunks than leaves; an empty list keeps one empty span
        chunks = max(1, min(self.num_chunks, len(sizes)))
        spans = balanced_spans(sizes, chunks) if sizes else ((0, 0),)
        return SyncPlan(num_leaves=len(sizes), spans=spans,
                        needs_residual=self.needs_residual, name=self.name,
                        wire_format=self.wire_format)

    def reduce_leaves(self, deltas, residuals, tc, ctx):
        raise NotImplementedError(
            "Chunked is not ported to the multi-process Trainer yet (per-span dispatch "
            "and apply over torch.distributed; ROADMAP.md queue 1, \"Chunked in the "
            "Trainer\")")

    def sim_dispatch(self, group_leaves, outer, tc, *, mu, lr, num_pods: int = 1,
                     weights=None, inplace: bool = False):
        return self.inner.sim_dispatch(group_leaves, outer, tc, mu=mu, lr=lr,
                                       num_pods=num_pods, weights=weights, inplace=inplace)

    def sim_reduce_leaf(self, delta, residual, tc, *, num_pods=1, pod_grouped=False,
                        weights=None):
        return self.inner.sim_reduce_leaf(delta, residual, tc, num_pods=num_pods,
                                          pod_grouped=pod_grouped, weights=weights)


# the strategies the simulator runs (``Sharded`` is not ported)
PORTED = (FlatFP32, Quantized, Int8Wire, Hierarchical, Chunked)


def validate_pod_grouping(num_groups: int, num_pods: int) -> None:
    """The G groups split into ``num_pods`` equal pods; fail early if not."""
    P = max(int(num_pods), 1)
    if num_groups % P != 0:
        raise ValueError(
            f"hierarchical reduce needs num_pods ({P}) to divide the group count "
            f"({num_groups}); got {num_groups} % {P} = {num_groups % P}")


def resolve_strategy(cfg) -> OuterSyncStrategy:
    """Map an ``OuterCommConfig`` (or a ``TrainConfig`` carrying one) onto
    the strategy object, composed as the reference composes it: core, then
    Hierarchical, then Chunked. ``sharded`` raises ``NotImplementedError``."""
    comm = getattr(cfg, "outer_comm", cfg)
    core: OuterSyncStrategy
    if comm.compression == "quantize":
        core = Quantized(bits=comm.bits, block=comm.block)
    elif comm.compression == "int8-wire":
        core = Int8Wire(bits=comm.bits, block=comm.block)
    elif comm.compression == "rs-ag":
        core = Int8Wire(bits=comm.bits, block=comm.block, reduce_scatter=True)
    elif comm.compression == "none":
        core = FlatFP32()
    else:
        raise ValueError(f"unknown outer compression {comm.compression!r}")
    if comm.sharded:
        raise NotImplementedError(
            "the Sharded outer strategy is not ported yet: its layout is the "
            "in-group mesh's (ROADMAP.md queue 1, \"In-group TP/FSDP, Sharded and the "
            "memory dry run\")")
    if comm.hierarchical:
        core = Hierarchical(inner=core)
    if comm.chunks > 1:
        core = Chunked(inner=core, num_chunks=comm.chunks)
    return core


def strategy_name(*, bits: int = 32, block: int = 256, hierarchical: bool = False,
                  chunks: int = 1, sharded: bool = False,
                  compression: Optional[str] = None) -> str:
    """Resolved strategy name for benchmark knobs (``bits >= 32`` = fp32;
    ``compression=None`` infers fp32 or blockwise quantize from ``bits``)."""
    if compression is None:
        compression = "none" if bits >= 32 else "quantize"
    comm = OuterCommConfig(compression=compression, bits=bits if bits < 32 else 8,
                           block=block, hierarchical=hierarchical, chunks=chunks,
                           sharded=sharded)
    return resolve_strategy(comm).name
