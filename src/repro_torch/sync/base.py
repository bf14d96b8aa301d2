"""The outer-sync strategy protocol (``repro/sync/base.py``, DESIGN.md §7).

An :class:`OuterSyncStrategy` owns the host-side plan of an outer sync
(:meth:`~OuterSyncStrategy.plan`: contiguous leaf spans, whether the state
carries error-feedback residuals) and the simulator's numeric model of the
reduction over the groups' replicas (:meth:`~OuterSyncStrategy.sim_dispatch`
and the per-leaf :meth:`~OuterSyncStrategy.sim_reduce_leaf`), and the
multi-process Trainer's exchange: :meth:`~OuterSyncStrategy.reduce_leaves`
over a :class:`ReduceCtx` (the reference's ``reduce_leaf``, one leaf at a
time there, a list of leaves here so that a stage takes one collective or
one kernel launch), finished by :meth:`PendingReduce.wait`.

The port works one leaf at a time where the reference maps over the whole
tree, so that the temporaries of a dispatch (the G deltas, the quantized
payloads, the new residuals) are one leaf's size.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.outer import OuterState, outer_reduce_leaves
from repro_torch.kernels.symm import Exchange
from repro_torch.kernels.wire import no_weights


class SyncPlan(NamedTuple):
    """Host-side dispatch plan for one strategy × parameter list.

    ``spans`` are contiguous ``[lo, hi)`` ranges of leaf indices, each
    dispatched (and applied) on its own. ``wire_format`` names what crosses
    the slow exchange (``"fp32"``, ``"int8+scales"``, ...). The reference's
    ``transport`` field comes with the distributed exchange.
    """

    num_leaves: int
    spans: Tuple[Tuple[int, int], ...]
    needs_residual: bool
    name: str
    wire_format: str = "fp32"
    needs_residual2: bool = False

    @property
    def num_chunks(self) -> int:
        return len(self.spans)


@dataclass(frozen=True)
class ReduceCtx:
    """What a distributed reduce runs over (``repro/sync/base.py:ReduceCtx``).

    ``exchange`` is what the payload exchange reduces over: the ranks of
    every group that share this rank's ``data_inner`` index, in canonical
    source order. ``fast`` and ``slow`` split it by pod for the
    hierarchical reduce (:meth:`narrowed` moves to the slow stage). The
    reference's axis names, sizes and coordinates become the exchange's
    process group, its size and this rank's index. Elastic ``weights`` are
    not ported (ROADMAP.md queue 1, item 9) and raise.
    """

    exchange: Exchange
    fast: Optional[Exchange] = None
    slow: Optional[Exchange] = None
    weights: Optional[Any] = None

    def __post_init__(self):
        no_weights(self.weights)

    @property
    def size(self) -> int:
        return self.exchange.size

    @property
    def index(self) -> int:
        return self.exchange.index

    def narrowed(self) -> "ReduceCtx":
        """The context of the hierarchical stage 2: the exchange across pods."""
        if self.slow is None:
            raise ValueError("ReduceCtx.narrowed needs the slow (across-pod) exchange")
        return dataclasses.replace(self, exchange=self.slow, fast=None, slow=None)


class PendingReduce:
    """A started reduce: :meth:`wait` gives ``(payloads, new residuals)``.

    ``finish`` runs in :meth:`wait` (the end of a gloo collective started
    with ``async_op=True``); the wire strategies' kernels are enqueued on
    the caller's stream when the reduce starts, and their results wait
    here as they are.
    """

    def __init__(self, finish: Callable[[], Tuple[List[torch.Tensor], Any]]):
        self._finish = finish
        self._result = None

    def wait(self):
        if self._finish is not None:
            self._result = self._finish()
            self._finish = None
        return self._result


def done(payloads, residuals) -> PendingReduce:
    return PendingReduce(lambda: (payloads, residuals))


def balanced_spans(sizes, num_chunks: int) -> Tuple[Tuple[int, int], ...]:
    """Split leaf indices into <= num_chunks contiguous spans of about equal
    element count. Every span is non-empty."""
    n = len(sizes)
    num_chunks = max(1, min(num_chunks, n))
    total = sum(sizes)
    spans, lo, acc = [], 0, 0
    for i, s in enumerate(sizes):
        acc += s
        # close the span once it reaches its fair share, keeping enough
        # leaves behind for the remaining chunks
        remaining_chunks = num_chunks - len(spans)
        if (acc >= total * (len(spans) + 1) / num_chunks
                and n - (i + 1) >= remaining_chunks - 1) or i == n - 1:
            spans.append((lo, i + 1))
            lo = i + 1
            if len(spans) == num_chunks:
                break
    if lo < n:  # fold any tail into the last span
        spans[-1] = (spans[-1][0], n)
    return tuple(spans)


def leaf_sizes(leaves):
    """Element counts of ``leaves`` (anything with a ``shape``)."""
    return [math.prod(int(d) for d in leaf.shape) for leaf in leaves]


class OuterSyncStrategy:
    """Base class of the outer-sync strategies."""

    # whether the state carries a per-group error-feedback residual
    needs_residual: bool = False
    # whether it also carries the rs/ag gather leg's residual; then
    # ``sim_reduce_leaf`` takes and returns the residual as an (r1, r2) pair
    needs_residual2: bool = False
    wire_format: str = "fp32"

    @property
    def name(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"

    def plan(self, leaves, tc) -> SyncPlan:
        """One fused span over every leaf (``leaves``: anything with a
        ``shape``, in leaf order)."""
        n = len(leaves)
        return SyncPlan(num_leaves=n, spans=((0, n),), needs_residual=self.needs_residual,
                        name=self.name, wire_format=self.wire_format,
                        needs_residual2=self.needs_residual2)

    def reduce_leaves(self, deltas: List[torch.Tensor], residuals, tc,
                      ctx: ReduceCtx) -> PendingReduce:
        """This rank's Δθ leaves -> the started exchange of the outer sync.

        ``residuals`` is a list of this group's residual leaves (or of
        ``(r1, r2)`` pairs with :attr:`needs_residual2`), or ``None``; the
        new ones come back the same way. Every leaf of the plan goes in one
        call, so a stage makes one collective or one kernel launch.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no distributed reduce in the port")

    def reduce_leaf(self, d, r, tc, ctx: ReduceCtx):
        """One leaf, the reference's signature: (payload, new residual)."""
        payloads, res = self.reduce_leaves([d], None if r is None else [r], tc, ctx).wait()
        return payloads[0], None if res is None else res[0]

    def wire_bytes_per_param(self, tc) -> float:
        """Modeled slow-exchange width in bytes per parameter: 4.0 for the
        fp32 collectives (``Quantized`` exchanges its dequantized payload in
        fp32); the wire strategies give ``bits/8 + 4/block``."""
        return 4.0

    @torch.no_grad()
    def sim_dispatch(self, group_leaves, outer: OuterState, tc, *, mu, lr, num_pods: int = 1,
                     weights=None, inplace: bool = False):
        """(G lists of leaves) + outer state -> (target_f32 leaves, new outer).

        Per leaf, as ``repro/sync/base.py:OuterSyncStrategy.sim_dispatch``:
        the G deltas ``θ_g − anchor`` (subtract, *then* reduce, unlike
        :class:`~repro_torch.sync.strategies.FlatFP32`), the strategy's
        :meth:`sim_reduce_leaf`, then the outer update. Every delta of a
        leaf is taken before the update may overwrite that leaf's anchor.
        ``inplace`` updates the fp32 momentum and anchor in place
        (``core.outer.outer_reduce_leaves``) and writes each new residual
        over the old one.
        """
        no_weights(weights)
        targets, moms, anchors, res = [], [], [], ([], [])
        G = len(group_leaves)
        for i, (m, a) in enumerate(zip(outer.momentum, outer.anchor)):
            af = a.float()
            delta = torch.empty((G, *a.shape), dtype=torch.float32, device=a.device)
            for g, leaves in enumerate(group_leaves):
                torch.sub(leaves[i].float(), af, out=delta[g])
            r = outer.residual[i] if outer.residual is not None else None
            if self.needs_residual2:
                r = (r, outer.residual2[i] if outer.residual2 is not None else None)
            payload, new_r = self.sim_reduce_leaf(delta, r, tc, num_pods=num_pods)
            del delta
            new_rs = new_r if self.needs_residual2 else (
                new_r, outer.residual2[i] if outer.residual2 is not None else None)
            for k, (old, new) in enumerate(zip((outer.residual, outer.residual2), new_rs)):
                if new is None:
                    continue
                if inplace and old is not None and new is not old[i]:
                    new = old[i].copy_(new)
                res[k].append(new)
            t, mm, an = outer_reduce_leaves([m], [a], [payload], tc, mu=mu, lr=lr,
                                            inplace=inplace)
            targets += t
            moms += mm
            anchors += an
        return targets, OuterState(momentum=moms, anchor=anchors,
                                   num_syncs=outer.num_syncs + 1,
                                   residual=res[0] or None, residual2=res[1] or None)

    def sim_reduce_leaf(self, delta, residual, tc, *, num_pods: int = 1,
                        pod_grouped: bool = False):
        """One leaf's (G, ...) fp32 Δθ stack -> (averaged payload, new residual).

        ``residual`` is the leaf's (G, ...) residual, ``None``, or the
        ``(r1, r2)`` pair when :attr:`needs_residual2`. ``pod_grouped``
        (set by :class:`~repro_torch.sync.strategies.Hierarchical` after its
        pod mean) marks the entries as pod-duplicated: the exchange's
        endpoints are then the ``num_pods`` pods.
        """
        raise NotImplementedError

    def sim_reduce(self, delta, residual, tc, *, num_pods: int = 1, pod_grouped: bool = False,
                   weights=None):
        """:meth:`sim_reduce_leaf` over lists of leaves, the reference's tree
        signature: ``residual`` is a list, ``None``, or (with
        :attr:`needs_residual2`) a pair of lists, and so is the new one."""
        no_weights(weights)
        n = len(delta)
        if self.needs_residual2:
            r1, r2 = residual if isinstance(residual, tuple) else (residual, None)
            rs = list(zip(r1 if r1 is not None else [None] * n,
                          r2 if r2 is not None else [None] * n))
        else:
            rs = residual if residual is not None else [None] * n
        out = [self.sim_reduce_leaf(d, r, tc, num_pods=num_pods, pod_grouped=pod_grouped)
               for d, r in zip(delta, rs)]
        payload = [p for p, _ in out]
        if self.needs_residual2:
            return payload, ([r[0] for _, r in out], [r[1] for _, r in out])
        if residual is None and not self.needs_residual:
            return payload, None
        return payload, [r for _, r in out]
