"""Concrete outer-sync strategies and the config resolver
(``repro/sync/strategies.py``).

Only :class:`FlatFP32`, the seed collective, is ported. The quantized,
int8-wire, rs-ag, sharded, hierarchical and chunked strategies come with
later slices (ROADMAP.md queue 1); :func:`resolve_strategy` raises
``NotImplementedError`` for a configuration that needs one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.outer import OuterState, outer_reduce_leaves
from repro_torch.sync.base import OuterSyncStrategy


@dataclass(frozen=True)
class FlatFP32(OuterSyncStrategy):
    """Flat fp32 mean of Δθ over the groups — the seed collective."""

    @property
    def name(self) -> str:
        return "flat-fp32"

    @torch.no_grad()
    def sim_dispatch(self, group_leaves, outer: OuterState, tc, *, mu, lr,
                     inplace: bool = False):
        """Mean the G replicas, subtract the anchor, run the outer update.

        As ``strategies.py:FlatFP32.sim_dispatch`` of the reference, the
        replicas are meaned BEFORE the anchor is subtracted (the two orders
        agree in exact arithmetic, not in floating point). The work goes one
        leaf at a time, so the fp32 mean, Δθ and target temporaries are one
        leaf's size. ``inplace`` updates the fp32 outer state in place
        (``core.outer.outer_reduce_leaves``). The reference's ``num_pods``
        and elastic ``weights`` come with the strategies that use them.
        """
        targets, moms, anchors = [], [], []
        for i, (m, a) in enumerate(zip(outer.momentum, outer.anchor)):
            stacked = torch.stack([g[i].float() for g in group_leaves])
            delta = stacked.mean(dim=0) - a.float()
            del stacked
            t, mm, an = outer_reduce_leaves([m], [a], [delta], tc, mu=mu, lr=lr,
                                            inplace=inplace)
            targets += t
            moms += mm
            anchors += an
        return targets, OuterState(momentum=moms, anchor=anchors,
                                   num_syncs=outer.num_syncs + 1)


def validate_pod_grouping(num_groups: int, num_pods: int) -> None:
    """The G groups split into ``num_pods`` equal pods; fail early if not."""
    P = max(int(num_pods), 1)
    if num_groups % P != 0:
        raise ValueError(
            f"hierarchical reduce needs num_pods ({P}) to divide the group count "
            f"({num_groups}); got {num_groups} % {P} = {num_groups % P}")


def resolve_strategy(cfg) -> OuterSyncStrategy:
    """Map an ``OuterCommConfig`` (or a ``TrainConfig`` carrying one) onto
    the strategy object; only the all-defaults config is ported."""
    comm = getattr(cfg, "outer_comm", cfg)
    if comm.compression not in ("none", "quantize", "int8-wire", "rs-ag"):
        raise ValueError(f"unknown outer compression {comm.compression!r}")
    unported = [k for k, on in (
        (f"compression={comm.compression!r}", comm.compression != "none"),
        ("hierarchical", comm.hierarchical), (f"chunks={comm.chunks}", comm.chunks > 1),
        ("sharded", comm.sharded)) if on]
    if unported:
        raise NotImplementedError(
            f"outer strategy with {', '.join(unported)} is not ported yet; the port "
            f"runs the flat fp32 mean (OuterCommConfig defaults)")
    return FlatFP32()
