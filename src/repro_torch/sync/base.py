"""The outer-sync strategy protocol (``repro/sync/base.py``, DESIGN.md §7).

An :class:`OuterSyncStrategy` owns the host-side plan of an outer sync (one
span of leaves so far: chunked dispatch is not ported) and the simulator's
numeric model of the reduction over the groups' replicas
(``sim_dispatch``). The distributed ``reduce_leaf`` comes with the
multi-process Trainer.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class SyncPlan(NamedTuple):
    """Host-side dispatch plan for one strategy × parameter list.

    ``spans`` are contiguous ``[lo, hi)`` ranges of leaf indices, each
    dispatched (and applied) on its own. The reference's transport and
    second-residual fields come with the wire strategies.
    """

    num_leaves: int
    spans: Tuple[Tuple[int, int], ...]
    needs_residual: bool
    name: str
    wire_format: str = "fp32"

    @property
    def num_chunks(self) -> int:
        return len(self.spans)


class OuterSyncStrategy:
    """Base class of the outer-sync strategies."""

    needs_residual: bool = False
    wire_format: str = "fp32"

    @property
    def name(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"

    def plan(self, leaves, tc) -> SyncPlan:
        """One fused span over every leaf."""
        n = len(leaves)
        return SyncPlan(num_leaves=n, spans=((0, n),), needs_residual=self.needs_residual,
                        name=self.name, wire_format=self.wire_format)

    def sim_dispatch(self, group_leaves, outer, tc, *, mu, lr, inplace: bool = False):
        """(G lists of leaves) + outer state -> (target_f32 leaves, new outer)."""
        raise NotImplementedError
