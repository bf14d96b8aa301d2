"""Pier schedule logic: phase selection, outer events, momentum decay, LR.

A copy of ``repro/core/pier.py`` (``PierSchedule`` and ``OuterEvent``),
pure Python, kept here because the port imports nothing of the reference;
``tests/test_torch_outer.py`` checks that the two give the same event
streams. The host training loop consults :class:`PierSchedule` each step
to decide which step runs (warmup / inner) and which *outer events* fire
after it.

Every outer event, warmup momentum accumulation and post-warmup outer sync
alike, is a dispatch/apply pair carrying its own ``apply_step``:

- ``dispatch`` launches the event's computation at the sync boundary: the
  global Δθ mean and Nesterov math (``op == "outer"``, Alg. 2) or the
  momentum-warmup accumulation (``op == "accumulate"``, Alg. 1).
- ``apply`` installs the dispatched result ``sync_delay`` steps later (same
  step when 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Tuple

from repro_torch.config import TrainConfig

Phase = Literal["warmup", "inner"]

OuterOp = Literal["accumulate", "outer"]


@dataclass(frozen=True)
class OuterEvent:
    """One outer-engine event fired after the inner update of a step.

    ``sync_step`` is the boundary the event belongs to (where its dispatch
    fires); ``apply_step`` is the step whose inner update its apply
    follows — ``sync_step + delay`` for both halves of the pair, so either
    half alone identifies the full window.
    """

    kind: Literal["dispatch", "apply"]
    op: OuterOp
    sync_step: int
    apply_step: int


@dataclass(frozen=True)
class PierSchedule:
    tc: TrainConfig

    # ---------------------------------------------------------- phase logic
    def phase(self, step: int) -> Phase:
        """Which inner step runs at ``step`` (0-based)."""
        if self.tc.optimizer == "adamw":
            return "warmup"  # AdamW baseline = global sync every step
        if self.tc.optimizer == "diloco" and not self.tc.lazy_start:
            return "inner"
        return "warmup" if step < self.warmup_steps else "inner"

    @property
    def warmup_steps(self) -> int:
        if self.tc.optimizer == "adamw":
            return self.tc.total_steps
        if self.tc.optimizer == "diloco" and not self.tc.lazy_start:
            return 0
        return self.tc.warmup_steps

    def is_sync_step(self, step: int) -> bool:
        """True if an outer event fires AFTER the inner update at ``step``.

        During warmup the event is momentum accumulation (Alg. 1 line 4,
        Pier only); after warmup it is the outer optimizer step (Alg. 2).
        """
        if self.tc.optimizer == "adamw":
            return False
        if (step + 1) % self.tc.sync_interval != 0:
            return False
        if step < self.warmup_steps:
            # momentum warmup accumulation — Pier only (DiLoCo lazy-starts
            # without accumulating)
            return self.tc.momentum_warmup
        return True

    def sync_kind(self, step: int) -> str:
        """Legacy spelling of :meth:`op_at` (kept for callers/tests)."""
        return self.op_at(step)

    # ------------------------------------------------------- event model
    def op_at(self, step: int) -> OuterOp:
        """Which outer op the boundary at ``step`` performs."""
        return "accumulate" if step < self.warmup_steps else "outer"

    def is_dispatch_step(self, step: int) -> bool:
        """True if a post-warmup outer dispatch fires after ``step``."""
        return self.is_sync_step(step) and self.sync_kind(step) == "outer"

    def delay_for(self, sync_step: int) -> int:
        """Per-event delay of the boundary at ``sync_step``.

        Today uniform (``tc.sync_delay`` for accumulate and outer events
        alike — the same ``< sync_interval`` bound closes every window
        before the next boundary, including across the warmup→inner
        transition); kept as a seam so a controller/schedule can
        differentiate per-op delays without touching the event stream.
        """
        return self.tc.sync_delay

    def apply_step_for(self, dispatch_step: int) -> int:
        """The step whose inner update the ``dispatch_step`` apply follows."""
        return dispatch_step + self.delay_for(dispatch_step)

    def events(self, step: int) -> Tuple[OuterEvent, ...]:
        """Outer events fired after the inner update at ``step``, in order.

        At most two events fire per step, and only with ``sync_delay == 0``
        can they share a boundary (dispatch immediately followed by its own
        apply — the fused eager path). ``sync_delay < sync_interval``
        guarantees an apply always precedes the next dispatch — for
        accumulate and outer events alike, including across the
        warmup→inner transition (boundaries are ``sync_interval`` apart in
        every phase) — so the in-flight window never holds more than one
        outstanding dispatch.
        """
        evs = []
        # apply lands first: it belongs to an older dispatch (d > 0), or to
        # the dispatch emitted this very step (d == 0, handled below).
        for s0 in range(max(step - self.tc.sync_interval + 1, 0), step):
            if (self.is_sync_step(s0)
                    and self.apply_step_for(s0) == step):
                evs.append(OuterEvent("apply", self.op_at(s0), s0, step))
        if self.is_sync_step(step):
            op = self.op_at(step)
            a = self.apply_step_for(step)
            evs.append(OuterEvent("dispatch", op, step, a))
            if a == step:
                evs.append(OuterEvent("apply", op, step, step))
        return tuple(evs)

    # ------------------------------------------------------------ schedules
    def mu_at(self, step: int) -> float:
        """Momentum-decay schedule (Alg. 2 lines 12-18). DiLoCo: fixed 0.9."""
        if self.tc.optimizer == "diloco":
            return self.tc.outer_momentum
        return self.tc.mu_at(step)

    def outer_lr_at(self, step: int) -> float:
        """Outer LR schedule (§V). DiLoCo: fixed (paper recommends 0.7)."""
        if self.tc.optimizer == "diloco":
            return self.tc.fixed_outer_lr
        return self.tc.outer_lr_at(step)

    def outer_index(self, dispatch_step: int) -> int:
        """0-based ordinal of the post-warmup outer dispatch at ``step``.

        The elastic-membership churn schedule (DESIGN.md §11) keys its
        drop/rejoin/straggle entries on this ordinal — "outer event k"
        means the k-th post-warmup ``outer`` dispatch boundary, counting
        from 0 — so scripts stay meaningful across delay/interval
        changes. Raises on a step that is not an outer dispatch boundary.
        """
        if not (self.is_sync_step(dispatch_step)
                and self.op_at(dispatch_step) == "outer"):
            raise ValueError(
                f"step {dispatch_step} is not a post-warmup outer "
                f"dispatch boundary")
        w = self.warmup_steps
        return (dispatch_step - w) // self.tc.sync_interval

    # -------------------------------------------------------------- helpers
    def num_outer_steps(self) -> int:
        post = self.tc.total_steps - self.warmup_steps
        return post // self.tc.sync_interval

    def global_comm_fraction(self) -> float:
        """Fraction of steps that require global (cross-group) communication.

        This is the quantity Pier optimizes: AdamW = 1.0; Pier/DiLoCo = 1/r
        after warmup (plus the warmup phase itself).
        """
        if self.tc.optimizer == "adamw":
            return 1.0
        w = self.warmup_steps / max(self.tc.total_steps, 1)
        return w + (1 - w) / self.tc.sync_interval
