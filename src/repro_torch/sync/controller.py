"""Sync controllers: decisions of delay and strategy
(copy of ``repro/sync/controller.py``).

:mod:`repro_torch.sync.delay` resolves a scalar d*, capped at
``sync_interval − 1``. When the measured t_comm stays exposed even at that
cap, the move is to change what crosses the wire. A
:class:`SyncController` therefore emits a :class:`SyncDecision` —
``(delay, strategy)``:

- :class:`DelayDecisionAdapter` wraps a
  :class:`~repro_torch.sync.delay.DelayController` (strategy always
  ``None``: keep the configured one).
- :class:`AdaptiveSyncController` walks a *ladder* of successively cheaper
  wire formats: when a measurement completes and the unclamped
  ``ceil(t_comm / t_inner)`` exceeds the legal window, it steps down a rung,
  measures afresh (``t_inner`` carries over) and decides the largest legal
  delay meanwhile.
- :class:`ScriptedSyncController` replays a fixed window-indexed script:
  the deterministic seam that holds the simulator and the Trainer to the
  same decisions.

The runners consume controllers alike: ``tick_window()`` after every outer
dispatch, ``observe_*`` while ``wants_measurement`` holds, then
``current_decision()``; a strategy change flushes the in-flight window and
re-plans the outer steps off the new strategy.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence, Union

from repro_torch.sync.delay import (DelayController, FixedDelayController,
                              MeasuredDelayController)
from repro_torch.sync.strategies import (Chunked, FlatFP32, Hierarchical,
                                   Int8Wire, Quantized)


class SyncDecision(NamedTuple):
    """One controller verdict: the delay for the following windows, and
    an optional strategy to switch to (``None`` = keep the current one).
    Consumers adopt the delay through :meth:`clamped_delay` so the legal
    window ``[0, sync_interval − 1]`` is enforced in exactly one place."""

    delay: int
    strategy: Optional[object] = None  # OuterSyncStrategy | None

    def clamped_delay(self, sync_interval: int) -> int:
        """The decision's delay clamped to the legal in-flight window —
        the single clamp the Trainer and the simulator both adopt (so a
        change to the legal-window rule cannot desynchronize them)."""
        return max(0, min(int(self.delay), int(sync_interval) - 1))


class SyncController:
    """Protocol: decides (and re-decides) delay *and* strategy."""

    def initial_decision(self) -> SyncDecision:
        raise NotImplementedError

    @property
    def wants_measurement(self) -> bool:
        """True while the host loop should wall-clock sync windows."""
        return False

    def observe_step(self, t_inner: float) -> None:
        """Record one inner step's wall-clock seconds."""

    def observe_window(self, *, t_comm: float,
                       t_inner: Optional[float] = None,
                       warmup: bool = False) -> None:
        """Record one measured sync window (dispatch-to-ready seconds).
        ``warmup=True`` marks a warmup accumulate window (fp32 Δθ on the
        wire regardless of strategy — see
        :meth:`repro_torch.sync.delay.DelayController.observe_window`)."""

    def tick_window(self) -> None:
        """Note that one sync window elapsed (measured or not)."""

    def current_decision(self) -> SyncDecision:
        return self.initial_decision()

    @property
    def delay_controller(self) -> Optional[DelayController]:
        """The underlying scalar-delay controller, when one exists (the
        Trainer's legacy ``delay_controller`` attribute reads through)."""
        return None


class DelayDecisionAdapter(SyncController):
    """A legacy :class:`DelayController` as a fixed-strategy decision
    source — the default ``sync_delay="auto"`` path, byte-for-byte the
    pre-decision behavior."""

    def __init__(self, delay_controller: DelayController):
        self._delay = delay_controller

    def initial_decision(self) -> SyncDecision:
        return SyncDecision(self._delay.initial_delay(), None)

    @property
    def wants_measurement(self) -> bool:
        return self._delay.wants_measurement

    def observe_step(self, t_inner: float) -> None:
        self._delay.observe_step(t_inner)

    def observe_window(self, *, t_comm: float,
                       t_inner: Optional[float] = None,
                       warmup: bool = False) -> None:
        self._delay.observe_window(t_comm=t_comm, t_inner=t_inner,
                                   warmup=warmup)

    def tick_window(self) -> None:
        self._delay.tick_window()

    def current_decision(self) -> SyncDecision:
        return SyncDecision(self._delay.current_delay(), None)

    @property
    def delay_controller(self) -> DelayController:
        return self._delay


class AdaptiveSyncController(SyncController):
    """Measured delay resolution + strategy switching on exposure.

    ``ladder`` is the ordered tuple of strategies to fall through,
    position 0 being the configured starting strategy (see
    :func:`default_ladder`). After each completed measurement phase the
    controller computes the *unclamped* d\\* = ceil(t_comm / t_inner); if
    it exceeds the legal maximum (``sync_interval − 1`` — the collective
    stays exposed even fully overlapped) and a lower rung exists, the
    decision carries the next rung and measurement restarts against the
    new wire format. ``remeasure_every`` is forwarded to the underlying
    measured controller so long runs keep re-sampling.
    """

    def __init__(self, tc, *, ladder: Sequence,
                 fallback: Optional[DelayController] = None,
                 min_windows: int = 2, max_windows: int = 6,
                 skip_windows: int = 1, remeasure_every: int = 0,
                 warmup_scale: float = 1.0):
        if not ladder:
            raise ValueError("adaptive sync needs a non-empty ladder")
        self.tc = tc
        self.ladder = tuple(ladder)
        self.rung = 0
        self.min_windows = int(min_windows)
        self.skip_windows = int(skip_windows)
        # the measurement phase must be able to resolve: at least
        # skip (compile) + min (EMA) windows long
        self.max_windows = max(int(max_windows),
                               self.min_windows + self.skip_windows)
        self.remeasure_every = int(remeasure_every)
        self.warmup_scale = float(warmup_scale)
        self._measure = self._fresh_measure(
            fallback if isinstance(fallback, DelayController)
            else FixedDelayController(0, tc.sync_interval))

    def _fresh_measure(self, fallback: DelayController,
                       t_inner: Optional[float] = None):
        m = MeasuredDelayController(
            self.tc, fallback=fallback, min_windows=self.min_windows,
            max_windows=self.max_windows, skip_windows=self.skip_windows,
            remeasure_every=self.remeasure_every,
            warmup_scale=self.warmup_scale)
        # the inner step does not change across strategy switches — carry
        # the EMA so the fresh t_comm resolves against live numbers
        m.t_inner = t_inner
        return m

    @property
    def max_legal_delay(self) -> int:
        return max(self.tc.sync_interval - 1, 0)

    def initial_decision(self) -> SyncDecision:
        return SyncDecision(self._measure.initial_delay(), None)

    @property
    def wants_measurement(self) -> bool:
        return self._measure.wants_measurement

    def observe_step(self, t_inner: float) -> None:
        self._measure.observe_step(t_inner)

    def observe_window(self, *, t_comm: float,
                       t_inner: Optional[float] = None,
                       warmup: bool = False) -> None:
        self._measure.observe_window(t_comm=t_comm, t_inner=t_inner,
                                     warmup=warmup)

    def tick_window(self) -> None:
        self._measure.tick_window()

    def _exposed_at_max(self) -> bool:
        m = self._measure
        if (m.wants_measurement
                or m.windows < m.min_windows + m.skip_windows
                or m.t_comm is None
                or m.t_inner is None or m.t_inner <= 0):
            return False
        return math.ceil(m.t_comm / m.t_inner) > self.max_legal_delay

    def current_decision(self) -> SyncDecision:
        if self._exposed_at_max() and self.rung + 1 < len(self.ladder):
            self.rung += 1
            # fully exposed: overlap as much as legally possible while the
            # cheaper wire format is measured from scratch
            self._measure = self._fresh_measure(
                FixedDelayController(self.max_legal_delay,
                                     self.tc.sync_interval),
                t_inner=self._measure.t_inner)
            return SyncDecision(self.max_legal_delay, self.ladder[self.rung])
        return SyncDecision(self._measure.current_delay(), None)

    @property
    def delay_controller(self) -> DelayController:
        return self._measure


class ScriptedSyncController(SyncController):
    """Replay a fixed decision script keyed by 1-based window index.

    ``script`` maps the index of a completed sync window onto either a
    full :class:`SyncDecision` or a bare strategy (the standing delay —
    the last decided one, initially ``delay`` — is then kept). Windows
    without an entry keep the standing delay and a ``None`` strategy. Never asks for measurement — decisions are
    data, which is what makes simulator↔Trainer lockstep tests (and
    replaying a recorded adaptive run) deterministic.
    """

    def __init__(self, delay: int, script: Optional[Mapping[int, Union[
            SyncDecision, object]]] = None):
        self.delay = int(delay)
        self.script = dict(script or {})
        self.windows = 0
        self._current = SyncDecision(self.delay, None)

    def initial_decision(self) -> SyncDecision:
        return SyncDecision(self.delay, None)

    def tick_window(self) -> None:
        self.windows += 1
        entry = self.script.get(self.windows)
        if entry is None:
            # keep the standing delay; never re-emit a strategy
            self._current = SyncDecision(self._current.delay, None)
        elif isinstance(entry, SyncDecision):
            self._current = entry
        else:  # a bare strategy
            self._current = SyncDecision(self._current.delay, entry)

    def current_decision(self) -> SyncDecision:
        return self._current


def _is_hierarchical(strategy) -> bool:
    if isinstance(strategy, Hierarchical):
        return True
    inner = getattr(strategy, "inner", None)
    return _is_hierarchical(inner) if inner is not None else False


def _core_ladder(strategy):
    """Successively cheaper wire formats for the same semantic reduce."""
    if isinstance(strategy, Chunked):
        return [Chunked(inner=i, num_chunks=strategy.num_chunks)
                for i in _core_ladder(strategy.inner)]
    if isinstance(strategy, Hierarchical):
        return [Hierarchical(inner=i) for i in _core_ladder(strategy.inner)]
    if isinstance(strategy, Quantized):
        return [strategy] + ([Quantized(4, strategy.block)]
                             if strategy.bits > 4 else [])
    if isinstance(strategy, Int8Wire):
        import dataclasses

        # replace() rather than a fresh Int8Wire: the downgrade must keep
        # the rs/ag wire-path flag (reduce_scatter) along with the block
        return [strategy] + ([dataclasses.replace(strategy, bits=4)]
                             if strategy.bits > 4 else [])
    if isinstance(strategy, FlatFP32):
        return [strategy, Quantized(8, 256), Quantized(4, 256)]
    return [strategy]


def default_ladder(strategy, *, num_pods: int = 1):
    """The default adaptive ladder for a configured strategy.

    Rung 0 is the strategy itself; each following rung halves the wire
    width (int8 → int4; fp32 → int8 → int4 via the numerically exact
    :class:`Quantized` payload). When the mesh has pods and the chain is
    not already hierarchical, a final rung toggles the two-stage reduce
    on the cheapest wire format — the topology-aware last resort
    (arXiv:2408.10197): only 1/pods of the endpoints keep exchanging.
    """
    rungs = _core_ladder(strategy)
    if num_pods > 1 and not _is_hierarchical(strategy):
        last = rungs[-1]
        if isinstance(last, Chunked):
            hier = Chunked(inner=Hierarchical(inner=last.inner),
                           num_chunks=last.num_chunks)
        else:
            hier = Hierarchical(inner=last)
        rungs.append(hier)
    return tuple(rungs)
