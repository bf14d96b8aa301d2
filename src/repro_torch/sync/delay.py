"""Delay controllers: how ``sync_delay="auto"`` resolves d*
(copy of ``repro/sync/delay.py``).

d* is the smallest delay (in inner steps) that fully hides the outer
exchange: ``d* = ceil(t_comm / t_inner)``. Two sources for the times:

- :class:`ModelDelayController`: the analytic step-time model of
  ``sync/overlap_model.py`` keyed by a ``--chip`` hint; an unknown chip
  (or none) warns and falls back to eager, d* = 0.
- :class:`MeasuredDelayController`: EMAs of the inner step's and of the
  dispatch-to-ready times the host loop measures over the first sync
  windows (the Trainer reads its clock after ``torch.cuda.synchronize()``),
  re-resolving d* once ``min_windows`` windows are in; before that the
  fallback (the model) answers.

Controllers are made through the strategy hook
:meth:`repro_torch.sync.base.OuterSyncStrategy.make_delay_controller`.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional


class DelayController:
    """Protocol: decides (and possibly re-decides) the sync delay d*."""

    def initial_delay(self) -> int:
        raise NotImplementedError

    @property
    def wants_measurement(self) -> bool:
        """True while the host loop should wall-clock sync windows for
        :meth:`observe_window` (the measured controller's warmup)."""
        return False

    def observe_step(self, t_inner: float) -> None:
        """Record one inner step's wall-clock seconds."""

    def observe_window(self, *, t_comm: float,
                       t_inner: Optional[float] = None,
                       warmup: bool = False) -> None:
        """Record one measured sync window (dispatch-to-ready seconds).

        ``warmup=True`` marks a warmup accumulate window: its collective
        exchanged the fp32 Δθ, not the strategy's wire payload, so
        width-scaling controllers rescale the sample before folding it
        into their estimate."""

    def tick_window(self) -> None:
        """Note that one sync window elapsed, measured or not.

        The host loop calls this on *every* outer dispatch (unlike
        :meth:`observe_window`, which only fires while
        :attr:`wants_measurement` holds) — the hook long-running
        controllers use to schedule periodic re-measurement
        (``remeasure_every``)."""

    def current_delay(self) -> int:
        return self.initial_delay()


class FixedDelayController(DelayController):
    """A constant d*.

    ``sync_interval`` (when known) bounds the delay to the legal window
    ``[0, sync_interval − 1]``: an out-of-range fixed delay would silently
    violate the single-outstanding-dispatch invariant that
    ``PierSchedule.events`` documents (the apply must precede the next
    dispatch), so it is clamped with a warning rather than handed to the
    schedule. A negative delay without an interval to clamp against
    raises outright.
    """

    def __init__(self, delay: int, sync_interval: Optional[int] = None):
        d = int(delay)
        if sync_interval is not None:
            hi = int(sync_interval) - 1
            if d < 0 or d > hi:
                warnings.warn(
                    f"fixed sync_delay {d} outside the legal window "
                    f"[0, {hi}] (sync_interval {int(sync_interval)}); "
                    f"clamping — the in-flight dispatch must be applied "
                    f"before the next boundary", stacklevel=2)
                d = max(0, min(d, hi))
        elif d < 0:
            raise ValueError(f"sync_delay must be >= 0, got {d}")
        self._delay = d

    def initial_delay(self) -> int:
        return self._delay


class ModelDelayController(DelayController):
    """Analytic d* from the overlap step-time model (``--chip`` hint).

    Falls back to 0 (eager) whenever the model has no estimate: no chip
    hint, or (with a warning) one the model's table does not name.
    """

    def __init__(self, tc, mc, pc, *, chip: str = "", n_params: Optional[int] = None):
        self.tc, self.mc, self.pc = tc, mc, pc
        self.chip = chip or ""
        # the reference reads ``mc.param_count()``; the port counts the
        # parameters it was given, or builds them on the CPU when asked
        self.n_params = n_params
        self._cached: Optional[int] = None

    def initial_delay(self) -> int:
        if self._cached is not None:
            return self._cached
        self._cached = self._resolve()
        return self._cached

    def _resolve(self) -> int:
        from repro_torch.sync.overlap_model import CHIPS, resolve_sync_delay

        tc, mc, pc = self.tc, self.mc, self.pc
        comm = tc.outer_comm
        n_params = self.n_params
        if n_params is None:
            # only a chip the model knows needs the count
            n_params = param_count(mc) if self.chip in CHIPS else 0
        d = resolve_sync_delay(
            n_params=n_params, n_devices=pc.num_devices,
            group_size=pc.group_size, sync_interval=tc.sync_interval,
            chip=self.chip or None,
            bits=(comm.bits if comm.compression != "none" else 32),
            block=comm.block,
            hierarchical=comm.hierarchical, pods=pc.num_pods)
        if d is None:
            # resolve_sync_delay already warned for an unknown chip; an
            # empty hint is the documented "no estimate" case.
            return 0
        return max(0, min(int(d), tc.sync_interval - 1))


def param_count(mc) -> int:
    """Parameters of ``mc``, counted on a CPU copy of its initial weights."""
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves

    return sum(t.numel() for _, t in param_leaves(R.init_params(mc, seed=0, device="cpu")))


class MeasuredDelayController(DelayController):
    """Measured d*: EMA ``t_comm``/``t_inner`` over the first sync windows.

    The host loop times every inner step (:meth:`observe_step`) and, while
    :attr:`wants_measurement` is True, waits for the dispatched exchange
    to wall-clock it (:meth:`observe_window`) — overlap is given up for
    the measurement windows only. Once ``min_windows`` windows are in,
    d* = ceil(ema_t_comm / ema_t_inner) clamped to
    ``[0, sync_interval - 1]``; before that the fallback (analytic model)
    answers.

    ``remeasure_every = k > 0`` keeps long runs honest: after the initial
    measurement completes, every ``k`` *unmeasured* sync windows
    (:meth:`tick_window`, which the host calls on every dispatch) re-opens
    a burst of ``min_windows`` measured windows, folding fresh samples
    into the EMAs — fabric contention drifts over a multi-day run, and
    without re-sampling the controller would freeze on the first
    minutes' timings forever. 0 (the default) keeps the original
    measure-once behavior.

    ``warmup_scale`` is the modeled payload-width ratio (strategy wire
    bytes/param over fp32's 4.0): warmup accumulate windows exchange the
    *fp32* Δθ whatever the strategy, so their ``t_comm`` samples
    over-estimate a compressed wire's collective by exactly that ratio.
    Samples observed with ``warmup=True`` are multiplied by it before
    entering the EMA — d* then resolves from representative-width
    samples before the first post-warmup sync, instead of deferring to
    the fallback until ``min_windows`` post-warmup windows have been
    paid for. 1.0 (fp32 strategies) keeps warmup samples exact.
    """

    def __init__(self, tc, *, fallback: Optional[DelayController] = None,
                 min_windows: int = 2, max_windows: int = 6,
                 skip_windows: int = 1, ema: float = 0.5,
                 remeasure_every: int = 0, warmup_scale: float = 1.0):
        self.tc = tc
        self.fallback = fallback or FixedDelayController(0)
        self.min_windows = int(min_windows)
        self.max_windows = int(max_windows)
        # the first window(s) wall-clock the first launches (the kernel
        # library's load, the allocator), not the exchange — observed but
        # not folded into the EMA
        self.skip_windows = int(skip_windows)
        self.ema = float(ema)
        self.remeasure_every = int(remeasure_every)
        self.warmup_scale = float(warmup_scale)
        self.windows = 0
        self.t_inner: Optional[float] = None
        self.t_comm: Optional[float] = None
        self._since_measure = 0  # unmeasured windows since the last burst
        self._burst = 0  # re-measurement windows still owed
        self._measured_this_window = False  # observe seen since last tick

    def initial_delay(self) -> int:
        return self.fallback.initial_delay()

    @property
    def wants_measurement(self) -> bool:
        return self.windows < self.max_windows or self._burst > 0

    def tick_window(self) -> None:
        measured, self._measured_this_window = (self._measured_this_window,
                                                False)
        if measured or self.wants_measurement:
            self._since_measure = 0
            return
        if self.remeasure_every > 0:
            self._since_measure += 1
            if self._since_measure >= self.remeasure_every:
                self._burst = self.min_windows
                self._since_measure = 0

    def _ema(self, old: Optional[float], new: float) -> float:
        if old is None:
            return new
        return self.ema * new + (1.0 - self.ema) * old

    def observe_step(self, t_inner: float) -> None:
        self.t_inner = self._ema(self.t_inner, t_inner)

    def observe_window(self, *, t_comm: float,
                       t_inner: Optional[float] = None,
                       warmup: bool = False) -> None:
        if self._burst > 0:
            self._burst -= 1
        self._measured_this_window = True
        self.windows += 1
        if self.windows <= self.skip_windows:
            return
        if warmup:
            t_comm = t_comm * self.warmup_scale
        self.t_comm = self._ema(self.t_comm, t_comm)
        if t_inner is not None:
            self.t_inner = self._ema(self.t_inner, t_inner)

    def current_delay(self) -> int:
        # NOTE: ``is None`` checks, not truthiness — a legitimately
        # measured 0.0 (coarse timer, sub-ms collective) is a valid
        # sample and resolves to d*=0; only division by a non-positive
        # t_inner defers to the fallback.
        if (self.windows < self.min_windows + self.skip_windows
                or self.t_comm is None
                or self.t_inner is None or self.t_inner <= 0):
            return self.fallback.initial_delay()
        d = math.ceil(self.t_comm / self.t_inner)
        return max(0, min(int(d), self.tc.sync_interval - 1))
