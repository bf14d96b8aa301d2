"""Elastic outer membership: churn scripts, liveness and staleness
(copy of ``repro/sync/membership.py``).

The host-side state machine that lets groups lag, drop out and rejoin
between outer events, feeding the weighted reductions
(``sync/base.py:weighted_stack_mean`` / ``weighted_psum_mean``,
``kernels/wire.py:dequant_sum_sources(weights=...)``):

- :class:`ChurnSchedule`: scripted :class:`ChurnEvent` entries keyed on the
  post-warmup outer dispatch ordinal (``PierSchedule.outer_index``), in
  the launcher's grammar::

      drop:G@K        group G leaves the cohort before event K
      rejoin:G@K      group G returns and takes part at event K
      straggle:G@K+N  group G's deltas for events [K, K+N) arrive late

  e.g. ``"drop:1@3,rejoin:1@6,straggle:0@4+2"``.
- :class:`MembershipController`: replays a schedule into per-event
  :class:`EventMembership` records. A dropped group has weight 0 and takes
  no applies until its rejoin, which bootstraps it right after the
  previous event's apply. A straggler stays in the apply cohort while it
  has missed at most ``MembershipConfig.max_staleness`` events (its late
  deltas are discarded, weight 0); beyond that it is evicted and
  bootstraps when its lateness window ends. Every event's live count is
  checked against ``min_live`` when the controller is built.

The records are computed from the script up front, so the simulator and
the Trainer see the same weights, apply masks and bootstrap points.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.config import MembershipConfig


@dataclass(frozen=True)
class ChurnEvent:
    """One scripted membership transition.

    ``kind``: ``"drop"`` | ``"rejoin"`` | ``"straggle"``. ``event`` is
    the post-warmup outer dispatch ordinal the transition keys on (for
    ``straggle``, the first event whose delta is late); ``late`` is the
    straggle window length in events (ignored otherwise).
    """

    kind: str
    group: int
    event: int
    late: int = 0

    def __post_init__(self):
        if self.kind not in ("drop", "rejoin", "straggle"):
            raise ValueError(f"unknown churn kind {self.kind!r}")
        if self.group < 0:
            raise ValueError(f"group must be >= 0, got {self.group}")
        if self.event < 0:
            raise ValueError(f"event must be >= 0, got {self.event}")
        if self.kind == "rejoin" and self.event < 1:
            raise ValueError(
                "rejoin must name event >= 1: the returning group "
                "bootstraps at the previous event's apply boundary")
        if self.kind == "straggle" and self.late < 1:
            raise ValueError(
                f"straggle needs a lateness >= 1 event, got {self.late}")


_SPEC_RE = re.compile(
    r"^(?P<kind>drop|rejoin|straggle):(?P<group>\d+)@(?P<event>\d+)"
    r"(?:\+(?P<late>\d+))?$")


@dataclass(frozen=True)
class ChurnSchedule:
    """An ordered collection of scripted churn events."""

    events: Tuple[ChurnEvent, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "ChurnSchedule":
        """Parse the launcher grammar, e.g.
        ``"drop:1@3,rejoin:1@6,straggle:0@4+2"``."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            m = _SPEC_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad churn spec entry {part!r}: expected "
                    f"kind:group@event[+late] with kind in "
                    f"drop|rejoin|straggle")
            late = m.group("late")
            if late is not None and m.group("kind") != "straggle":
                raise ValueError(
                    f"bad churn spec entry {part!r}: +late is only "
                    f"meaningful for straggle")
            events.append(ChurnEvent(
                kind=m.group("kind"), group=int(m.group("group")),
                event=int(m.group("event")),
                late=int(late) if late is not None else 0))
        return cls(events=tuple(events))

    def for_group(self, g: int) -> Tuple[ChurnEvent, ...]:
        return tuple(sorted((e for e in self.events if e.group == g),
                            key=lambda e: e.event))

    def max_event(self) -> int:
        """Last event ordinal any entry touches (-1 for an empty script)."""
        last = -1
        for e in self.events:
            last = max(last, e.event + (e.late if e.kind == "straggle"
                                        else 0))
        return last


@dataclass(frozen=True)
class EventMembership:
    """The membership decision for one post-warmup outer event.

    ``weights`` feeds the weighted reduction at this event's dispatch;
    ``apply_live`` masks this event's apply (an absent/evicted group
    keeps its stale params until bootstrap); ``bootstrap_after_apply``
    names the groups to bootstrap immediately after this event's apply
    lands (params <- the freshly installed anchor, or the latest
    complete checkpoint; fresh inner-opt state; zero residual) so they
    train the next window coherently and participate at event + 1.
    """

    event: int
    weights: Tuple[float, ...]
    apply_live: Tuple[bool, ...]
    bootstrap_after_apply: Tuple[int, ...] = ()

    @property
    def full(self) -> bool:
        return all(w == 1.0 for w in self.weights) and all(self.apply_live)

    @property
    def num_live(self) -> int:
        return sum(1 for w in self.weights if w > 0)


# Per-group phase labels of the membership state machine.
_LIVE = "live"
_ABSENT = "absent"  # dropped, awaiting scripted rejoin
_STRAGGLING = "straggling"  # in cohort, deltas discarded
_EVICTED = "evicted"  # out of cohort (beyond the staleness bound)


@dataclass
class MembershipController:
    """Replays a :class:`ChurnSchedule` into per-event membership records.

    Deterministic and precomputed: the full timeline is validated (and
    ``min_live`` enforced) at construction, so the simulator and the
    Trainer — consuming the same controller — see identical weights,
    apply masks, and bootstrap points at every boundary.
    """

    num_groups: int
    cfg: MembershipConfig = field(default_factory=MembershipConfig)
    schedule: Optional[ChurnSchedule] = None

    def __post_init__(self):
        if self.num_groups < 1:
            raise ValueError(
                f"num_groups must be >= 1, got {self.num_groups}")
        sched = self.schedule or ChurnSchedule()
        for e in sched.events:
            if e.group >= self.num_groups:
                raise ValueError(
                    f"churn entry {e} names group {e.group} but only "
                    f"{self.num_groups} groups exist")
        self._records: Dict[int, EventMembership] = {}
        self._horizon = sched.max_event()
        self._validate_script(sched)
        self._replay(sched)

    # ------------------------------------------------------------ validation
    def _validate_script(self, sched: ChurnSchedule) -> None:
        for g in range(self.num_groups):
            open_drop = None
            straggle_until = -1
            for e in sched.for_group(g):
                if e.kind == "drop":
                    if open_drop is not None:
                        raise ValueError(
                            f"group {g} dropped at event {e.event} while "
                            f"already dropped at {open_drop}")
                    if e.event < straggle_until:
                        raise ValueError(
                            f"group {g} dropped at event {e.event} inside "
                            f"its straggle window (until {straggle_until})")
                    open_drop = e.event
                elif e.kind == "rejoin":
                    if open_drop is None:
                        raise ValueError(
                            f"group {g} rejoins at event {e.event} without "
                            f"a preceding drop")
                    if e.event <= open_drop:
                        raise ValueError(
                            f"group {g} rejoin at event {e.event} must come "
                            f"after its drop at {open_drop}")
                    open_drop = None
                else:  # straggle
                    if open_drop is not None:
                        raise ValueError(
                            f"group {g} straggles at event {e.event} while "
                            f"dropped at {open_drop}")
                    if e.event < straggle_until:
                        raise ValueError(
                            f"group {g} straggle at event {e.event} overlaps "
                            f"its previous straggle window")
                    straggle_until = e.event + e.late

    # ---------------------------------------------------------------- replay
    def _replay(self, sched: ChurnSchedule) -> None:
        G = self.num_groups
        phase = [_LIVE] * G
        missed = [0] * G
        straggle_end = [-1] * G  # first event after the straggle window
        drops: Dict[int, List[int]] = {}
        rejoins: Dict[int, List[int]] = {}
        straggles: Dict[int, List[ChurnEvent]] = {}
        for e in sched.events:
            if e.kind == "drop":
                drops.setdefault(e.event, []).append(e.group)
            elif e.kind == "rejoin":
                rejoins.setdefault(e.event, []).append(e.group)
            else:
                straggles.setdefault(e.event, []).append(e)

        for k in range(self._horizon + 1):
            bootstrap_next: List[int] = []
            # scripted transitions taking effect at event k
            for g in drops.get(k, ()):
                phase[g] = _ABSENT
            for g in rejoins.get(k, ()):
                phase[g] = _LIVE
                missed[g] = 0
            for e in straggles.get(k, ()):
                phase[e.group] = _STRAGGLING
                straggle_end[e.group] = k + e.late
            # straggle windows ending at k: the group re-contributes now
            for g in range(G):
                if (phase[g] in (_STRAGGLING, _EVICTED)
                        and straggle_end[g] == k):
                    phase[g] = _LIVE
                    missed[g] = 0
                    straggle_end[g] = -1
            weights = tuple(
                1.0 if phase[g] == _LIVE else 0.0 for g in range(G))
            apply_live = tuple(
                phase[g] in (_LIVE, _STRAGGLING) for g in range(G))
            # staleness accounting + eviction (after this event's mask:
            # a group becomes evictable once it has MISSED more than
            # max_staleness events)
            for g in range(G):
                if phase[g] == _LIVE:
                    missed[g] = 0
                    continue
                missed[g] += 1
                if (phase[g] == _STRAGGLING
                        and missed[g] > self.cfg.max_staleness):
                    phase[g] = _EVICTED
                if phase[g] == _ABSENT and missed[g] > self.cfg.max_staleness:
                    phase[g] = _EVICTED
            # rejoins participating at k+1 bootstrap right after event
            # k's apply: scripted rejoins, and evicted stragglers whose
            # window ends at k+1
            for g in rejoins.get(k + 1, ()):
                bootstrap_next.append(g)
            for g in range(G):
                if phase[g] == _EVICTED and straggle_end[g] == k + 1:
                    bootstrap_next.append(g)
            rec = EventMembership(
                event=k, weights=weights, apply_live=apply_live,
                bootstrap_after_apply=tuple(sorted(set(bootstrap_next))))
            if rec.num_live < self.cfg.min_live:
                raise ValueError(
                    f"churn schedule leaves only {rec.num_live} live "
                    f"groups at event {k} (< min_live="
                    f"{self.cfg.min_live}): {rec.weights}")
            self._records[k] = rec

    # ------------------------------------------------------------------ API
    def at(self, event: int) -> EventMembership:
        """Membership record for post-warmup outer event ``event``.

        Events past the scripted horizon are full membership (every
        transition has resolved; evicted-but-never-rejoined states
        cannot persist past the horizon by construction — an open drop
        without a rejoin keeps the group absent forever, which the
        horizon record reflects).
        """
        if event < 0:
            raise ValueError(f"event must be >= 0, got {event}")
        if event in self._records:
            return self._records[event]
        if self._horizon >= 0 and event > self._horizon:
            last = self._records[self._horizon]
            # steady state past the horizon: the last record's phases,
            # minus one-shot bootstrap actions
            return EventMembership(
                event=event, weights=last.weights,
                apply_live=last.apply_live, bootstrap_after_apply=())
        return EventMembership(
            event=event, weights=(1.0,) * self.num_groups,
            apply_live=(True,) * self.num_groups)

    @property
    def elastic(self) -> bool:
        """True if any event deviates from full membership."""
        return any(not r.full or r.bootstrap_after_apply
                   for r in self._records.values())
