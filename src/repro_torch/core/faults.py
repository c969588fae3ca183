"""Deterministic fault injection and supervision for elastic fleets
(DESIGN §15) — the port of ``repro/core/faults.py``.

A :class:`FaultPlan` is a seedable, fully deterministic script of membership
faults (crash at step s, rejoin at step t, slow node, wedged node, dropped
gossip round): the same seed gives the same plan, event for event, as the
reference's (``FaultPlan.random`` draws from ``np.random.default_rng``, as
the reference does).  The Fig. 3 twin injects its slow learner through the
same plan.

The :class:`Supervisor` is the host-side control loop that runs next to the
fleet:

  * it applies the plan's scripted faults, and
  * it detects wedged learners it was never told about: a member whose
    progress clock stalls past ``staleness_bound * grace`` ticks gets a
    bounded number of recovery retries with doubling backoff windows, and
    is evicted (``Membership.crash``, then a reschedule) when they run out.

Detection reads AD-PSGD's per-learner ``clock`` from the device, once per
tick: the one intended host sync of the loop.  For synchronous DPSGD, where
a wedged learner cannot be seen in the lockstep state, progress follows
from the membership's tick divisors, the information a heartbeat would
carry.  Every intervention lands as a ``set_membership`` swap.

# lint: hot-path
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .membership import HUNG, Membership, admit

__all__ = ["FaultEvent", "FaultPlan", "FaultReport", "Supervisor",
           "apply_plan"]

KINDS = ("crash", "rejoin", "slow", "recover", "hang", "drop_round")


class FaultEvent(NamedTuple):
    """One scripted fault.  ``arg``: the slow-every divisor for ``slow``,
    truthy = sticky (recovery-proof) for ``hang``, unused otherwise.
    ``learner`` is ignored for ``drop_round`` (it is fleet-wide)."""
    step: int
    kind: str
    learner: int = 0
    arg: Any = None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable schedule of faults (sorted by step; events
    of one step keep their order)."""
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        for ev in self.events:
            if ev.kind not in KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}; "
                                 f"one of {KINDS}")
        object.__setattr__(self, "events",
                           tuple(sorted(self.events, key=lambda e: e.step)))

    def at(self, step: int) -> List[FaultEvent]:
        return [ev for ev in self.events if ev.step == step]

    @property
    def last_step(self) -> int:
        return max((ev.step for ev in self.events), default=-1)

    # -- canned plans ---------------------------------------------------------
    @staticmethod
    def straggler(learner: int, every: int, start: int = 0) -> "FaultPlan":
        """A permanently slow node: Fig. 3's injected straggler."""
        return FaultPlan((FaultEvent(start, "slow", learner, every),))

    @staticmethod
    def crash_rejoin(learner: int, crash_at: int,
                     rejoin_at: Optional[int] = None) -> "FaultPlan":
        evs = [FaultEvent(crash_at, "crash", learner)]
        if rejoin_at is not None:
            if rejoin_at <= crash_at:
                raise ValueError(f"rejoin at {rejoin_at} is not after the "
                                 f"crash at {crash_at}")
            evs.append(FaultEvent(rejoin_at, "rejoin", learner))
        return FaultPlan(tuple(evs))

    @staticmethod
    def random(seed: int, steps: int, capacity: int, *,
               p_crash: float = 0.02, p_rejoin: float = 0.3,
               p_slow: float = 0.02, p_drop: float = 0.02,
               min_active: int = 2) -> "FaultPlan":
        """A seeded chaos schedule: the same seed gives the same plan, and
        the reference's plan (the same ``default_rng`` draws in the same
        order).  Never drives the simulated fleet below ``min_active``
        live members."""
        rng = np.random.default_rng(seed)
        active = np.ones(capacity, bool)
        evs: List[FaultEvent] = []
        for step in range(steps):
            if rng.random() < p_drop:
                evs.append(FaultEvent(step, "drop_round"))
            if active.sum() > min_active and rng.random() < p_crash:
                i = int(rng.choice(np.flatnonzero(active)))
                evs.append(FaultEvent(step, "crash", i))
                active[i] = False
            if (~active).any() and rng.random() < p_rejoin:
                i = int(rng.choice(np.flatnonzero(~active)))
                evs.append(FaultEvent(step, "rejoin", i))
                active[i] = True
            if active.sum() > min_active and rng.random() < p_slow:
                i = int(rng.choice(np.flatnonzero(active)))
                evs.append(FaultEvent(step, "slow", i,
                                      int(rng.integers(2, 5))))
        return FaultPlan(tuple(evs))


@dataclasses.dataclass
class FaultReport:
    """What the supervisor did, step-stamped ((step, learner) pairs)."""
    crashes: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    rejoins: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    retries: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    evictions: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    dropped_rounds: int = 0

    @property
    def interventions(self) -> int:
        return (len(self.crashes) + len(self.rejoins) + len(self.retries)
                + len(self.evictions))


def apply_plan(membership: Membership, plan: FaultPlan, step: int, *,
               on_rejoin=None, sticky: Optional[set] = None,
               report: Optional[FaultReport] = None) -> bool:
    """Apply the plan's events due at ``step`` to ``membership``.
    ``on_rejoin(slot)`` runs before the slot turns live (the state surgery,
    e.g. :func:`admit`, clones the consensus of the pre-join live set).
    Returns True if this step's gossip round is dropped."""
    drop = False
    for ev in plan.at(step):
        if ev.kind == "crash" and membership.active[ev.learner]:
            membership.crash(ev.learner)
            if sticky is not None:
                sticky.discard(ev.learner)
            if report is not None:
                report.crashes.append((step, ev.learner))
        elif ev.kind == "rejoin" and not membership.active[ev.learner]:
            if on_rejoin is not None:
                on_rejoin(ev.learner)
            membership.rejoin(ev.learner)
            if report is not None:
                report.rejoins.append((step, ev.learner))
        elif ev.kind == "slow":
            membership.set_slow(ev.learner, int(ev.arg))
        elif ev.kind == "hang":
            membership.hang(ev.learner)
            if ev.arg and sticky is not None:
                sticky.add(ev.learner)
        elif ev.kind == "recover":
            if sticky is not None:
                sticky.discard(ev.learner)
            membership.recover(ev.learner)
        elif ev.kind == "drop_round":
            drop = True
            if report is not None:
                report.dropped_rounds += 1
    return drop


@dataclasses.dataclass
class Supervisor:
    """Host-side fleet supervision over an elastic trainer: scripted fault
    injection, and wedge detection with bounded retry and backoff.

    ``tick(state, step)`` runs before the step's ``train_step`` and returns
    the (possibly membership-swapped) state.  A live learner silent for
    more than ``staleness_bound * grace * 2**retries`` ticks gets a
    recovery attempt (the doubling is the backoff), and is evicted once
    ``max_retries`` attempts are spent.
    """
    trainer: Any
    membership: Membership
    plan: FaultPlan = dataclasses.field(default_factory=FaultPlan)
    staleness_bound: int = 4
    grace: int = 2
    max_retries: int = 2
    admit_mode: str = "consensus"

    report: FaultReport = dataclasses.field(default_factory=FaultReport)

    def __post_init__(self):
        cap = self.membership.capacity
        self._last_clock = np.zeros(cap, np.int64)
        self._stall = np.zeros(cap, np.int64)
        self._retries = np.zeros(cap, np.int64)
        self._sticky = set()           # recovery-proof (truly wedged) hangs
        self._dropped = False          # the last tick's drop_round flag

    # -- one supervision tick -------------------------------------------------
    def tick(self, state, step: int):
        mem = self.membership
        epoch0 = mem.epoch
        box = [state]

        def on_rejoin(slot):
            # the surgery first (it clones the consensus of the CURRENT live
            # set), then the mask flip
            box[0] = admit(self.trainer, box[0], slot, mode=self.admit_mode)
            self._stall[slot] = 0
            self._retries[slot] = 0
            self._last_clock[slot] = 0          # admit zeroed the clock

        drop = apply_plan(mem, self.plan, step, on_rejoin=on_rejoin,
                          sticky=self._sticky, report=self.report)
        state = box[0]

        self._detect(state, step)

        if mem.epoch != epoch0 or drop or self._dropped:
            state = self.trainer.set_membership(state, mem, drop_round=drop)
        self._dropped = drop
        return state

    def _detect(self, state, step: int) -> None:
        """Stall accounting and the retry / backoff / evict ladder."""
        mem = self.membership
        clock = getattr(state, "clock", None)
        if clock is not None:          # AD-PSGD: real per-learner progress
            # wedge detection reads the device's progress once a tick: an
            # intended sync
            c = np.asarray(clock.cpu())             # lint: allow-host-sync
            advanced = c > self._last_clock
            self._last_clock = np.maximum(self._last_clock, c)
        else:                          # sync DPSGD: a heartbeat's view
            se = mem.slow_every
            advanced = (mem.active & (se < HUNG)
                        & (step % np.maximum(se, 1) == 0))
        self._stall = np.where(advanced | ~mem.active, 0, self._stall + 1)
        base = self.staleness_bound * self.grace
        for i in np.flatnonzero(mem.active):
            if self._stall[i] <= base * (1 << int(self._retries[i])):
                continue
            if self._retries[i] < self.max_retries:
                self._retries[i] += 1
                self.report.retries.append((step, int(i)))
                if i not in self._sticky:      # a transient wedge: unstick it
                    mem.recover(int(i))
            else:
                mem.crash(int(i))
                self._sticky.discard(int(i))
                self._stall[i] = 0
                self._retries[i] = 0
                self.report.evictions.append((step, int(i)))

    # -- convenience driver ---------------------------------------------------
    def run(self, state, batch_fn, steps: int, start: int = 0):
        """The supervised loop: tick, step, repeat; ``batch_fn(i)`` gives
        the stacked batch of host step ``i``.  Returns (state, losses), the
        losses read from the device once, at the end."""
        losses = []
        for i in range(start, start + steps):
            state = self.tick(state, i)
            state, m = self.trainer.train_step(state, batch_fn(i))
            losses.append(m.loss)
        return state, (torch.stack(losses).tolist() if losses else [])
