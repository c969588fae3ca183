"""Elastic learner membership for the decentralized fleet (DESIGN §15) —
the port of ``repro/core/membership.py``.

A fleet is allocated at its capacity once; liveness is data, never a shape:

  * :class:`Membership` is the host-side source of truth: the active mask,
    per-learner incarnation counters (bumped on every (re)join), per-learner
    ``slow_every`` tick divisors (1 = healthy, k = degraded, ``HUNG`` =
    wedged) and a fleet ``epoch`` that bumps on every change.
  * :class:`MemberState` is its device-side bundle, carried by
    ``TrainState.members``: the mask, the divisors, the dropped-round flag
    and, for a deterministic DPSGD topology, the ``reschedule`` tables, all
    device tensors built when the membership is set, so ``train_step``
    never reads them back.
  * A dead learner is a permanently inactive straggler: its row carries no
    mixing weight (the gossip kernel's ``active`` column, the only-active
    matching and tables), its parameter, momentum and buffer rows stay
    quarantined in place for a later rejoin, and the masked metrics and
    consensus exclude it.
  * :func:`admit` is the state surgery of a (re)join: a fresh joiner clones
    the consensus mean of the live learners into its slot; a quarantine
    rejoin resumes from the parked rows.

The scheduling half lives in ``schedule.reschedule`` and
``topology.masked_pair_partners``; the fault harness that drives all of
this is ``core/faults.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..tree import tree_map
from . import schedule as gsched

__all__ = ["Membership", "MemberState", "HUNG", "admit"]

# a wedged learner: never completes a step again until recovered (the
# supervisor's staleness detector evicts it); 2^30 keeps step % safe in int32
HUNG = 1 << 30


class MemberState(NamedTuple):
    """Device-side membership bundle (the fields of the reference's).

    ``partners`` / ``coefs`` are the ``reschedule`` tables of an elastic
    deterministic-topology DPSGD fleet ((period, K, n) int32 / (period, n,
    K + 1) float32); None for randomized matchings (drawn at each step from
    the mask) and for AD-PSGD.
    """
    active: torch.Tensor        # (n,) bool: live fleet members
    incarnation: torch.Tensor   # (n,) int32: bumped per (re)join
    slow_every: torch.Tensor    # (n,) int32: completes a step every k ticks
    drop_round: torch.Tensor    # () bool: this tick's gossip round dropped
    partners: Any = None
    coefs: Any = None


@dataclasses.dataclass
class Membership:
    """Host-side elastic fleet state (capacity-sized, mutable masks)."""
    capacity: int
    active: Optional[np.ndarray] = None
    incarnation: Optional[np.ndarray] = None
    slow_every: Optional[np.ndarray] = None
    epoch: int = 0               # fleet version: bumps on every change

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        cap = self.capacity
        self.active = (np.ones((cap,), bool) if self.active is None
                       else np.asarray(self.active, bool).copy())
        self.incarnation = (np.zeros((cap,), np.int32)
                            if self.incarnation is None
                            else np.asarray(self.incarnation, np.int32).copy())
        self.slow_every = (np.ones((cap,), np.int32)
                           if self.slow_every is None
                           else np.asarray(self.slow_every, np.int32).copy())

    # -- queries -------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def active_indices(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    def _slot(self, i: int) -> int:
        if not 0 <= i < self.capacity:
            raise ValueError(f"slot {i} outside a fleet of {self.capacity}")
        return int(i)

    # -- transitions (each bumps the fleet epoch) -----------------------------
    def crash(self, i: int) -> None:
        """Learner ``i`` dies or leaves: a permanently inactive straggler
        whose rows stay quarantined in the state for a possible rejoin."""
        i = self._slot(i)
        self.active[i] = False
        self.slow_every[i] = 1
        self.epoch += 1

    leave = crash     # a graceful leave and a detected crash mask alike

    def join(self, slot: Optional[int] = None) -> int:
        """Activate an inactive slot (the first free one by default) and
        return it.  Bumps its incarnation; the state surgery is the
        caller's (:func:`admit`)."""
        if slot is None:
            free = np.flatnonzero(~self.active)
            if free.size == 0:
                raise ValueError("fleet at capacity: no inactive slot")
            slot = int(free[0])
        slot = self._slot(slot)
        if self.active[slot]:
            raise ValueError(f"slot {slot} already active")
        self.active[slot] = True
        self.incarnation[slot] += 1
        self.slow_every[slot] = 1
        self.epoch += 1
        return slot

    rejoin = join

    def set_slow(self, i: int, every: int) -> None:
        """Degrade learner ``i`` to one completed step per ``every``
        ticks."""
        i = self._slot(i)
        if every < 1:
            raise ValueError(f"slow_every must be >= 1, got {every}")
        self.slow_every[i] = every
        self.epoch += 1

    def hang(self, i: int) -> None:
        """Wedge learner ``i``: it stays a member but never completes a
        step; the supervisor's staleness detector is what evicts it."""
        self.set_slow(i, HUNG)

    def recover(self, i: int) -> None:
        self.set_slow(i, 1)

    # -- device bundle --------------------------------------------------------
    def member_state(self, topology: Optional[str] = None, *,
                     gossip_rounds: int = 1, drop_round: bool = False,
                     device=None) -> MemberState:
        """The device bundle of the current membership, on ``device``.
        ``topology`` (DPSGD): a deterministic topology embeds its
        ``reschedule`` tables at capacity; randomized matchings (and
        AD-PSGD, which passes None) carry none."""
        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        partners = coefs = None
        if topology is not None and topology.lower() not in (
                "random_pair", "random_matching"):
            s = gsched.reschedule(topology, self.active,
                                  rounds=gossip_rounds)
            partners = dev(s.partners, torch.int32)
            coefs = dev(s.coefs, torch.float32)
        return MemberState(
            active=dev(self.active, torch.bool),
            incarnation=dev(self.incarnation, torch.int32),
            slow_every=dev(self.slow_every, torch.int32),
            drop_round=dev(drop_round, torch.bool),
            partners=partners, coefs=coefs)


def _set_row(x, slot: int, value):
    """A copy of the stacked leaf ``x`` with row ``slot`` set to ``value``
    (a tensor, cast to ``x``'s dtype, or a number)."""
    out = x.clone()
    out[slot] = value.to(x.dtype) if isinstance(value, torch.Tensor) \
        else value
    return out


def admit(trainer, state, slot: int, *, mode: str = "consensus"):
    """State surgery for a learner (re)joining at ``slot``.

    ``mode="consensus"``: the joiner's parameter (and published-buffer)
    rows take the consensus mean of the learners active in
    ``state.members`` (call this before the slot turns live), computed in
    float32 with the dead rows excluded by ``where``; its optimizer row is
    freshly initialized (momentum from a dead past would be stale
    curvature).  ``mode="quarantine"``: resume from the rows parked at
    eviction.  Either way its ``age`` and ``clock`` restart at zero.

    The surgery goes through ``trainer.state_view`` / ``state_from_view``,
    so it serves both engines and returns a state bound to the trainer's
    store; the flatten is paid at membership changes only, never in the
    step.  Like ``train_step``, it consumes ``state``.
    """
    if mode not in ("consensus", "quarantine"):
        raise ValueError(f"unknown admit mode {mode!r}")
    if state.members is None:
        raise ValueError("admit needs an elastic state (set_membership)")
    if mode == "consensus":
        view = trainer.state_view(state)
        act = state.members.active
        denom = torch.clamp(torch.sum(act), min=1)

        def clone_row(x):
            m = act.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
            mean = torch.sum(torch.where(m, x.float(), 0.0), dim=0) / denom
            return _set_row(x, slot, mean)

        params = tree_map(clone_row, view.params)
        buffer = view.buffer
        if buffer is not None:     # the joiner publishes its cloned weights
            buffer = tree_map(lambda b, p: _set_row(b, slot, p[slot]),
                              buffer, params)
        fresh = trainer.optimizer.init(
            tree_map(lambda x: x[slot:slot + 1], params))
        n = act.shape[0]

        def reset(s, f):
            if (isinstance(s, torch.Tensor) and s.dim() >= 1
                    and s.shape[0] == n):
                return _set_row(s, slot, torch.as_tensor(f)[0])
            return s
        opt = tree_map(reset, view.opt_state, fresh)
        state = trainer.state_from_view(
            view._replace(params=params, opt_state=opt, buffer=buffer))
    if state.age is not None:
        state = state._replace(age=_set_row(state.age, slot, 0))
    if state.clock is not None:
        state = state._replace(clock=_set_row(state.clock, slot, 0))
    return state
