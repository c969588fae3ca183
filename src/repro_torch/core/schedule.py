"""GossipSchedule: compiled K-neighbour gossip schedules — the port of
``repro/core/schedule.py``.

Every topology compiles into one uniform form that the fused gossip kernel
(``kernels/gossip_mix.py``) consumes directly:

    per round r:  partners[r]  (K, n) int32   neighbour index table
                  coefs[r]     (n, K+1) f32   [self, neighbour...] weights

A round is one neighbour-gather mix ``w_i <- c_i0 w_i + sum_k c_ik
w_{partners[k,i]}``; a step runs ``rounds_per_step`` rounds and the cycle
repeats with period ``period``.  K is static: rounds with fewer neighbours
are padded with zero-weight self-loops.  The compilation is numpy on the
host, as in the reference, so the tables of every deterministic topology
equal the reference's exactly.

Randomized schedules (``random_pair``, ``random_matching``) draw each
round's matching from a ``torch.Generator`` on the caller's device: the
reference's law, not its ``jax.random`` draws.  ``spectral_gap_profile``
measures a schedule's consensus contraction against its spectral-gap
bound.  ``reschedule`` recompiles a topology onto an elastic fleet's live
slots (``core/membership.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import topology as topo

__all__ = ["GossipSchedule", "make_schedule", "reschedule",
           "spectral_gap_profile", "SCHEDULED_TOPOLOGIES",
           "DETERMINISTIC_TOPOLOGIES"]

SCHEDULED_TOPOLOGIES = ("full", "ring", "torus", "random_pair",
                        "hierarchical", "exp", "one_peer_exp",
                        "random_matching")
DETERMINISTIC_TOPOLOGIES = ("full", "ring", "torus", "hierarchical", "exp",
                            "one_peer_exp")


@dataclasses.dataclass(frozen=True, eq=False)
class GossipSchedule:
    """Compiled schedule: static metadata + per-round index/coef tables."""
    name: str
    n: int
    K: int                     # static neighbour count (self-loop padded)
    period: int                # distinct rounds in the repeating cycle
    rounds_per_step: int       # rounds executed per train step
    randomized: bool           # matchings drawn from a generator
    symmetric: bool            # every realized per-STEP matrix symmetric
    perm_rounds: bool          # every partner row is a permutation
    partners: np.ndarray       # (period, K, n) int32
    coefs: np.ndarray          # (period, n, K+1) f32
    step_mats: Optional[np.ndarray]  # (variants, n, n) f32; None if randomized
    # elastic membership (``reschedule``): ``n`` is the fleet capacity and
    # ``active`` marks the live slots; inactive rows and columns are the
    # identity in every realized matrix.  None: a fixed-n schedule
    active: Optional[np.ndarray] = None
    # device copies of the tables, made once per device on first use
    _on_device: Dict[str, list] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def time_varying(self) -> bool:
        """True when the realized per-step matrix changes across steps."""
        return self.randomized or self.rounds_per_step % self.period != 0

    def _tables(self, device) -> list:
        dev = torch.device("cpu" if device is None else device)
        key = str(dev)
        if key not in self._on_device:
            self._on_device[key] = [
                (torch.as_tensor(self.partners[r], device=dev),
                 torch.as_tensor(self.coefs[r], device=dev))
                for r in range(self.period)]
        return self._on_device[key]

    def round_tables(self, gen: Optional[torch.Generator], r: int,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tables for global round ``r``: (partners (K, n) int32, coefs
        (n, K+1) f32), on ``gen.device`` for randomized schedules (the
        matching is drawn from ``gen``) and on ``device`` otherwise."""
        if self.randomized:
            partner = self._draw(gen)
            solo = partner == torch.arange(self.n, device=partner.device)
            self_c = torch.where(solo, 1.0, 0.5).to(torch.float32)
            return (partner[None].to(torch.int32),
                    torch.stack([self_c, 1.0 - self_c], dim=1))
        return self._tables(device)[r % self.period]

    def _draw(self, gen: torch.Generator) -> torch.Tensor:
        """One matching: over every slot, or over the live ones only."""
        if self.active is None:
            return topo.pair_partners(gen, self.n)
        return topo.masked_pair_partners(gen, self.active)

    def step_rounds(self, gen: Optional[torch.Generator], step: int,
                    device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """All rounds executed at ``step``, in execution order.
        Deterministic schedules index the compiled tables at
        ``(step * rounds_per_step + j) % period``; randomized ones draw one
        matching per round from ``gen``."""
        out = []
        for j in range(self.rounds_per_step):
            if self.randomized or not self.time_varying:
                out.append(self.round_tables(gen, j, device))
            else:
                out.append(self.round_tables(
                    gen, step * self.rounds_per_step + j, device))
        return out

    def step_matrix(self, gen: Optional[torch.Generator], step: int,
                    device=None) -> torch.Tensor:
        """The (n, n) mixing matrix one step realizes (its rounds'
        product): what the unfused path multiplies by."""
        if self.randomized:
            m = topo.partner_matrix(self._draw(gen), self.n)
            for _ in range(1, self.rounds_per_step):
                m = topo.partner_matrix(self._draw(gen), self.n) @ m
            return m
        v = step % self.step_mats.shape[0]
        return torch.as_tensor(self.step_mats[v], device=device)

    def mean_matrix(self) -> np.ndarray:
        """Period-average of the per-step matrices (deterministic only)."""
        if self.randomized:
            raise ValueError("randomized schedules have no fixed mean")
        return np.asarray(self.step_mats, np.float64).mean(0)


# ---------------------------------------------------------------------------
# compilation (numpy, as in the reference)
# ---------------------------------------------------------------------------

def _round_matrix(partners_r: np.ndarray, coefs_r: np.ndarray) -> np.ndarray:
    """(K, n) partners + (n, K+1) coefs -> dense (n, n) f64 mixing matrix."""
    n = partners_r.shape[1]
    m = np.zeros((n, n))
    m[np.arange(n), np.arange(n)] += coefs_r[:, 0].astype(np.float64)
    for k in range(partners_r.shape[0]):
        m[np.arange(n), partners_r[k]] += coefs_r[:, 1 + k].astype(np.float64)
    return m


def _compile(name: str, n: int, rounds: List[Tuple[np.ndarray, np.ndarray]],
             rounds_per_step: int) -> GossipSchedule:
    """Pad per-round tables to a common static K, realize the matrices,
    and check the schedule contract once, at compile time."""
    K = max(p.shape[0] for p, _ in rounds)
    period = len(rounds)
    partners = np.tile(np.arange(n, dtype=np.int32), (period, K, 1))
    coefs = np.zeros((period, n, K + 1), np.float32)
    for r, (p, c) in enumerate(rounds):
        kr = p.shape[0]
        partners[r, :kr] = p.astype(np.int32)
        coefs[r, :, 0] = c[:, 0]
        coefs[r, :, 1:1 + kr] = c[:, 1:]

    perm = all((np.sort(partners[r, k]) == np.arange(n)).all()
               for r in range(period) for k in range(K))
    round_mats = [_round_matrix(partners[r], coefs[r]) for r in range(period)]
    for r, m in enumerate(round_mats):
        if not topo.is_doubly_stochastic(m):
            raise AssertionError(f"{name} round {r} is not doubly stochastic")

    variants = (1 if rounds_per_step % period == 0
                else period // math.gcd(period, rounds_per_step))
    step_mats = []
    for v in range(variants):
        m = np.eye(n)
        for j in range(rounds_per_step):
            m = round_mats[(v * rounds_per_step + j) % period] @ m
        step_mats.append(m)
    step_mats = np.asarray(step_mats)
    symmetric = bool(np.allclose(step_mats, step_mats.transpose(0, 2, 1),
                                 atol=1e-12))
    return GossipSchedule(
        name=name, n=n, K=K, period=period, rounds_per_step=rounds_per_step,
        randomized=False, symmetric=symmetric, perm_rounds=perm,
        partners=partners, coefs=coefs,
        step_mats=step_mats.astype(np.float32))


def _shift_round(n: int, shifts, weights, self_weight: float):
    """Round built from circulant index shifts: partner k of i is
    (i + shifts[k]) % n with weight weights[k]."""
    idx = np.arange(n)
    partners = np.stack([(idx + s) % n for s in shifts]).astype(np.int32)
    coefs = np.concatenate(
        [np.full((n, 1), self_weight),
         np.tile(np.asarray(weights, np.float64)[None, :], (n, 1))],
        axis=1).astype(np.float32)
    return partners, coefs


def _ring_rounds(n: int):
    if n == 2:
        return [_shift_round(2, [1], [0.5], 0.5)]
    side = (1.0 - 1.0 / 3.0) / 2.0
    return [_shift_round(n, [1, n - 1], [side, side], 1.0 / 3.0)]


def _torus_rounds(n: int):
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    rows, cols = r, n // r
    idx = np.arange(n)
    rr, cc = idx // cols, idx % cols

    def grid(dr, dc):
        return (((rr + dr) % rows) * cols + (cc + dc) % cols).astype(np.int32)
    partners = np.stack([grid(1, 0), grid(-1, 0), grid(0, 1), grid(0, -1)])
    coefs = np.full((n, 5), 1.0 / 5.0, np.float32)
    return [(partners, coefs)]


def _full_rounds(n: int):
    if n & (n - 1) == 0:       # hypercube: product of log2 n pairings == 1/n
        idx = np.arange(n)
        out = []
        for b in range(int(math.log2(n))):
            partners = (idx ^ (1 << b)).astype(np.int32)[None]
            coefs = np.full((n, 2), 0.5, np.float32)
            out.append((partners, coefs))
        return out
    return [_shift_round(n, list(range(1, n)), [1.0 / n] * (n - 1), 1.0 / n)]


def _hier_dims(n: int) -> Tuple[int, int]:
    g = int(np.sqrt(n))
    while n % g:
        g -= 1
    return n // g, g            # (n_super, group)


def _hierarchical_rounds(n: int):
    S, g = _hier_dims(n)
    if g == 1:                  # no intra grouping possible: plain ring
        return _ring_rounds(n)
    if S == 1:                  # one group: plain full average
        return _full_rounds(n)
    idx = np.arange(n)
    grp, mem = idx // g, idx % g

    def slot(d, s):
        return (((grp + d) % S) * g + (mem + s) % g).astype(np.int32)

    # round 0: intra-group full average
    intra_p = np.stack([slot(0, s) for s in range(1, g)])
    intra_c = np.full((n, g), 1.0 / g, np.float32)
    # round 1: ring across super-learners, uniform within the remote group
    ring_row = topo.ring_matrix(S).numpy().astype(np.float64)[0]
    slots, weights = [], []
    for d in range(S):
        if ring_row[d] <= 0:
            continue
        for s in range(g):
            if d == 0 and s == 0:
                continue        # the self slot
            slots.append(slot(d, s))
            weights.append(ring_row[d] / g)
    inter_p = np.stack(slots)
    inter_c = np.concatenate(
        [np.full((n, 1), ring_row[0] / g),
         np.tile(np.asarray(weights, np.float64)[None, :], (n, 1))],
        axis=1).astype(np.float32)
    return [(intra_p, intra_c), (inter_p, inter_c)]


def _exp_tau(n: int) -> int:
    return max(1, int(math.ceil(math.log2(n))))


def _exp_rounds(n: int):
    tau = _exp_tau(n)
    shifts = [(1 << j) % n for j in range(tau)]
    return [_shift_round(n, shifts, [1.0 / (2 * tau)] * tau, 0.5)]


def _one_peer_exp_rounds(n: int):
    tau = _exp_tau(n)
    return [_shift_round(n, [(1 << j) % n], [0.5], 0.5) for j in range(tau)]


def make_schedule(topology: str, n: int, *,
                  rounds: int = 1) -> Optional[GossipSchedule]:
    """Compile ``topology`` for ``n`` learners; ``rounds`` is the
    multi-round mixing depth for ``random_matching``.  Returns None for
    ``solo`` (and any n <= 1); raises ValueError for unknown topologies."""
    topology = topology.lower()
    if topology not in SCHEDULED_TOPOLOGIES + ("solo",):
        raise ValueError(f"unknown topology: {topology}")
    if topology == "solo" or n <= 1:
        return None
    if topology in ("random_pair", "random_matching"):
        r = 1 if topology == "random_pair" else max(1, rounds)
        return GossipSchedule(
            name=topology, n=n, K=1, period=1, rounds_per_step=r,
            randomized=True, symmetric=r == 1, perm_rounds=True,
            partners=np.tile(np.arange(n, dtype=np.int32), (1, 1, 1)),
            coefs=np.concatenate([np.ones((1, n, 1), np.float32),
                                  np.zeros((1, n, 1), np.float32)], axis=-1),
            step_mats=None)
    round_makers = {"ring": _ring_rounds, "torus": _torus_rounds,
                "full": _full_rounds, "hierarchical": _hierarchical_rounds,
                "exp": _exp_rounds, "one_peer_exp": _one_peer_exp_rounds}
    round_list = round_makers[topology](n)
    # one-peer exponential runs ONE round of its cycle per step; the
    # multi-round compilations (full-as-rounds, hierarchical) run their
    # whole cycle each step
    rps = 1 if topology == "one_peer_exp" else len(round_list)
    return _compile(topology, n, round_list, rps)


# ---------------------------------------------------------------------------
# elastic membership: recompile a topology onto the live active set
# ---------------------------------------------------------------------------

def _identity_tables(cap: int):
    """One round of self-loops: partners (1, 1, cap), coefs [1, 0]."""
    partners = np.tile(np.arange(cap, dtype=np.int32), (1, 1, 1))
    coefs = np.concatenate([np.ones((1, cap, 1), np.float32),
                            np.zeros((1, cap, 1), np.float32)], axis=-1)
    return partners, coefs


def _identity_schedule(topology: str, cap: int,
                       active: np.ndarray) -> GossipSchedule:
    partners, coefs = _identity_tables(cap)
    return GossipSchedule(
        name=topology, n=cap, K=1, period=1, rounds_per_step=1,
        randomized=False, symmetric=True, perm_rounds=True,
        partners=partners, coefs=coefs,
        step_mats=np.eye(cap, dtype=np.float32)[None], active=active)


def reschedule(topology: str, active, *, rounds: int = 1) -> GossipSchedule:
    """Recompile ``topology`` for the live set of a capacity fleet.

    ``active``: (capacity,) bool.  Returns a capacity-sized schedule whose
    realized matrices are the identity on the inactive slots and exactly
    ``make_schedule(topology, n_active)``'s on the active ones (active
    rank i plays slot ``flatnonzero(active)[i]``), so every matrix stays
    doubly stochastic and restricts to a conformant one over the live
    learners.  No live row's neighbour slot, padding included, points at a
    dead slot: a self-loop pad maps to the row's own live slot.

    Randomized topologies return a masked-draw schedule (the matching is
    drawn over the active set at each step).  A fleet with <= 1 live
    learner, or ``solo``, compiles to explicit identity tables.
    """
    active = np.ascontiguousarray(np.asarray(active, dtype=bool))
    cap = int(active.shape[0])
    idx = np.flatnonzero(active)
    m = int(idx.size)
    topology = topology.lower()
    if topology not in SCHEDULED_TOPOLOGIES + ("solo",):
        raise ValueError(f"unknown topology: {topology}")
    if topology in ("random_pair", "random_matching") and m > 1:
        r = 1 if topology == "random_pair" else max(1, rounds)
        partners, coefs = _identity_tables(cap)
        return GossipSchedule(
            name=topology, n=cap, K=1, period=1, rounds_per_step=r,
            randomized=True, symmetric=r == 1, perm_rounds=True,
            partners=partners, coefs=coefs, step_mats=None, active=active)
    inner = (None if (topology == "solo" or m <= 1)
             else make_schedule(topology, m, rounds=rounds))
    if inner is None:
        return _identity_schedule(topology, cap, active)
    P, K = inner.period, inner.K
    partners = np.tile(np.arange(cap, dtype=np.int32), (P, K, 1))
    coefs = np.zeros((P, cap, K + 1), np.float32)
    coefs[:, :, 0] = 1.0                        # inactive rows: self-loops
    partners[:, :, idx] = idx[inner.partners]   # active rank -> slot
    coefs[:, idx, :] = inner.coefs
    step_mats = None
    if inner.step_mats is not None:
        V = inner.step_mats.shape[0]
        step_mats = np.tile(np.eye(cap, dtype=np.float32), (V, 1, 1))
        step_mats[np.ix_(np.arange(V), idx, idx)] = inner.step_mats
    return GossipSchedule(
        name=inner.name, n=cap, K=K, period=P,
        rounds_per_step=inner.rounds_per_step, randomized=False,
        symmetric=inner.symmetric, perm_rounds=inner.perm_rounds,
        partners=partners, coefs=coefs, step_mats=step_mats, active=active)


# ---------------------------------------------------------------------------
# analyzer: measured consensus contraction vs the spectral-gap bound
# ---------------------------------------------------------------------------

def _no_contraction(window: int) -> dict:
    w = max(window, 1)
    return {"window": w, "per_step_gap": [0.0] * w, "measured_rate": 1.0,
            "bound_rate": 1.0, "measured_gap": 0.0, "gap_bound": 0.0}


def spectral_gap_profile(schedule: Optional[GossipSchedule], *,
                         window: int = 0,
                         gen: Optional[torch.Generator] = None,
                         seed: int = 0, floor: float = 1e-6) -> dict:
    """Measure a schedule's consensus contraction over ``window`` steps.

    For each step matrix M_t the contraction on the disagreement subspace
    is eta_t = ||M_t - J||_2 (J = 11^T / n; for a symmetric doubly
    stochastic M this is |lambda_2|).  Submultiplicativity bounds the
    window product Phi by ||Phi - J||_2 <= prod eta_t; the measured rate is
    ||Phi - J||_2^(1/window).  Both in float64; returns the per-step gaps
    and ``measured_rate <= bound_rate``, ``measured_gap = 1 -
    measured_rate``, ``gap_bound = 1 - bound_rate``.

    ``schedule=None`` (solo) profiles the identity: no contraction; a
    ``reschedule`` schedule is profiled over its active set.
    ``window=0`` takes max(8, twice the cycle of step matrices).
    Randomized schedules draw their matchings from ``gen`` (default: a CPU
    generator seeded with ``seed``).  The tables are float32, so both
    norms are clamped at ``floor`` before the root: a window that mixes
    below it is unresolvable, and the clamp keeps the inequality there.
    """
    if schedule is None:
        return _no_contraction(window)
    # an elastic schedule contracts over its active set: the inactive rows
    # are the identity by construction, so every step matrix is restricted
    # to the live submatrix, which is exact
    sub = None
    if schedule.active is not None:
        sub = np.flatnonzero(np.asarray(schedule.active, bool))
        if sub.size <= 1:
            return _no_contraction(window)
    n = schedule.n if sub is None else int(sub.size)
    if not window:
        window = max(8, 2 * max(
            1, schedule.period // math.gcd(schedule.period,
                                           schedule.rounds_per_step)))
    if gen is None:
        gen = torch.Generator().manual_seed(seed)
    J = np.full((n, n), 1.0 / n)
    phi = np.eye(n)
    etas = []
    for t in range(window):
        m = schedule.step_matrix(gen, t).cpu().numpy().astype(np.float64)
        if sub is not None:
            m = m[np.ix_(sub, sub)]
        phi = m @ phi
        etas.append(float(np.linalg.norm(m - J, 2)))
    measured_rate = max(float(np.linalg.norm(phi - J, 2)),
                        floor) ** (1.0 / window)
    bound_rate = max(float(np.prod(etas)), floor) ** (1.0 / window)
    return {"window": window, "per_step_gap": [1.0 - e for e in etas],
            "measured_rate": measured_rate, "bound_rate": bound_rate,
            "measured_gap": 1.0 - measured_rate,
            "gap_bound": 1.0 - bound_rate}
