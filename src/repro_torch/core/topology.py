"""Gossip topologies / mixing matrices for decentralized SGD — the port of
``repro/core/topology.py``.

A mixing matrix M is doubly stochastic: each learner's new weights are a
convex combination of its neighbours', and the average weight evolves by
the average gradient (paper Eq. 3).  The paper's production recipe
(Sec. 4, App. F) pairs every learner with one random neighbour each
iteration: a random perfect matching.

Matchings are drawn from a ``torch.Generator`` on its own device, so a
trainer on the card draws them there with no host round trip.  They follow
the reference's law (a uniform random permutation, paired consecutively),
not its ``jax.random`` draws.  ``masked_pair_partners`` draws the elastic
fleet's matching over its live slots only (``core/membership.py``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["full_matrix", "ring_matrix", "torus_matrix", "pair_partners",
           "masked_pair_partners", "partner_matrix", "random_pair_matrix",
           "hierarchical_matrix", "exponential_matrix",
           "is_doubly_stochastic", "spectral_gap", "make_mixing_fn"]


def _t(m, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(m), dtype=dtype)


def full_matrix(n: int, dtype=torch.float32) -> torch.Tensor:
    """All-to-all averaging: DPSGD degenerates to SSGD weight dynamics."""
    return torch.full((n, n), 1.0 / n, dtype=dtype)


def ring_matrix(n: int, self_weight: float = 1.0 / 3.0,
                dtype=torch.float32) -> torch.Tensor:
    """Symmetric ring: average with left and right neighbour."""
    if n == 1:
        return torch.ones((1, 1), dtype=dtype)
    if n == 2:
        return torch.full((2, 2), 0.5, dtype=dtype)
    side = (1.0 - self_weight) / 2.0
    eye = np.eye(n)
    left = np.roll(np.eye(n), 1, axis=1)
    right = np.roll(np.eye(n), -1, axis=1)
    return _t(self_weight * eye + side * (left + right), dtype)


def torus_matrix(rows: int, cols: int, dtype=torch.float32) -> torch.Tensor:
    """2D torus: self + 4 neighbours, weight 1/5 each."""
    n = rows * cols
    m = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j in (i, ((r + 1) % rows) * cols + c,
                      ((r - 1) % rows) * cols + c,
                      r * cols + (c + 1) % cols,
                      r * cols + (c - 1) % cols):
                m[i, j] += 1.0 / 5.0
    return _t(m, dtype)


def pair_partners(gen: torch.Generator, n: int) -> torch.Tensor:
    """Random perfect matching as a partner-index vector (int64, on
    ``gen.device``): partner[i] == j and partner[j] == i for each matched
    pair; for odd n one learner stays solo (partner[i] == i)."""
    perm = torch.randperm(n, generator=gen, device=gen.device)
    k = (n // 2) * 2
    a, b = perm[:k:2], perm[1:k:2]
    partner = torch.arange(n, device=gen.device)
    partner[a] = b
    partner[b] = a
    return partner


def masked_pair_partners(gen: torch.Generator, active,
                         drop=None) -> torch.Tensor:
    """Random perfect matching over the ACTIVE slots of a capacity-n fleet
    (int64, on ``gen.device``).

    Inactive slots are always solo (partner[i] == i) and no active slot is
    ever matched to an inactive one, so a dead learner's row carries zero
    mixing weight with no table recompile.  The draw consumes ``gen``
    exactly as ``pair_partners`` does (one ``randperm(n)``): the active
    slots are paired consecutively along that permutation with the
    inactive ones spliced out, so an all-active fleet reproduces the
    legacy matching bitwise.  ``drop`` (a 0-dim bool tensor) forces
    everyone solo: a dropped gossip round.  The live count stays a
    device tensor (no host sync); an odd count leaves the last-ranked
    live slot solo."""
    dev = gen.device
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    n = active.shape[0]
    idx = torch.arange(n, device=dev)
    perm = torch.randperm(n, generator=gen, device=dev)
    act_in_order = active[perm]
    # rank of each permutation position among the active ones so far
    rank = torch.cumsum(act_in_order.to(torch.int64), 0) - 1
    m = torch.sum(active)
    # slot_of_rank[r] = the active slot ranked r; the inactive positions
    # scatter into a spare (n + 1)-th entry that is sliced off
    slot_of_rank = torch.zeros((n + 1,), dtype=perm.dtype, device=dev)
    slot_of_rank[torch.where(act_in_order, rank, n)] = perm
    slot_of_rank = slot_of_rank[:n]
    rank_of_slot = torch.zeros((n,), dtype=rank.dtype, device=dev)
    rank_of_slot[perm] = rank
    mate_rank = rank_of_slot ^ 1
    paired = active & (mate_rank < m)
    partner = torch.where(paired, slot_of_rank[mate_rank % n], idx)
    if drop is not None:
        partner = torch.where(torch.as_tensor(drop, device=dev), idx,
                              partner)
    return partner


def partner_matrix(partner: torch.Tensor, n: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Dense mixing matrix of an involutive partner vector: 0.5 (I + P).
    Solo rows (partner[i] == i) come out exactly e_i."""
    dev = partner.device
    p = torch.zeros((n, n), dtype=dtype, device=dev)
    p[torch.arange(n, device=dev), partner.long()] = 1.0
    return 0.5 * (torch.eye(n, dtype=dtype, device=dev) + p)


def random_pair_matrix(gen: torch.Generator, n: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Random perfect matching as a matrix: 0.5 (I + P)."""
    return partner_matrix(pair_partners(gen, n), n, dtype)


def hierarchical_matrix(n_super: int, group: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Paper App. F: ``group`` nearby learners form a super-learner that
    fully averages internally; super-learners gossip on a ring."""
    intra = np.kron(np.eye(n_super), np.full((group, group), 1.0 / group))
    outer = ring_matrix(n_super).numpy()
    inter = np.kron(outer, np.full((group, group), 1.0 / group))
    return _t(inter @ intra, dtype)


def exponential_matrix(n: int, dtype=torch.float32) -> torch.Tensor:
    """Static exponential graph: neighbours at offsets 2^0..2^(tau-1)
    (tau = ceil(log2 n)), self weight 1/2, each neighbour 1/(2 tau)."""
    if n <= 1:
        return torch.ones((1, 1), dtype=dtype)
    tau = max(1, int(np.ceil(np.log2(n))))
    m = 0.5 * np.eye(n)
    for j in range(tau):
        m += np.roll(np.eye(n), (1 << j) % n, axis=1) / (2 * tau)
    return _t(m, dtype)


def _np(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    return np.asarray(m, dtype=np.float64)


def is_doubly_stochastic(m, atol: float = 1e-5) -> bool:
    m = _np(m)
    return bool(np.all(m >= -atol)
                and np.allclose(m.sum(0), 1.0, atol=atol)
                and np.allclose(m.sum(1), 1.0, atol=atol))


def spectral_gap(m) -> float:
    """1 - |lambda_2|: convergence rate of the gossip averaging process."""
    ev = np.sort(np.abs(np.linalg.eigvals(_np(m))))[::-1]
    return float(1.0 - (ev[1] if len(ev) > 1 else 0.0))


def _factor(n: int) -> int:
    """The largest divisor of n at or below sqrt(n), as the reference
    picks a torus's rows and a hierarchy's group size."""
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r


def make_mixing_fn(topology: str, n: int):
    """-> ``mix_matrix(gen) -> (n, n)`` float32 mixing matrix for a step.

    Static topologies ignore the generator; ``random_pair`` draws a fresh
    perfect matching from it each call (on ``gen.device``).  The
    time-varying schedules (``one_peer_exp``, ``random_matching``) have no
    single per-step matrix and raise ValueError, as any unknown name does:
    compile them with ``core.schedule.make_schedule``."""
    topology = topology.lower()
    if topology == "random_pair":
        return lambda gen: random_pair_matrix(gen, n)
    if topology == "full":
        m = full_matrix(n)
    elif topology == "ring":
        m = ring_matrix(n)
    elif topology == "torus":
        r = _factor(n)
        m = torus_matrix(r, n // r)
    elif topology == "hierarchical":
        g = _factor(n)
        m = (hierarchical_matrix(n // g, g) if 1 < g < n
             else ring_matrix(n))
    elif topology == "exp":
        m = exponential_matrix(n)
    elif topology == "solo":          # no mixing (local SGD w/o averaging)
        m = torch.eye(n)
    else:
        raise ValueError(f"unknown topology: {topology}")
    return lambda gen: m
