"""Multi-learner update rules, the single-device half — the port of
``repro/core/dpsgd.py``.

All functions operate on stacked trees (or single tensors) whose leaves
carry a leading learner axis of size n.  One DPSGD step (paper Eq. 2,
"mix then descend"):

    g_j   = grad L^{mu_j}(w_j)            # gradient at the LOCAL weights
    w_s,j = sum_k M_jk w_k                # gossip average of neighbours
    w_j   <- w_s,j - alpha * g_j

SSGD (Eq. 1): g_j = grad L^{mu_j}(w_a); w_a <- w_a - alpha * mean_j g_j.
SSGD* takes SSGD's gradients at w_a + delta_j, delta_j ~ N(0, sigma0^2 I)
(``perturb_weights``).  AD-PSGD averages with a partner's possibly stale
published weights (see ``core/trainer.py``).  ``member_active_mask`` is
the elastic fleet's generalization of the injected straggler
(``core/membership.py``).

The collective half — one learner per rank of a ``torch.distributed``
group, the counterpart of the reference's ``mix_ppermute_*`` — is what the
launch step builders (``launch/train.py``) run:

  * ``round_slots`` reads one rank's live neighbour slots from one round
    of a compiled table (``partners (K, n)``, ``coefs (n, K + 1)``, host
    arrays): whom it receives from and sends to at each slot, skipping a
    padded self-loop as ``_schedule_perms`` does;
  * ``exchange`` posts a round's sends and receives together with
    ``dist.batch_isend_irecv`` and fills a (K, T, 128) receive stack in
    the wire dtype.  With an ``nccl`` group CUDA tensors go on the wire
    directly and nothing waits on the host; with a ``gloo`` group CUDA
    rows are staged through pinned host buffers (``HostStaging``),
    because gloo's send and receive take host memory — a host sync the
    caller chose with the backend;
  * ``mix_round`` is the plain float32 mixing of a round in the fused
    kernel's term order (self first, then the slots in order), for the
    unfused routes;
  * ``hypercube_partner`` / ``hypercube_tables`` are AD-PSGD's pairwise
    schedule (``rank ^ (1 << (step % log2 n))``) with the elastic gate,
    and ``pair_tables`` / ``matrix_round`` turn a matching or a step's
    mixing matrix into one round's tables.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map
from . import topology as topo
from .util import learner_mean, tree_add, tree_gaussian_like

__all__ = ["AlgoConfig", "mix_einsum", "mix_pair_gather",
           "straggler_active_mask", "member_active_mask", "perturb_weights",
           "mean_broadcast", "Slot", "round_slots", "HostStaging",
           "exchange", "mix_round", "hypercube_partner", "hypercube_tables",
           "pair_tables", "matrix_round"]


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """How the learners talk to each other (same fields and defaults as
    the reference).  Invalid combinations raise ``ValueError`` where the
    reference asserts."""
    algo: str = "dpsgd"            # dpsgd | ssgd | ssgd_star | adpsgd
    topology: str = "random_pair"  # see core/schedule.SCHEDULED_TOPOLOGIES
    gossip_backend: str = "einsum"  # einsum | ppermute
    gossip_order: str = "mix_then_descend"  # paper Eq. 2; or descend_then_mix
    noise_std: float = 0.01        # sigma_0 for ssgd_star
    n_learners: int = 16
    gossip_rounds: int = 1         # mixing rounds per step (random_matching)
    # -- adpsgd only --------------------------------------------------------
    max_staleness: int = 0         # staleness bound tau (ticks); 0 == sync
    slow_learner: int = -1         # index of the injected straggler (-1: none)
    slow_factor: int = 1           # straggler finishes a step every k ticks

    def __post_init__(self):
        def need(cond, msg):
            if not cond:
                raise ValueError(msg)
        need(self.algo in ("dpsgd", "ssgd", "ssgd_star", "adpsgd"),
             f"unknown algo {self.algo!r}")
        need(self.gossip_order in ("mix_then_descend", "descend_then_mix"),
             f"unknown gossip_order {self.gossip_order!r}")
        need(self.gossip_backend in ("einsum", "ppermute"),
             f"unknown gossip_backend {self.gossip_backend!r}")
        need(self.gossip_rounds >= 1, f"gossip_rounds={self.gossip_rounds}")
        need(self.gossip_rounds == 1 or self.topology == "random_matching",
             "gossip_rounds only parameterizes random_matching — other "
             "schedules fix their own round structure (it would be "
             "silently ignored)")
        need(self.max_staleness >= 0, f"max_staleness={self.max_staleness}")
        need(self.slow_factor >= 1, f"slow_factor={self.slow_factor}")
        need(-1 <= self.slow_learner < self.n_learners,
             f"slow_learner={self.slow_learner}")
        if self.algo == "adpsgd":
            need(self.topology == "random_pair",
                 "adpsgd gossips pairwise; use topology='random_pair'")
            need(self.gossip_order == "mix_then_descend",
                 "adpsgd only supports the paper Eq. 2 ordering")
            need(self.gossip_rounds == 1,
                 "adpsgd's async tick is one pairwise exchange")


def mix_einsum(stacked, m: torch.Tensor):
    """w_i <- sum_j M_ij w_j applied to every leaf, in float32."""
    def _mix(x):
        out = torch.einsum("ij,j...->i...", m.to(torch.float32),
                           x.to(torch.float32))
        return out.to(x.dtype)
    return tree_map(_mix, stacked)


pair_partners = topo.pair_partners     # re-export: the matching lives with
                                       # the other topology constructors


def mix_pair_gather(stacked, partner: torch.Tensor, remote=None):
    """w_i <- 0.5 (w_i + remote[partner_i]); solo learners keep w_i
    bitwise.  ``remote`` defaults to ``stacked`` (synchronous pairwise
    DPSGD); AD-PSGD passes the stale published buffer."""
    if remote is None:
        remote = stacked
    p = partner.long()

    def _mix(x, r):
        solo = p == torch.arange(x.shape[0], device=x.device)
        mask = solo.reshape((-1,) + (1,) * (x.dim() - 1))
        half = 0.5 * (x + r[p])
        return torch.where(mask, x, half).to(x.dtype)
    return tree_map(_mix, stacked, remote)


def straggler_active_mask(step: int, n: int, slow_learner: int,
                          slow_factor: int, device=None) -> torch.Tensor:
    """(n,) bool: which learners complete a local step this tick.  The
    injected straggler is active only when ``step % slow_factor == 0``;
    ``slow_learner < 0`` or ``slow_factor == 1`` makes everyone active.
    ``step`` is a host int, so the mask is built on ``device`` with no
    host-device copy."""
    if slow_learner < 0 or slow_factor == 1:
        return torch.ones((n,), dtype=torch.bool, device=device)
    idx = torch.arange(n, device=device)
    return (idx != slow_learner) | (step % slow_factor == 0)


def member_active_mask(step: int, active: torch.Tensor,
                       slow_every: torch.Tensor) -> torch.Tensor:
    """(n,) bool: which fleet members complete a local step this tick.

    The elastic generalization of ``straggler_active_mask``: every learner
    carries a ``slow_every`` tick divisor (1 = full speed, k = one
    completed step per k ticks, ``membership.HUNG`` = wedged) and a
    liveness bit.  Dead learners are never active; ``slow_every[i] ==
    slow_factor`` reproduces the injected straggler's law bitwise
    (``step % k == 0``).  ``step`` is a host int and ``active`` /
    ``slow_every`` device tensors, so the mask is built where they live
    with no host sync."""
    se = torch.clamp(slow_every.to(torch.int32), min=1)
    gate = (se <= 1) | (torch.remainder(step, se) == 0)
    return active.to(torch.bool) & gate


def perturb_weights(gen: torch.Generator, params, std: float):
    """SSGD*: w + delta, delta ~ N(0, std^2 I) drawn leaf by leaf from
    ``gen`` (the reference's law; its ``jax.random`` draws differ)."""
    return tree_add(params, tree_gaussian_like(gen, params, std))


def mean_broadcast(stacked):
    """Every learner's weights replaced by the global average (SSGD sync);
    each leaf is an expanded view of the mean."""
    mean = learner_mean(stacked)
    n = tree_leaves(stacked)[0].shape[0]
    return tree_map(lambda m: m[None].expand((n,) + tuple(m.shape)), mean)


# ---------------------------------------------------------------------------
# the collective half: one learner per rank (launch/train.py)
# ---------------------------------------------------------------------------

class Slot(NamedTuple):
    """One neighbour slot of a gossip round as one rank sees it."""
    k: int                  # the slot's index in the round's table
    src: int                # the rank whose row this rank mixes in; -1
    #                         for its own row (a self-loop with weight)
    dsts: Tuple[int, ...]   # the other ranks that read this rank's row
    coef: float             # this rank's weight on the slot

    @property
    def mixes(self) -> bool:
        """True when the slot adds a row to this rank's receive stack."""
        return self.src_is_remote or self.coef != 0.0

    @property
    def src_is_remote(self) -> bool:
        return self.src >= 0


def round_slots(partners, coefs, rank: int) -> List[Slot]:
    """This rank's live slots of one round of a compiled table
    (``partners`` (K, n), ``coefs`` (n, K + 1): host arrays).

    Slot k is live when this rank reads another rank (``partners[k, rank]
    != rank``), reads its own row with a nonzero weight (a self-loop of a
    torus at n = 2), or is read by another rank.  A self-loop at weight 0
    that no one reads — schedule padding, a solo learner of a matching, a
    dead slot of an elastic table — posts nothing, as the reference's
    ``_schedule_perms`` skips a padded slot.  A self-loop's ``src`` is -1:
    the rank mixes in its own row, received from no one."""
    p = np.array(partners, dtype=np.int64)
    c = np.array(coefs, dtype=np.float32)
    out = []
    for k in range(p.shape[0]):
        src = int(p[k, rank])
        coef = float(c[rank, 1 + k])
        dsts = tuple(int(j) for j in np.flatnonzero(p[k] == rank)
                     if j != rank)
        if src != rank or coef != 0.0 or dsts:
            out.append(Slot(k, src if src != rank else -1, dsts, coef))
    return out


class HostStaging:
    """Pinned host buffers that a ``gloo`` group stages CUDA tensors
    through (gloo reads and writes host memory), keyed by name and reused
    from call to call: the gossip exchange's send row and receive stack,
    the model group's collectives, the MoE all-to-all."""

    def __init__(self):
        self._bufs = {}

    @staticmethod
    def needed(group, device) -> bool:
        """Whether ``group``'s collectives on tensors on ``device`` are
        staged: a ``gloo`` group and a CUDA device."""
        import torch.distributed as dist
        return (dist.get_backend(group) == "gloo"
                and torch.device(device).type == "cuda")

    def buffer(self, key: str, shape, dtype) -> torch.Tensor:
        """Buffer ``key`` of ``shape``: kept while its trailing dims and
        dtype stay and its leading dim suffices (the front rows are then
        returned), else allocated anew."""
        shape = tuple(shape)
        buf = self._bufs.get(key)
        if buf is None or buf.dtype != dtype or buf.dim() != len(shape) \
                or tuple(buf.shape[1:]) != shape[1:] \
                or (shape and buf.shape[0] < shape[0]):
            buf = self._bufs[key] = torch.empty(shape, dtype=dtype,
                                                pin_memory=True)
        return buf[:shape[0]] if shape else buf

    def run(self, op, key: str, out: torch.Tensor, inp: torch.Tensor):
        """``op(host_out, host_in)``, with ``inp`` copied in and the result
        copied back into ``out`` (``out is inp``: one buffer).  The stream
        is synchronized before ``op``, because gloo reads host memory; the
        result goes back to the card asynchronously, ordered before any
        later copy into these buffers by the stream."""
        h_in = self.buffer(key + "/in", inp.shape, inp.dtype)
        h_out = h_in if out is inp else self.buffer(key + "/out", out.shape,
                                                    out.dtype)
        h_in.copy_(inp, non_blocking=True)
        torch.cuda.current_stream(inp.device).synchronize()  # lint: allow-host-sync
        op(h_out, h_in)
        out.copy_(h_out, non_blocking=True)


def _pieces(t: torch.Tensor, pieces):
    """``t`` (T, 128) as the element ranges a round posts one op each for:
    the whole buffer, or one range per leaf (``gossip_fuse="leaf"``)."""
    if pieces is None:
        return [t]
    flat = t.reshape(-1)
    return [flat[off:off + size] for off, size in pieces]


def exchange(send: torch.Tensor, slots: Sequence[Slot], recv: torch.Tensor,
             *, group=None, pieces=None,
             staging: Optional[HostStaging] = None) -> Tuple[int, int]:
    """Post one gossip round's point-to-point ops together and wait for
    them; returns the (sends, receives) posted.

    ``send``: (T, 128) this rank's row in the wire dtype, sent to every
    rank of each slot's ``dsts``.  ``recv``: (R, T, 128) of the same dtype,
    one row per mixing slot in slot order; a self-loop's row is a copy of
    ``send``.  ``pieces`` (element ranges ``(offset, size)``) posts one op
    per range per slot, the per-leaf exchange; default one op per slot.
    Every op of the round goes into one ``dist.batch_isend_irecv``, and
    tag ``k * len(pieces) + j`` names slot k's piece j on both ends, so a
    rank that reads one peer at two slots receives them in place.

    With an ``nccl`` group the tensors go on the wire as they are, and
    waiting on the ops orders the current stream after them, with no host
    sync.  With a ``gloo`` group and CUDA tensors the rows are staged
    through ``staging`` (the caller's pinned host buffers, reused from
    round to round): the stream is synchronized before the ops are posted,
    because gloo reads and writes host memory; the received rows go back
    to the card asynchronously.  An ``nccl`` group with CPU tensors, or a
    staged exchange with no ``staging``, raises ``ValueError``."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend == "nccl" and send.device.type != "cuda":
        raise ValueError("an nccl group exchanges CUDA tensors; use a gloo "
                         f"group for tensors on {send.device}")
    staged = HostStaging.needed(group, send.device)
    rows = [s for s in slots if s.mixes]
    wire_send, wire_recv = send, recv
    if staged and staging is None:
        raise ValueError("a gloo group exchanges CUDA tensors through "
                         "pinned host buffers: pass staging=HostStaging()")
    if staged:
        wire_send = staging.buffer("send", send.shape, send.dtype)
        wire_recv = staging.buffer("recv", (max(len(rows), 1),)
                                   + tuple(send.shape), send.dtype)
        wire_send.copy_(send, non_blocking=True)
        # gloo reads host memory: the copy (and the previous round's
        # copies back) must have landed before any op is posted
        torch.cuda.current_stream(send.device).synchronize()  # lint: allow-host-sync
    n_pieces = 1 if pieces is None else len(pieces)

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    ops, sends, recvs, row = [], 0, 0, 0
    for s in slots:
        for d in s.dsts:
            for j, part in enumerate(_pieces(wire_send, pieces)):
                ops.append(dist.P2POp(dist.isend, part, peer(d), group,
                                      tag=s.k * n_pieces + j))
                sends += 1
        if not s.mixes:
            continue
        if s.src_is_remote:
            for j, part in enumerate(_pieces(wire_recv[row], pieces)):
                ops.append(dist.P2POp(dist.irecv, part, peer(s.src), group,
                                      tag=s.k * n_pieces + j))
                recvs += 1
        else:
            recv[row].copy_(send)
        row += 1
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        for r, s in enumerate(x for x in slots if x.mixes):
            if s.src_is_remote:
                recv[r].copy_(wire_recv[r], non_blocking=True)
    return sends, recvs


def mix_round(w: torch.Tensor, stack: torch.Tensor, coefs) -> torch.Tensor:
    """One round's plain mixing in float32, in the fused kernel's term
    order: ``coefs[0] * w + coefs[1] * stack[0] + ...`` (``coefs`` a host
    sequence: the self weight, then one per stack row)."""
    out = float(coefs[0]) * w.to(torch.float32)
    for j in range(stack.shape[0]):
        out = out + float(coefs[1 + j]) * stack[j].to(torch.float32)
    return out


def hypercube_partner(rank: int, step: int, n: int) -> int:
    """AD-PSGD's pairwise schedule: ``rank ^ (1 << (step % log2 n))``, a
    matching at every step.  ``n`` must be a power of two (``ValueError``
    otherwise)."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"the hypercube pairing needs a power-of-two "
                         f"group of at least 2 ranks, got {n}")
    return rank ^ (1 << (step % (n.bit_length() - 1)))


def hypercube_tables(step: int, n: int, gate=None):
    """One round of the hypercube pairing at ``step`` as tables
    (``partners`` (1, n) int32, ``coefs`` (n, 2) float32): every pair
    averages 0.5 / 0.5.  ``gate`` ((n,) bool, the elastic fleet's live
    and not-dropped ranks): a pair mixes only when both ends gate on;
    otherwise each end is solo (its own row at weight 1)."""
    idx = np.arange(n)
    partner = np.array([hypercube_partner(i, step, n) for i in idx])
    if gate is not None:
        g = np.array(gate, dtype=bool)
        partner = np.where(g & g[partner], partner, idx)
    return pair_tables(partner)


def pair_tables(partner) -> Tuple[np.ndarray, np.ndarray]:
    """A matching's partner vector as one round's tables (``partners``
    (1, n) int32, ``coefs`` (n, 2) float32): a pair averages 0.5 / 0.5, a
    solo row keeps its own at weight 1."""
    partner = np.array(partner, dtype=np.int64)
    solo = partner == np.arange(partner.shape[0])
    coefs = np.stack([np.where(solo, 1.0, 0.5), np.where(solo, 0.0, 0.5)],
                     axis=1).astype(np.float32)
    return partner[None].astype(np.int32), coefs


def matrix_round(m) -> Tuple[np.ndarray, np.ndarray]:
    """An (n, n) mixing matrix as one round's tables: row i's nonzero
    off-diagonal entries in column order, padded with weight-0 self-loops
    to the widest row.  What the ``einsum`` backend realizes a step's
    matrix through: each rank gathers the rows its row of M reads."""
    m = np.array(m, dtype=np.float32)
    n = m.shape[0]
    cols = [[j for j in np.flatnonzero(m[i]) if j != i] for i in range(n)]
    K = max(1, max(len(c) for c in cols))
    partners = np.tile(np.arange(n, dtype=np.int32), (K, 1))
    coefs = np.zeros((n, K + 1), np.float32)
    for i, c in enumerate(cols):
        coefs[i, 0] = m[i, i]
        for k, j in enumerate(c):
            partners[k, i] = j
            coefs[i, 1 + k] = m[i, j]
    return partners, coefs
