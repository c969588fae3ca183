"""Production step builders on ``torch.distributed`` — the port of
``repro/launch/train.py`` (slice 7a), one learner per rank.

Training (the paper's setting):

  * DPSGD — rank i holds learner i's parameters as one flat (1, T, 128)
    float32 store; its gradient is local (no gradient collective, the
    paper's point), and the only cross-learner traffic is the gossip,
    point to point (``core/dpsgd.py``'s collective half):
       gossip_backend='einsum'   : the step's mixing matrix (the schedule's
                                   product of rounds, ``step_matrix``)
                                   realized as one round — each rank
                                   receives the rows its row of M reads
                                   and mixes them in one pass
       gossip_backend='ppermute' : round by round from the schedule's own
                                   tables, one send and one receive per
                                   live slot; a randomized schedule
                                   substitutes the ring, as the reference
                                   does
    The last round's mix and the optimizer update run as the fused gossip
    kernel (``ops.flat_gossip_update``) at n = 1, the received rows as its
    remote stack; the leading rounds of a multi-round step mix only
    (``ops.flat_gossip_mix``).  An optimizer with no fused recipe (or one
    that wants the mixed weights, DecentLaM) mixes in float32
    (``mix_round``), then updates and applies, unfused.
  * AD-PSGD — the hypercube pairing against a stale published buffer: a
    rank at the staleness bound sends its live weights and any other its
    buffer, so one buffer crosses the wire; the kernel's publish mode
    mixes, updates, keeps an inactive rank's rows and rewrites its own
    buffer.  ``elastic=True`` reads membership operands (host arrays, the
    same on every rank: each applies the same ``FaultPlan`` to its own
    ``Membership``): a pair whose ends are not both live, or whose round
    is dropped, posts no op, a dead rank's rows stay bitwise put, and the
    loss averages the live ranks.
  * SSGD — replicated weights: the local gradient lands in one flat
    buffer whose last row carries the loss, one ``all_reduce`` (SUM) of
    it, divided by n, then the optimizer's update.

State: ``LaunchState``, the twin of the reference's ``PjitTrainState``.
Its step and seed are host integers, and AD-PSGD's ages and clocks are
host arrays of the whole fleet that every rank advances alike (their law
is known on the host), so the step reads nothing back to branch on.  A
step consumes its state, as the reference donates it: the kernel writes
out of place, so a step keeps two stores (and two buffers) and
alternates.  Batches are the rank's own shard (B_local, ...).

On an ``nccl`` group the step is written to make no host sync: tables are
host arrays whose coefficient rows are cached on the device (copied once
from pinned memory), the kernel reads the lr scale from the optimizer
state, and the metrics are device tensors (the loss mean an
``all_reduce`` the host does not wait for).  Only world size 1 has run
on NCCL so far (SSGD and a solo DPSGD step, under
``torch.cuda.set_sync_debug_mode("error")``); the point-to-point
exchange on NCCL waits for a machine with several GPUs.  A ``gloo`` group
with CUDA tensors stages each exchange through pinned host memory, which
syncs: the transport the caller chose.  On the CPU (``device="cpu"``,
``gloo``) every kernel takes its plain version.

A step counts its traffic (``sends``, ``recvs``, ``bytes_received``,
``collectives``, ``last_rounds``) and, when ``timing`` is a dict, adds the
host-clock seconds of its ``compute``, ``exchange`` and ``kernel`` parts
there, synchronizing the card between them (instrumentation; off by
default).

Serving: ``make_prefill_step`` / ``make_decode_step`` wrap the model API.
``jit_train_step``, ``make_probe_step`` and the spec and sharding builders
are slice 7b.

# lint: hot-path
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import dpsgd as dp
from ..core import topology as topo
from ..core.flatstate import LANE, flat_meta
from ..core.schedule import _round_matrix, make_schedule
from ..core.trainer import (backward_into, bind_learner, cast_leaves,
                            fused_update)
from ..device import resolve_device
from ..kernels import ops as kops
from ..models.convert import tree_from_jax
from ..models.model import ModelAPI
from ..optim import Optimizer, apply_updates
from ..tree import tree_map
from .mesh import learner_rank, n_learners

__all__ = ["LaunchState", "membership_operands", "drawn_rounds",
           "make_dpsgd_train_step",
           "make_adpsgd_train_step", "make_ssgd_train_step",
           "rank_state_from_numpy", "make_prefill_step", "make_decode_step"]

_F32 = torch.float32


class LaunchState(NamedTuple):
    params: torch.Tensor       # (1, T, 128): this rank's store
    opt_state: Any             # the optimizer's state at n = 1
    step: int                  # a host integer
    seed: int                  # host matchings at step t come from (seed, t)
    # -- adpsgd only (None otherwise) --------------------------------------
    buffer: Any = None         # (1, T, 128) this rank's published weights
    age: Any = None            # (n,) int32 host: ticks since each published
    clock: Any = None          # (n,) int32 host: completed local steps
    # -- elastic membership operands (host; None for a static fleet) -------
    active: Any = None         # (n,) bool: live fleet members
    slow_every: Any = None     # (n,) int32: completes a step every k ticks
    drop_round: Any = None     # bool: this tick's gossip round is dropped


def membership_operands(membership, drop_round: bool = False) -> dict:
    """The launch half of ``MultiLearnerTrainer.set_membership``: the host
    operands of a ``core.membership.Membership``, swapped in between steps
    with ``state._replace(**...)``.  Every rank applies the same plan to
    its own ``Membership``, so every rank holds the same operands."""
    return dict(active=np.array(membership.active, dtype=bool),
                slow_every=np.array(membership.slow_every, dtype=np.int32),
                drop_round=bool(drop_round))


def drawn_rounds(seed: int, step: int, n: int, rounds: int = 1):
    """The matchings a randomized schedule's step draws on the host (a CPU
    ``torch.Generator`` seeded from (seed, step), round by round), as
    tables (partners (1, n) int32, coefs (n, 2) float32): every rank draws
    the same ones, so each knows its peer before it posts a receive, and
    ``MultiLearnerTrainer.train_step(rounds=...)`` replays them."""
    base = (seed * 1_000_003 + step) % (2 ** 63)
    return [dp.pair_tables(topo.pair_partners(
        torch.Generator().manual_seed(base + j), n).numpy())
        for j in range(rounds)]


class _RankStep:
    """What every step builder shares: this rank's two stores, its grad
    store and bindings, cached device rows, the receive stacks and the
    counters."""

    def __init__(self, api: ModelAPI, optimizer: Optimizer, group, device,
                 gossip_fuse: str = "flat"):
        import torch.distributed as dist

        if gossip_fuse not in ("flat", "leaf"):
            raise ValueError(f"gossip_fuse must be 'flat' or 'leaf', got "
                             f"{gossip_fuse!r}")
        if getattr(optimizer, "layout_sensitive", False):
            raise ValueError(
                "this optimizer's update depends on the per-leaf structure "
                "(layout_sensitive=True, e.g. lamb): the launch step keeps "
                "one flat store a rank; train it with MultiLearnerTrainer's "
                "pytree engine")
        self.device = resolve_device(device)
        self.api, self.optimizer, self.group = api, optimizer, group
        self.gossip_fuse = gossip_fuse
        self.n, self.rank = n_learners(group), learner_rank(group)
        self.backend = dist.get_backend(group)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an nccl group trains CUDA tensors, got "
                             f"device {self.device}; use a gloo group on "
                             "the CPU")
        self._staging = dp.HostStaging() if (
            self.backend == "gloo" and self.device.type == "cuda") else None
        self._meta = None
        self._rows, self._idx, self._recv, self._send = {}, {}, {}, {}
        self.sends = self.recvs = self.bytes_received = self.collectives = 0
        self.last_rounds = []      # [(sends, recvs)] of the last step
        self.timing: Optional[dict] = None

    # -- state --------------------------------------------------------------
    def init(self, params_tree, seed: int = 0) -> LaunchState:
        """This rank's state from its parameter tree (the reference's
        layout, e.g. ``api.param_tree(api.init(seed))``)."""
        dev = self.device
        meta = self._meta = flat_meta(params_tree)
        shape = (1, meta.rows, LANE)
        self._w = [torch.empty(shape, device=dev) for _ in range(2)]
        self._w[0].copy_(meta.flatten(params_tree, device=dev)[None])
        self._g = self._grad_store(shape)
        self._pieces = (None if self.gossip_fuse == "flat"
                        else list(zip(meta.offsets, meta.sizes)))
        casts = cast_leaves(meta, dev)
        g_leaves = [x[0] for x in meta.views(self._g)]
        self._bound = [bind_learner(meta, casts, self.api.params_from_tree,
                                    [x[0] for x in meta.views(w)], g_leaves)
                       for w in self._w]
        return LaunchState(self._w[0], self.optimizer.init(self._w[0]), 0,
                           seed, **self._extra_state())

    def _grad_store(self, shape):
        return torch.zeros(shape, device=self.device)

    def _extra_state(self) -> dict:
        return {}

    def _store(self, w) -> int:
        for i, s in enumerate(self._w):
            if w is s:
                return i
        raise ValueError(
            "the state's parameters are not this step's live store: train "
            "the state the step returned (a step consumes its state)")

    def _other(self, w):
        return self._w[1 - self._store(w)]

    def _grads(self, w, batch) -> torch.Tensor:
        b = self._bound[self._store(w)]
        self._g.zero_()
        return backward_into(self.api.loss_fn, b, batch)

    # -- cached device operands ---------------------------------------------
    def _row(self, values) -> torch.Tensor:
        """(1, len) float32 on the device, made once per distinct row (on
        a card through pinned memory, a copy the host does not wait for)."""
        key = tuple(float(v) for v in values)
        row = self._rows.get(key)
        if row is None:
            cuda = self.device.type == "cuda"
            host = torch.tensor([key], dtype=_F32, pin_memory=cuda)
            row = self._rows[key] = host.to(self.device, non_blocking=cuda)
        return row

    def _partner_ids(self, R: int) -> torch.Tensor:
        """(R, 1) int32 ``[[0], [1], ...]``: the kernel's partner table
        over a rank's receive stack."""
        ids = self._idx.get(R)
        if ids is None:
            ids = self._idx[R] = torch.arange(
                R, dtype=torch.int32, device=self.device)[:, None]
        return ids

    def _recv_stack(self, dtype, R: int) -> torch.Tensor:
        """The first R rows of this rank's receive stack in ``dtype``
        (zeroed when made, so a per-leaf exchange leaves the pad rows 0)."""
        buf = self._recv.get(dtype)
        if buf is None or buf.shape[0] < R:
            buf = self._recv[dtype] = torch.zeros(
                (R, self._meta.rows, LANE), dtype=dtype, device=self.device)
        return buf[:R]

    # -- instrumentation ----------------------------------------------------
    def _clock(self) -> float:
        if self.timing is None:
            return 0.0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # lint: allow-host-sync (timing on)
        return time.perf_counter()

    def _lap(self, part: str, t0: float) -> float:
        if self.timing is None:
            return t0
        t = self._clock()
        self.timing[part] = self.timing.get(part, 0.0) + t - t0
        return t

    # -- gossip -------------------------------------------------------------
    def _gather(self, send, partners, coefs, wire):
        """Exchange one round: ``send`` (1, T, 128) this rank's row, cast to
        ``wire`` on the way out.  Returns (the float32 receive stack or
        None when this rank mixes no slot, the host coefficients ``[self,
        one per stack row]``)."""
        slots = dp.round_slots(partners, coefs, self.rank)
        rows = [s for s in slots if s.mixes]
        values = [float(np.array(coefs, np.float32)[self.rank, 0])] + \
            [s.coef for s in rows]
        if not slots:
            self.last_rounds.append((0, 0))
            return None, values
        out = send[0]
        if wire != out.dtype:
            buf = self._send.get(wire)
            if buf is None:
                buf = self._send[wire] = torch.empty(out.shape, dtype=wire,
                                                     device=self.device)
            out = buf.copy_(out)
        recv = self._recv_stack(wire, len(rows))
        sends, recvs = dp.exchange(out, slots, recv, group=self.group,
                                   pieces=self._pieces,
                                   staging=self._staging)
        self.sends += sends
        self.recvs += recvs
        elems = out.numel() if self._pieces is None else self._meta.n_elem
        self.bytes_received += sum(s.src_is_remote for s in rows) \
            * elems * out.element_size()
        self.last_rounds.append((sends, recvs))
        if not rows:
            return None, values
        return (recv if wire == _F32 else recv.to(_F32)), values

    def _mean_loss(self, loss, live: bool = True, denom: float = None):
        """The group's mean loss: the live ranks' losses summed by one
        ``all_reduce`` (a dead rank adds 0, selected: a non-finite loss
        stays out), divided by ``denom`` (default n)."""
        import torch.distributed as dist

        buf = (loss if live else torch.zeros_like(loss)).reshape(1).to(_F32)
        dist.all_reduce(buf, group=self.group)
        self.collectives += 1
        return buf[0] / (self.n if denom is None else denom)


# ---------------------------------------------------------------------------
# DPSGD
# ---------------------------------------------------------------------------

class _DPSGDStep(_RankStep):
    def __init__(self, api, optimizer, group, topology, gossip_backend,
                 gossip_fuse, gossip_rounds, device):
        super().__init__(api, optimizer, group, device, gossip_fuse)
        if gossip_backend not in ("einsum", "ppermute"):
            raise ValueError(f"gossip_backend must be 'einsum' or "
                             f"'ppermute', got {gossip_backend!r}")
        self.gossip_backend = gossip_backend
        sched = self.schedule = make_schedule(topology, self.n,
                                              rounds=gossip_rounds)
        wants_mixed = getattr(optimizer, "wants_mixed", False)
        if (wants_mixed and getattr(optimizer, "static_mixing_only", False)
                and sched is not None and sched.time_varying):
            raise ValueError(
                "optimizer assumes a static mixing matrix but "
                f"topology='{topology}' compiles to a time-varying "
                "GossipSchedule (see optim/decentlam.py)")
        self._ring = (make_schedule("ring", self.n)
                      if sched is not None and sched.randomized
                      and gossip_backend == "ppermute" else None)
        self._fused = (optimizer.fused if optimizer.fused is not None
                       and not wants_mixed and sched is not None else None)

    def step_tables(self, step: int, seed: int, rounds=None):
        """The host tables (partners (K, n), coefs (n, K + 1)) of the
        rounds this step exchanges, in order.  ``rounds`` (injected
        per-round tables) replaces the schedule's draw; the ``einsum``
        backend then realizes their product."""
        s = self.schedule
        if s is None:
            return []
        if rounds is not None:
            rounds = [(np.array(p, dtype=np.int32),
                       np.array(c, dtype=np.float32)) for p, c in rounds]
        elif s.randomized and self.gossip_backend == "einsum":
            rounds = drawn_rounds(seed, step, self.n, s.rounds_per_step)
        if self.gossip_backend == "ppermute":
            if rounds is not None:
                return rounds
            s = self._ring if self._ring is not None else s
            return s.step_rounds(None, step)        # host (CPU) tables
        if rounds is None:
            return [dp.matrix_round(s.step_mats[step % s.step_mats.shape[0]])]
        m = np.eye(self.n)
        for p, c in rounds:
            m = _round_matrix(p, c) @ m
        return [dp.matrix_round(m)]

    def __call__(self, state: LaunchState, batch, rounds=None):
        self.last_rounds = []
        w = state.params
        t = self._clock()
        loss = self._grads(w, batch)
        t = self._lap("compute", t)
        tables = self.step_tables(state.step, state.seed, rounds)
        wire = self._meta.wire_dtype()
        g, opt_state = self._g, state.opt_state
        if not tables:                                  # solo: no gossip
            updates, opt_state = self._update(g, opt_state, w, w)
            new = self._other(w).copy_(apply_updates(w, updates))
            t = self._lap("kernel", t)
        elif self._fused is not None:
            f, wd = self._fused, None
            if len(tables) > 1 and f.weight_decay:
                # decay the PRE-mix local weights, as the reference does
                g, wd = g + f.weight_decay * w, 0.0
            cur = w
            for j, (partners, coefs) in enumerate(tables):
                stack, values = self._gather(cur, partners, coefs,
                                             wire if j == 0 else _F32)
                t = self._lap("exchange", t)
                R = 1 if stack is None else stack.shape[0]
                remote = cur if stack is None else stack
                row = self._row(values if stack is not None
                                else values + [0.0])
                out = self._other(cur)
                if j < len(tables) - 1:
                    cur = kops.flat_gossip_mix(
                        cur, self._partner_ids(R), row, remote=remote,
                        out=out)
                else:
                    new, opt_state = fused_update(
                        f, cur, remote, g, opt_state, self._partner_ids(R),
                        row, out=out, weight_decay=wd)
                t = self._lap("kernel", t)
        else:
            mixed = w
            for j, (partners, coefs) in enumerate(tables):
                stack, values = self._gather(mixed, partners, coefs,
                                             wire if j == 0 else _F32)
                t = self._lap("exchange", t)
                mixed = (values[0] * mixed.to(_F32) if stack is None
                         else dp.mix_round(mixed, stack, values))
            updates, opt_state = self._update(g, opt_state, w, mixed)
            new = self._other(w).copy_(apply_updates(mixed, updates))
            t = self._lap("kernel", t)
        metrics = {"loss": self._mean_loss(loss)}
        self._lap("exchange", t)
        return state._replace(params=new, opt_state=opt_state,
                              step=state.step + 1), metrics

    def _update(self, g, opt_state, w, mixed):
        if getattr(self.optimizer, "wants_mixed", False):
            return self.optimizer.update(g, opt_state, w, mixed)
        return self.optimizer.update(g, opt_state, w)


def make_dpsgd_train_step(api: ModelAPI, optimizer: Optimizer, group=None,
                          topology: str = "random_pair",
                          gossip_backend: str = "einsum",
                          gossip_fuse: str = "flat", gossip_rounds: int = 1,
                          device=None) -> Callable:
    """This rank's DPSGD step: ``step(state, batch, rounds=None) ->
    (state, {"loss"})``, with ``step.init(params_tree, seed)`` for the
    first state.

    ``topology`` compiles through ``core.schedule.make_schedule``, so the
    launch path runs the tables the trainer runs.  ``gossip_backend``:
    ``"einsum"`` realizes ``schedule.step_matrix`` for every topology,
    ``random_pair`` included (its matching drawn on the host from (seed,
    step), the same on every rank); ``"ppermute"`` exchanges round by
    round from the compiled tables, and a randomized schedule substitutes
    the ring.  ``gossip_fuse``: ``"flat"`` posts one op per slot, ``"leaf"``
    one per parameter leaf per slot.  ``rounds`` (per-round ``(partners (K,
    n), coefs (n, K + 1))`` host tables) replaces the draw, as
    ``MultiLearnerTrainer.train_step(rounds=...)`` does.  An optimizer
    that assumes a static mixing matrix raises ``ValueError`` on a
    time-varying schedule (the reference's check)."""
    return _DPSGDStep(api, optimizer, group, topology, gossip_backend,
                      gossip_fuse, gossip_rounds, device)


# ---------------------------------------------------------------------------
# AD-PSGD
# ---------------------------------------------------------------------------

class _ADPSGDStep(_RankStep):
    def __init__(self, api, optimizer, group, max_staleness, slow_learner,
                 slow_factor, gossip_fuse, elastic, device):
        super().__init__(api, optimizer, group, device, gossip_fuse)
        dp.hypercube_partner(0, 0, self.n)      # a power-of-two group
        wants_mixed = getattr(optimizer, "wants_mixed", False)
        if wants_mixed and getattr(optimizer, "static_mixing_only", False):
            raise ValueError("optimizer assumes a static mixing matrix but "
                             "AD-PSGD gossips over a time-varying pairwise "
                             "schedule (see optim/decentlam.py)")
        if elastic and wants_mixed:
            raise ValueError("a mixing-matrix-corrected optimizer (decentlam)"
                             " assumes a static fleet (see core/trainer.py)")
        if max_staleness < 0 or slow_factor < 1 \
                or not -1 <= slow_learner < self.n:
            raise ValueError(
                f"max_staleness={max_staleness}, slow_learner="
                f"{slow_learner}, slow_factor={slow_factor}")
        self.max_staleness, self.elastic = max_staleness, elastic
        self.slow_learner, self.slow_factor = slow_learner, slow_factor
        self._fused = optimizer.fused if not wants_mixed else None

    def _extra_state(self) -> dict:
        self._buf = [self._w[0].clone(), torch.empty_like(self._w[0])]
        zeros = np.zeros((self.n,), np.int32)
        extra = dict(buffer=self._buf[0], age=zeros, clock=zeros.copy())
        if self.elastic:
            extra.update(active=np.ones((self.n,), bool),
                         slow_every=np.ones((self.n,), np.int32),
                         drop_round=False)
        return extra

    def masks(self, state: LaunchState):
        """The fleet's host (active, fresh, live, gate) this tick: who
        completes a local step, who is at the staleness bound, who is
        live, and who gossips (live and the round not dropped)."""
        n, step = self.n, state.step
        if self.elastic:
            live = np.array(state.active, dtype=bool)
            se = np.maximum(np.array(state.slow_every, np.int64), 1)
            active = live & ((se <= 1) | (step % se == 0))
            fresh = (state.age >= self.max_staleness) & live
            gate = live & (not state.drop_round)
        else:
            live = np.ones((n,), bool)
            active = np.ones((n,), bool)
            if self.slow_learner >= 0 and self.slow_factor > 1:
                active[self.slow_learner] = step % self.slow_factor == 0
            fresh = state.age >= self.max_staleness
            gate = live
        return active, fresh, live, gate

    def __call__(self, state: LaunchState, batch):
        self.last_rounds = []
        r = self.rank
        w, buffer = state.params, state.buffer
        active, fresh, live, gate = self.masks(state)
        t = self._clock()
        loss = self._grads(w, batch)
        t = self._lap("compute", t)
        partners, coefs = dp.hypercube_tables(state.step, self.n, gate)
        # the sender chooses what its partner mixes: live weights at the
        # staleness bound, its published buffer otherwise
        send = w if fresh[r] else buffer
        stack, values = self._gather(send, partners, coefs,
                                     self._meta.wire_dtype())
        t = self._lap("exchange", t)
        w_next = self._other(w)
        buf_next = self._buf[1] if buffer is self._buf[0] else self._buf[0]
        publish = bool(active[r] or fresh[r])
        if self._fused is not None:
            remote = w if stack is None else stack
            row = self._row(values if stack is not None else values + [0.0])
            one = self._row([1.0])[0]
            new, opt_state, buffer = fused_update(
                self._fused, w, remote, self._g, state.opt_state,
                self._partner_ids(remote.shape[0]), row, out=w_next,
                active=self._row([float(active[r])])[0], buffer=buffer,
                buffer_out=buf_next, nbr_fresh=one,
                publish=self._row([float(publish)])[0])
            if not active[r]:       # the small leaves: step counters
                opt_state = _keep_small(opt_state, state.opt_state)
        else:
            mixed = (values[0] * w.to(_F32) if stack is None
                     else dp.mix_round(w, stack, values))
            if getattr(self.optimizer, "wants_mixed", False):
                updates, opt_new = self.optimizer.update(
                    self._g, state.opt_state, w, mixed)
            else:
                updates, opt_new = self.optimizer.update(
                    self._g, state.opt_state, w)
            if active[r]:
                new = w_next.copy_(apply_updates(mixed, updates))
                opt_state = opt_new
            else:
                new, opt_state = w_next.copy_(w), state.opt_state
            buffer = buf_next.copy_(new if publish else buffer)
        t = self._lap("kernel", t)
        age = np.where(active | fresh, 0, state.age + 1).astype(np.int32)
        clock = (state.clock + active).astype(np.int32)
        stale = np.where(fresh | ~live, 0, state.age)
        if self.elastic:
            nact = max(int(live.sum()), 1)
            metrics = {"loss": self._mean_loss(loss, bool(live[r]), nact),
                       "n_active": self._full(nact)}
        else:
            metrics = {"loss": self._mean_loss(loss)}
        metrics["staleness_max"] = self._full(int(stale.max()))
        self._lap("exchange", t)
        return state._replace(params=new, opt_state=opt_state,
                              step=state.step + 1, buffer=buffer, age=age,
                              clock=clock), metrics

    def _full(self, v) -> torch.Tensor:
        """A host number as a 0-dim device tensor (a fill, no copy)."""
        return torch.full((), float(v), dtype=_F32, device=self.device)


def _keep_small(new, old):
    """An inactive rank's optimizer state: the (1, T, 128) momentum the
    kernel kept in place, the previous values of the small leaves (step
    counters, scales)."""
    def pick(a, b):
        if isinstance(a, torch.Tensor) and a.dim() == 3:
            return a
        return b
    return tree_map(pick, new, old)


def make_adpsgd_train_step(api: ModelAPI, optimizer: Optimizer, group=None,
                           *, max_staleness: int = 4, slow_learner: int = -1,
                           slow_factor: int = 1, gossip_fuse: str = "flat",
                           elastic: bool = False, device=None) -> Callable:
    """This rank's asynchronous-gossip tick: ``step(state, batch) ->
    (state, metrics)`` (``loss``, ``staleness_max``; elastic adds
    ``n_active``).

    Each rank mixes its live weights with ONE hypercube partner's chosen
    row (its live weights when it is at the staleness bound, else its
    last-published buffer), which may lag by up to ``max_staleness``
    ticks; the injected straggler ``slow_learner`` completes (and
    publishes) only every ``slow_factor`` ticks.  ``elastic=True`` reads
    the state's membership operands (``membership_operands``) instead of
    the static straggler.  The group's size must be a power of two
    (``ValueError``)."""
    return _ADPSGDStep(api, optimizer, group, max_staleness, slow_learner,
                       slow_factor, gossip_fuse, elastic, device)


# ---------------------------------------------------------------------------
# SSGD baseline
# ---------------------------------------------------------------------------

class _SSGDStep(_RankStep):
    def _grad_store(self, shape):
        # one extra row carries the loss through the gradient's all_reduce
        self._g_ext = torch.zeros((shape[1] + 1, LANE), device=self.device)
        return self._g_ext[:shape[1]].view(shape)

    def __call__(self, state: LaunchState, batch):
        import torch.distributed as dist

        self.last_rounds = []
        w = state.params
        t = self._clock()
        loss = self._grads(w, batch)
        self._g_ext[-1, 0] = loss
        t = self._lap("compute", t)
        dist.all_reduce(self._g_ext, group=self.group)
        self.collectives += 1
        self._g_ext.div_(self.n)
        t = self._lap("exchange", t)
        updates, opt_state = self.optimizer.update(self._g, state.opt_state,
                                                   w)
        new = self._other(w).copy_(apply_updates(w, updates))
        self._lap("kernel", t)
        return state._replace(params=new, opt_state=opt_state,
                              step=state.step + 1), {
            "loss": self._g_ext[-1, 0].clone()}


def make_ssgd_train_step(api: ModelAPI, optimizer: Optimizer, group=None,
                         device=None) -> Callable:
    """This rank's SSGD step on replicated weights: ``step(state, batch)
    -> (state, {"loss"})``.  The mean of the ranks' gradients over equal
    shards equals the reference's gradient of the global batch's mean
    loss up to the order of a sum."""
    return _SSGDStep(api, optimizer, group, device)


# ---------------------------------------------------------------------------
# the reference's weights carried across
# ---------------------------------------------------------------------------

def rank_state_from_numpy(step, params, *, momentum=None, buffer=None,
                          age=None, seed: int = 0) -> LaunchState:
    """This rank's launch state from the reference's STACKED state as numpy
    arrays (leaves (n, ...), e.g. ``np.asarray`` of a ``PjitTrainState``'s
    leaves): row ``rank`` of ``params`` (and of ``momentum`` and, for
    AD-PSGD, ``buffer``), through ``models/convert.py``; ``age`` is the
    fleet's (n,) ages.  ``momentum`` needs a fused recipe (its momentum
    slot)."""
    r, dev = step.rank, step.device

    def row(tree):
        return tree_from_jax(tree_map(lambda a: a[r], tree), device=dev)

    state = step.init(row(params), seed)
    meta = step._meta
    if momentum is not None:
        f = step.optimizer.fused
        if f is None or f.read_mu(state.opt_state) is None:
            raise ValueError("momentum given for an optimizer with no "
                             "fused momentum slot")
        f.read_mu(state.opt_state).copy_(
            meta.flatten(row(momentum), device=dev)[None])
    if buffer is not None:
        state.buffer.copy_(meta.flatten(row(buffer), device=dev)[None])
    if age is not None:
        state = state._replace(age=np.array(age, dtype=np.int32))
    return state


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_prefill_step(api: ModelAPI) -> Callable:
    def prefill(params, batch):
        return api.apply(params, batch)
    return prefill


def make_decode_step(api: ModelAPI) -> Callable:
    def decode(params, cache, tokens, pos):
        return api.decode_step(params, cache, tokens, pos)
    return decode
