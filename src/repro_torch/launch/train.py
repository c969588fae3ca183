"""Production step builders on ``torch.distributed`` — the port of
``repro/launch/train.py``: one learner per rank (slice 7a), or a learner
spanning the ranks of a mesh's model axis (slice 7b).

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

The model axis (``mesh=``, a ``DeviceMesh`` whose last axis is
``"model"``; ``launch/mesh.py``): rank (i, j) holds model shard j of
learner i, every leaf cut as the reference's ``leaf_spec`` places it
(``launch/shardstore.py``), the shard one flat (1, T_local, 128) store,
and so are its momentum, buffer and receive stack.  The compute is split
over the learner's M model ranks by batch rows (FSDP style): the step
takes the learner's local batch (B rows, the same on its M ranks; B % M
!= 0 raises ``ValueError``) and runs rows [j B/M, (j+1) B/M); one
``all_gather`` of the shard stores over the model group assembles the
full weights, the backward runs on them, one ``reduce_scatter`` (SUM)
returns the rank's gradient shard, and one ``all_reduce`` sums the
replicated leaves' gradients with the token count and the loss, so the
gradient is that of the learner's mean loss over its whole batch.  The
gossip runs over the learner group at the rank's model coordinate
(``mesh.learner_group``): rank (i, j) exchanges shard j with rank
(partner(i), j), and kernel #2 updates the shard.  SSGD all-reduces the
gradient shard over the learner group.  A mesh of model size 1 is slice
7a's step exactly.

State: ``LaunchState``, the twin of the reference's ``PjitTrainState``.
Its step and seed are host integers, and AD-PSGD's ages and clocks are
host arrays of the whole fleet that every rank advances alike (their law
is known on the host), so the step reads nothing back to branch on.  A
step consumes its state, as the reference donates it: the kernel writes
out of place, so a step keeps two stores (and two buffers) and
alternates; ``jit_train_step`` wraps a step so that a consumed state
raises when it is used again.  Batches are the rank's own shard
(B_local, ...), or with a model axis the learner's.

On an ``nccl`` group the step is written to make no host sync: tables are
host arrays whose coefficient rows are cached on the device (copied once
from pinned memory), the kernel reads the lr scale from the optimizer
state, and the metrics are device tensors (the loss mean an
``all_reduce`` the host does not wait for).  Only world size 1 has run
on NCCL so far (SSGD and a solo DPSGD step, under
``torch.cuda.set_sync_debug_mode("error")``); the point-to-point
exchange on NCCL waits for a machine with several GPUs.  A ``gloo`` group
with CUDA tensors stages every collective (each exchange, the model
group's, the learner group's all_reduces) through pinned host memory
(``core/dpsgd.HostStaging``), which syncs: the transport the caller
chose.
On the CPU (``device="cpu"``, ``gloo``) every kernel takes its plain
version.

A step counts its traffic (``sends``, ``recvs``, ``bytes_received``,
``collectives`` on the learner group; ``model_collectives`` and
``model_bytes`` on the model group; ``last_rounds``) and, when ``timing``
is a dict, adds the host-clock seconds of its ``compute``, ``model``
(the gather, reduce-scatter and all-reduce), ``exchange`` and ``kernel``
parts there, synchronizing the card between them (instrumentation; off
by default).

The per-period gather (``gather="period"`` on the mesh steps): the step
holds no full copy of the learner.  Its non-period leaves (embedding,
final norm, head) are gathered once a step; each period's leaves are
gathered as the forward reaches the period (``convert.PeriodParams``'s
hook), the period runs under non-reentrant ``torch.utils.checkpoint``
with its gather inside, so the backward gathers it again, recomputes it
and reduces its gradient into the rank's gradient shard
(``_GatherPeriod``, ``shardstore.LearnerGather``: an ``all_gather`` and,
for leaves cut on the period dim, a ``broadcast`` from their owner; a
``reduce_scatter`` and a ``reduce``).  The replicated leaves, the token
count and the loss keep their one ``all_reduce``, and kernel #2 gossips
the shard store as before; the result is the ``"whole"`` step's (bitwise
over two model ranks, to rounding over more: ``shardstore``).  Every
rank issues the same collectives in the same order (the recompute
repeats the forward's, the MoE all-to-all included); the recompute reads
the live weights, never AD-PSGD's published buffer.  ``max_full_bytes``
is the largest full buffer a step holds.

The probe: ``make_probe_step(api, mesh, alpha=, stacked=)`` measures the
landscape at the learners' mean over their superbatch with every vector
sharded as the weights are, the Lanczos basis an (m + 1, T_local, 128)
shard per rank through the reorth kernels.  Its HVPs gather the
learner's whole weights (``gather="whole"``, reverse over reverse) or a
section at a time (``gather="period"``: forward over reverse, a period
at a time, ``launch/periodsweep.py``).  The spec builders
(``stacked_param_specs``, ``train_state_specs``,
``train_state_shardings``) work on the meta device: nothing allocated.

Serving: ``make_prefill_step`` / ``make_decode_step`` wrap the model API,
and with ``mesh=`` serve from a rank's shard store: the prefill runs the
rank's rows of its learner's batch (``gather_rows`` assembles the
learner's), the decode is sequence-sharded (each rank a slice of every
attention buffer's time dim, one all_gather of softmax partials a layer;
the encoder-decoder's cross K/V cut on the encoder length too, a second
all_gather a decoder layer; ``make_decode_step``).

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
from ..models.attention import merge_partials
from ..models.convert import PeriodParams, period_layers, tree_from_jax
from ..models.model import ModelAPI
from ..models.shard_hints import use_mesh
from ..optim import Optimizer, apply_updates
from ..tree import tree_map, tree_unflatten
from .mesh import (learner_axes, learner_group, learner_rank, mesh_shape,
                   model_group, model_rank, model_size, n_learners)
from .shardstore import GroupComm, LearnerGather, ShardLayout

__all__ = ["LaunchState", "membership_operands", "drawn_rounds",
           "make_dpsgd_train_step",
           "make_adpsgd_train_step", "make_ssgd_train_step",
           "rank_state_from_numpy", "gather_learner", "jit_train_step",
           "make_probe_step", "param_shapes", "stacked_param_specs",
           "train_state_specs", "train_state_shardings",
           "make_prefill_step", "make_decode_step", "gather_rows"]

_F32 = torch.float32
_GATHERS = ("whole", "period")


def _check_gather(gather: str) -> str:
    if gather not in _GATHERS:
        raise ValueError(f"gather must be one of {_GATHERS}, got "
                         f"{gather!r}")
    return gather


class LaunchState(NamedTuple):
    params: torch.Tensor       # (1, T, 128): this rank's store (its shard)
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


def _split_mesh(group, mesh):
    """The learner group a step gossips over: ``group``, or the mesh's
    group at this rank's model coordinate."""
    if mesh is None:
        return group
    if group is not None:
        raise ValueError("pass a learner group or a mesh, not both")
    return learner_group(mesh)


def _token_count(batch) -> torch.Tensor:
    """The tokens a batch's loss averages over: its mask's sum (the
    models' masked mean), or its rows."""
    if isinstance(batch, dict) and "mask" in batch:
        return torch.sum(batch["mask"].to(_F32))
    rows = next(iter(batch.values())) if isinstance(batch, dict) else batch
    return torch.full((), float(rows.shape[0]), dtype=_F32,
                      device=rows.device)


def _model_rows(batch, M: int, j: int):
    """Model rank j's rows of a learner's batch (B % M != 0 raises)."""
    def rows(x):
        B = x.shape[0]
        if B % M:
            raise ValueError(f"the learner's batch of {B} rows does not "
                             f"split over {M} model ranks")
        b = B // M
        return x[j * b:(j + 1) * b]
    return tree_map(rows, batch)


class _RankStep:
    """What every step builder shares: this rank's two stores, its grad
    store and bindings, cached device rows, the receive stacks and the
    counters; with a model axis, the shard layout, the learner's full
    store and gradient, and the model group's collectives."""

    def __init__(self, api: ModelAPI, optimizer: Optimizer, group, device,
                 gossip_fuse: str = "flat", mesh=None, gather: str = "whole"):
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
        group, self.mesh = _split_mesh(group, mesh), mesh
        self.api, self.optimizer, self.group = api, optimizer, group
        self.gossip_fuse = gossip_fuse
        self.n, self.rank = n_learners(group), learner_rank(group)
        self.M = 1 if self.mesh is None else model_size(self.mesh)
        self.j = 0 if self.mesh is None else model_rank(self.mesh)
        self._comm = (GroupComm(model_group(self.mesh), self.device)
                      if self.M > 1 else None)
        # one model rank holds the whole learner: nothing to gather
        self.gather = _check_gather(gather) if self.M > 1 else "whole"
        self._layout = self._gatherer = None
        self.backend = dist.get_backend(group)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an nccl group trains CUDA tensors, got "
                             f"device {self.device}; use a gloo group on "
                             "the CPU")
        self._staging = (dp.HostStaging()
                         if dp.HostStaging.needed(group, self.device)
                         else None)
        # the learner group's all_reduces (the loss, SSGD's gradient)
        self._learners = GroupComm(group, self.device)
        self._meta = None
        self._rows, self._idx, self._recv, self._send = {}, {}, {}, {}
        self.sends = self.recvs = self.bytes_received = self.collectives = 0
        self.last_rounds = []      # [(sends, recvs)] of the last step
        self.timing: Optional[dict] = None

    # -- counters of the model group ---------------------------------------
    @property
    def model_collectives(self) -> int:
        return 0 if self._comm is None else self._comm.calls

    @property
    def model_bytes(self) -> int:
        return 0 if self._comm is None else self._comm.bytes

    @property
    def model_kinds(self) -> dict:
        """The model group's calls by collective."""
        return {} if self._comm is None else dict(self._comm.kinds)

    @property
    def max_full_bytes(self) -> int:
        """The largest full (unsharded) weight buffer the step holds: the
        learner's whole float32 store (``gather="whole"``), or the larger
        of one period's and the non-period leaves' (``"period"``); 0
        without a model axis."""
        if self.M == 1 or self._layout is None:
            return 0
        if self._gatherer is not None:
            return self._gatherer.max_full_bytes
        return self._layout.full.rows * LANE * 4

    # -- state --------------------------------------------------------------
    def init(self, params_tree, seed: int = 0) -> LaunchState:
        """This rank's state from its learner's parameter tree (the
        reference's layout, e.g. ``api.param_tree(api.init(seed))``); with
        a model axis the rank keeps its shard of it."""
        dev = self.device
        if self.M > 1:
            lay = self._layout = ShardLayout(params_tree, self.M, self.j)
            meta = self._meta = lay.local
        else:
            meta = self._meta = flat_meta(params_tree)
        shape = (1, meta.rows, LANE)
        self._w = [torch.empty(shape, device=dev) for _ in range(2)]
        self._w[0].copy_(self.local_store(params_tree))
        self._g = self._grad_store(shape)
        self._pieces = (None if self.gossip_fuse == "flat"
                        else list(zip(meta.offsets, meta.sizes)))
        if self.M > 1 and self.gather == "period":
            self._init_period(lay)
        elif self.M > 1:
            full = lay.full
            self._w_full = torch.zeros((full.rows, LANE), device=dev)
            self._g_full = torch.zeros((full.rows, LANE), device=dev)
            self._stack = torch.zeros((self.M, meta.rows, LANE), device=dev)
            self._rep = torch.zeros((lay.n_rep + 2,), device=dev)
            self._bound_full = bind_learner(
                full, cast_leaves(full, dev), self.api.params_from_tree,
                full.views(self._w_full), full.views(self._g_full))
        else:
            casts = cast_leaves(meta, dev)
            g_leaves = [x[0] for x in meta.views(self._g)]
            self._bound = [bind_learner(meta, casts,
                                        self.api.params_from_tree,
                                        [x[0] for x in meta.views(w)],
                                        g_leaves)
                           for w in self._w]
        return LaunchState(self._w[0], self.optimizer.init(self._w[0]), 0,
                           seed, **self._extra_state())

    def _init_period(self, lay: ShardLayout) -> None:
        """``gather="period"``: the non-period leaves' full store and
        gradient (bound once, gathered once a step) and the hook that
        gathers a period as the forward reaches it."""
        if not lay.n_periods:
            raise ValueError("gather='period' needs a model with stacked "
                             "periods (a transformer's tree)")
        dev, rest = self.device, lay.rest.meta
        self._gatherer = LearnerGather(lay, self._comm, dev)
        self._anchor = torch.zeros((), device=dev, requires_grad=True)
        self._w_rest = torch.zeros((rest.rows, LANE), device=dev)
        self._g_rest = torch.zeros((rest.rows, LANE), device=dev)
        self._rep = torch.zeros((lay.n_rep + 2,), device=dev)
        self._bound_full = bind_learner(
            rest, cast_leaves(rest, dev),
            lambda tree: PeriodParams(tree, lay.n_periods,
                                      self._period_layers),
            rest.views(self._w_rest), rest.views(self._g_rest))
        self._src = None

    def _period_leaves(self, p: int):
        """Period p's full leaves gathered from the live store, each in
        its own dtype."""
        sec = self._layout.period.meta
        return [v if v.dtype == dt else v.to(dt) for v, dt in zip(
            self._gatherer.gather(self._src, p), sec.dtypes)]

    def _period_layers(self, p: int):
        """``PeriodParams``' hook: period p's layers, through
        ``_GatherPeriod`` when gradients are on (its backward returns the
        period's gradient to the shard)."""
        if torch.is_grad_enabled():
            leaves = _GatherPeriod.apply(self._anchor, self, p)
        else:
            leaves = self._period_leaves(p)
        return period_layers(tree_unflatten(
            self._layout.period.meta.treedef, list(leaves)))

    def local_store(self, tree) -> torch.Tensor:
        """A learner's full tree as this rank's (1, T_local, 128) float32
        store: its shard (the whole tree without a model axis)."""
        if self._layout is not None:
            return self._layout.flatten_local(tree, device=self.device)[None]
        return self._meta.flatten(tree, device=self.device)[None]

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

    def _grads(self, w, batch, t: float):
        """This rank's gradient into ``self._g``; returns (the learner's
        loss, the clock after the parts it timed from ``t``).  With a
        model axis: gather the shards, run this rank's rows on the full
        weights, reduce-scatter the gradient, all-reduce the replicated
        leaves' gradient with the token count and the loss."""
        if self.M == 1:
            b = self._bound[self._store(w)]
            self._g.zero_()
            loss = backward_into(self.api.loss_fn, b, batch)
            return loss, self._lap("compute", t)
        self._store(w)
        rows = _model_rows(batch, self.M, self.j)
        lay, comm = self._layout, self._comm
        if self._gatherer is not None:
            return self._grads_period(w, rows, t)
        comm.all_gather(w[0], self._stack)
        lay.assemble(self._stack, self._w_full)
        t = self._lap("model", t)
        count = _token_count(rows)
        self._g_full.zero_()
        with use_mesh(self.mesh):
            # the sum of this rank's token losses: the learner's mean is
            # this over the learner's token count, summed below
            loss = backward_into(
                lambda p, b: self.api.loss_fn(p, b) * count,
                self._bound_full, rows)
        t = self._lap("compute", t)
        lay.pack(self._g_full, self._stack)
        comm.reduce_scatter(self._stack, self._g[0])
        rep = self._rep
        lay.pack_rep(self._g_full, rep)
        rep[-2] = count
        rep[-1] = loss
        comm.all_reduce(rep)
        lay.rep_tail(self._g).copy_(rep[:lay.n_rep])
        total = torch.clamp(rep[-2], min=1.0)
        self._g.div_(total)
        return rep[-1] / total, self._lap("model", t)

    def _grads_period(self, w, rows, t: float):
        """``_grads`` with ``gather="period"``: the non-period leaves
        gathered once, each period gathered (twice: the forward, then the
        recompute) and reduced as the forward and backward reach it; the
        replicated tail, the token count and the loss in one all_reduce.
        The per-period collectives run inside the forward and backward,
        so ``timing`` counts them under ``compute``."""
        lay, gat, comm = self._layout, self._gatherer, self._comm
        self._src = w[0]
        gat.gather(w[0], None, out=lay.rest.meta.views(self._w_rest))
        t = self._lap("model", t)
        count = _token_count(rows)
        self._g.zero_()
        self._g_rest.zero_()
        with use_mesh(self.mesh):
            loss = backward_into(
                lambda p, b: self.api.loss_fn(p, b) * count,
                self._bound_full, rows)
        self._src = None
        t = self._lap("compute", t)
        rep = self._rep
        gat.reduce(None, lay.rest.meta.views(self._g_rest), self._g[0], rep)
        rep[-2] = count
        rep[-1] = loss
        comm.all_reduce(rep)
        lay.rep_tail(self._g).copy_(rep[:lay.n_rep])
        total = torch.clamp(rep[-2], min=1.0)
        self._g.div_(total)
        return rep[-1] / total, self._lap("model", t)

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
        buf = (loss if live else torch.zeros_like(loss)).reshape(1).to(_F32)
        self._learners.all_reduce(buf)
        self.collectives += 1
        return buf[0] / (self.n if denom is None else denom)


class _GatherPeriod(torch.autograd.Function):
    """Period p of a step's learner: the forward gathers its full leaves
    over the model group (``LearnerGather.gather``), the backward reduces
    their gradient into this rank's gradient shard
    (``LearnerGather.reduce``) and returns none.  ``anchor`` (a 0-dim
    leaf that requires grad) makes the leaves differentiable."""

    @staticmethod
    def forward(ctx, anchor, step, p):
        ctx.step, ctx.p = step, p
        return tuple(step._period_leaves(p))

    @staticmethod
    def backward(ctx, *grads):
        step = ctx.step
        step._gatherer.reduce(ctx.p, [g.float() for g in grads],
                              step._g[0], step._rep)
        return None, None, None


# ---------------------------------------------------------------------------
# DPSGD
# ---------------------------------------------------------------------------

class _DPSGDStep(_RankStep):
    def __init__(self, api, optimizer, group, topology, gossip_backend,
                 gossip_fuse, gossip_rounds, device, mesh, gather):
        super().__init__(api, optimizer, group, device, gossip_fuse, mesh,
                         gather)
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
        loss, t = self._grads(w, batch, self._clock())
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
                          device=None, mesh=None,
                          gather: str = "whole") -> Callable:
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
    time-varying schedule (the reference's check).

    ``mesh`` (a ``DeviceMesh`` ending in ``"model"``): the learner spans
    its model group, the step takes the learner's batch and gossips shard
    by shard over the learner group (module docstring).  ``gather``:
    ``"whole"`` assembles the learner's full store once a step,
    ``"period"`` one period at a time (module docstring)."""
    return _DPSGDStep(api, optimizer, group, topology, gossip_backend,
                      gossip_fuse, gossip_rounds, device, mesh, gather)


# ---------------------------------------------------------------------------
# AD-PSGD
# ---------------------------------------------------------------------------

class _ADPSGDStep(_RankStep):
    def __init__(self, api, optimizer, group, max_staleness, slow_learner,
                 slow_factor, gossip_fuse, elastic, device, mesh, gather):
        super().__init__(api, optimizer, group, device, gossip_fuse, mesh,
                         gather)
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
        loss, t = self._grads(w, batch, self._clock())
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
                           elastic: bool = False, device=None,
                           mesh=None, gather: str = "whole") -> Callable:
    """This rank's asynchronous-gossip tick: ``step(state, batch) ->
    (state, metrics)`` (``loss``, ``staleness_max``; elastic adds
    ``n_active``).

    Each rank mixes its live weights with ONE hypercube partner's chosen
    row (its live weights when it is at the staleness bound, else its
    last-published buffer), which may lag by up to ``max_staleness``
    ticks; the injected straggler ``slow_learner`` completes (and
    publishes) only every ``slow_factor`` ticks.  ``elastic=True`` reads
    the state's membership operands (``membership_operands``) instead of
    the static straggler.  The group's size (the learner count) must be
    a power of two (``ValueError``).  ``mesh``, ``gather``: as DPSGD's;
    the recompute of a period reads the live weights, never the published
    buffer."""
    return _ADPSGDStep(api, optimizer, group, max_staleness, slow_learner,
                       slow_factor, gossip_fuse, elastic, device, mesh,
                       gather)


# ---------------------------------------------------------------------------
# SSGD baseline
# ---------------------------------------------------------------------------

class _SSGDStep(_RankStep):
    def _grad_store(self, shape):
        # one extra row carries the loss through the gradient's all_reduce
        self._g_ext = torch.zeros((shape[1] + 1, LANE), device=self.device)
        return self._g_ext[:shape[1]].view(shape)

    def __call__(self, state: LaunchState, batch):
        self.last_rounds = []
        w = state.params
        loss, t = self._grads(w, batch, self._clock())
        self._g_ext[-1, 0] = loss
        self._learners.all_reduce(self._g_ext)
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
                         device=None, mesh=None,
                         gather: str = "whole") -> Callable:
    """This rank's SSGD step on replicated weights: ``step(state, batch)
    -> (state, {"loss"})``.  The mean of the ranks' gradients over equal
    shards equals the reference's gradient of the global batch's mean
    loss up to the order of a sum.  ``mesh``: the weights are sharded
    over the model axis and replicated over the learners; the gradient
    shard is all-reduced over the learner group.  ``gather``: as
    DPSGD's."""
    return _SSGDStep(api, optimizer, group, device, mesh=mesh,
                     gather=gather)


# ---------------------------------------------------------------------------
# the reference's weights carried across
# ---------------------------------------------------------------------------

def rank_state_from_numpy(step, params, *, momentum=None, buffer=None,
                          age=None, seed: int = 0) -> LaunchState:
    """This rank's launch state from the reference's STACKED state as numpy
    arrays (leaves (n, ...), e.g. ``np.asarray`` of a ``PjitTrainState``'s
    leaves): row ``rank`` (this rank's learner) of ``params`` (and of
    ``momentum`` and, for AD-PSGD, ``buffer``), through
    ``models/convert.py``, cut to this rank's shard under a model axis;
    ``age`` is the fleet's (n,) ages.  ``momentum`` needs a fused recipe
    (its momentum slot)."""
    r, dev = step.rank, step.device

    def row(tree):
        return tree_from_jax(tree_map(lambda a: a[r], tree), device=dev)

    state = step.init(row(params), seed)
    if momentum is not None:
        f = step.optimizer.fused
        if f is None or f.read_mu(state.opt_state) is None:
            raise ValueError("momentum given for an optimizer with no "
                             "fused momentum slot")
        f.read_mu(state.opt_state).copy_(step.local_store(row(momentum)))
    if buffer is not None:
        state.buffer.copy_(step.local_store(row(buffer)))
    if age is not None:
        state = state._replace(age=np.array(age, dtype=np.int32))
    return state


def gather_learner(step, store: torch.Tensor) -> torch.Tensor:
    """A learner's full (T, 128) store (the ``FlatMeta`` of its whole
    tree) from its ranks' (1, T_local, 128) shard stores ``store`` (the
    parameters, the momentum or the buffer): an ``all_gather`` over the
    model group, every rank of it calling.  Without a model axis, a copy
    of the rank's store.  For checks and checkpoints, off the step."""
    if step.M == 1:
        return store[0].clone()
    lay = step._layout
    stack = torch.empty((step.M,) + tuple(store.shape[1:]),
                        dtype=store.dtype, device=store.device)
    GroupComm(model_group(step.mesh), step.device).all_gather(store[0],
                                                              stack)
    full = torch.zeros((lay.full.rows, LANE), dtype=store.dtype,
                       device=store.device)
    lay.assemble(stack, full)
    return full


# ---------------------------------------------------------------------------
# donation: a consumed state is not used again
# ---------------------------------------------------------------------------

class _Donating:
    """``jit_train_step``'s wrapper: calls the step and remembers the
    state it returned; a call on any other state of this step (a state
    already consumed) raises ``ValueError``.  ``init`` and the other
    attributes are the step's."""

    def __init__(self, step):
        self._step, self._live = step, None

    def __getattr__(self, name):
        return getattr(self._step, name)

    def init(self, *args, **kwargs):
        self._live = None
        return self._step.init(*args, **kwargs)

    def __call__(self, state: LaunchState, *args, **kwargs):
        live = self._live
        if live is not None and (state.step != live.step
                                 or state.params is not live.params):
            raise ValueError(
                f"this state (step {state.step}) was consumed by an earlier "
                f"call: train the state the step returned (step "
                f"{live.step}), as a donated state")
        state, metrics = self._step(state, *args, **kwargs)
        self._live = state
        return state, metrics


def jit_train_step(step_fn: Callable) -> Callable:
    """The reference's ``jax.jit(step, donate_argnums=(0,))``: the step
    already runs eagerly and writes its two alternating stores in place,
    so this only enforces donation.  A consumed state raises if reused;
    rebind it: ``state, m = step(state, batch)``.  A state edited with
    ``_replace`` (membership operands) stays the live one.  It does not
    call ``torch.compile``."""
    return _Donating(step_fn)


# ---------------------------------------------------------------------------
# the landscape probe on the mesh
# ---------------------------------------------------------------------------

class _MeshProbe:
    """``make_probe_step``'s probe: rank (i, j) holds shard j of every
    vector.  The replicated tail of a vector lives on model rank 0 only
    (zeros on the others), so an inner product is each rank's local sum,
    all-reduced over the model group."""

    def __init__(self, api, mesh, alpha, stacked, lanczos_iters,
                 hutchinson_samples, reorth, gather, device):
        from .periodsweep import PeriodSweep
        self.device = resolve_device(device)
        self.api, self.mesh, self.alpha = api, mesh, alpha
        self.stacked, self.reorth = stacked, reorth
        self.m, self.n_hutch = lanczos_iters, hutchinson_samples
        self.M, self.j = model_size(mesh), model_rank(mesh)
        self.n = n_learners(mesh)
        self.layout = ShardLayout(param_shapes(api), self.M, self.j)
        self.model = GroupComm(model_group(mesh), self.device)
        self.learners = GroupComm(learner_group(mesh), self.device)
        # one model rank holds the whole learner: nothing to gather
        self.gather = _check_gather(gather) if self.M > 1 else "whole"
        self._sweep = (PeriodSweep(api, self.layout, self.model,
                                   self.device)
                       if self.gather == "period" else None)
        self._whole_bytes = 0

    @property
    def max_full_bytes(self) -> int:
        """The most full (unsharded) weight bytes a call held at once:
        the learner's float32 store (``"whole"``), or the non-period
        leaves' buffer and one period's (``"period"``); 0 before a
        call."""
        if self._sweep is not None:
            return self._sweep.max_full_bytes
        return self._whole_bytes

    def _owned(self, v: torch.Tensor) -> torch.Tensor:
        if self.j:
            self.layout.rep_tail(v).zero_()
        return v

    def _dot(self, a, b) -> torch.Tensor:
        return self.model.all_reduce(torch.sum(a * b).reshape(1))[0]

    def _local(self, tree) -> torch.Tensor:
        return self._owned(self.layout.flatten_local(tree,
                                                     device=self.device))

    def _drawn(self, draw) -> torch.Tensor:
        """A full float32 tree drawn leaf by leaf in tree order
        (``draw(shape)``: ``tree_gaussian_like`` / ``tree_rademacher_like``
        leaf by leaf), each leaf cut to this rank's shard as it is drawn:
        ``_local`` of the whole tree's draw, without the whole tree."""
        lay = self.layout
        out = torch.zeros((lay.local.rows, LANE), device=self.device)
        for x, shape, d, local in zip(lay.local.views(out), lay.full.shapes,
                                      lay.dims, lay.local.shapes):
            leaf = draw(shape)
            x.copy_(leaf if d is None
                    else leaf.narrow(d, self.j * local[d], local[d]))
        return self._owned(out)

    def _full_tree(self, v_local):
        """The full tree (float32 views of a fresh full store) of a
        sharded vector."""
        lay = self.layout
        self.model.all_gather(v_local, self._stack)
        full = torch.zeros((lay.full.rows, LANE), device=self.device)
        lay.assemble(self._stack, full)
        return full, lay.full.view_tree(full)

    def _reduce_full(self, full: torch.Tensor) -> torch.Tensor:
        """A full (T, 128) vector of this rank's rows -> the sharded sum
        over the model group (replicated tail on model rank 0)."""
        lay = self.layout
        lay.pack(full, self._stack, rep_slot=0)
        out = torch.empty((lay.local.rows, LANE), device=self.device)
        return self.model.reduce_scatter(self._stack, out)

    def __call__(self, params, batch, gen: Optional[torch.Generator] = None,
                 *, q0=None, probes=None):
        from ..core.util import gaussian_leaf, value_and_grad
        from ..landscape.hvp import make_hvp_fn, rademacher_leaf
        from ..landscape.lanczos import lanczos
        from ..landscape.predictor import predict_alpha_e
        from ..landscape.probe import ProbeResult

        lay, dev, n = self.layout, self.device, self.n
        T = lay.local.rows
        w = params.reshape(T, LANE).to(_F32)
        rows = _model_rows(batch, self.M, self.j)
        sweep = self._sweep
        if sweep is None:
            self._stack = torch.zeros((self.M, T, LANE), device=dev)
        count = _token_count(rows)
        total = torch.clamp(self.model.all_reduce(count.reshape(1).clone()),
                            min=1.0)[0]
        # this rank's rows weigh count / total in its learner's mean loss
        share = count / total

        def weighted(p, b):
            return self.api.loss_fn(p, b) * share

        if self.stacked:
            w_a = self.learners.all_reduce(w.clone()) / n
        else:
            w_a = w.clone()
        pft = self.api.params_from_tree
        if sweep is None:
            _, w_tree = self._full_tree(w_a)
            self._whole_bytes = lay.full.rows * LANE * 4
            with use_mesh(self.mesh):
                matvec = make_hvp_fn(weighted, w_tree,
                                     tree_map(lambda x: x[None], rows),
                                     params_from_tree=pft)

            def hv(v):
                _, v_tree = self._full_tree(v)
                out = torch.zeros((lay.full.rows, LANE), device=dev)
                with use_mesh(self.mesh):
                    matvec(v_tree, out=lay.full.view_tree(out))
                return self.learners.all_reduce(self._reduce_full(out)) / n
        else:
            def hv(v):
                with use_mesh(self.mesh):
                    out = sweep(w_a, rows, share, v)
                return self.learners.all_reduce(out) / n

        zero = torch.zeros((), dtype=_F32, device=dev)
        if self.stacked:
            rows_all = torch.empty((n, T, LANE), device=dev)
            self.learners.all_gather(w, rows_all)
            devs = [self._owned(rows_all[i] - w_a) for i in range(n)]
            del rows_all
            sig_sq = sum(self._dot(d, d) for d in devs) / n
            t_hc = sum(self._dot(d, hv(d)) for d in devs) / n
            del devs
        else:
            sig_sq = t_hc = zero

        # the learners' gradients at w_a, their mean and spread
        if sweep is None:
            with use_mesh(self.mesh):
                _, g_tree = value_and_grad(weighted, w_tree, rows, pft)
            g_i = self._reduce_full(lay.full.flatten(g_tree)
                                    .reshape(-1, LANE))
        else:
            with use_mesh(self.mesh):
                g_i = sweep(w_a, rows, share)
        g0 = self.learners.all_reduce(g_i.clone()) / n
        g_norm_sq = self._dot(g0, g0)
        dev_sq = self.learners.all_reduce(
            self._dot(g_i - g0, g_i - g0).reshape(1))[0]
        gns = dev_sq / max(n - 1, 1) / torch.clamp_min(g_norm_sq, 1e-30)

        if q0 is None and gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        if q0 is not None:
            q0 = self._local(q0)
        else:
            q0 = self._drawn(lambda shape: gaussian_leaf(gen, shape, _F32,
                                                         1.0))
        res = lanczos(hv, q0, self.m, reorth=self.reorth,
                      reduce=lambda t: self.model.all_reduce(t))
        lam = res.eigenvalues[-1]
        del res
        if probes is not None:
            probes = [self._local(z) for z in probes]
        else:
            probes = [self._drawn(lambda shape: rademacher_leaf(gen, shape))
                      for _ in range(self.n_hutch)]
        t_h = torch.mean(torch.stack([self._dot(z, hv(z)) for z in probes]))
        if sweep is None:
            del self._stack
        else:
            sweep.release()
        return ProbeResult(
            sharpness=lam, trace_h=t_h, trace_hc=t_hc, sigma_w_sq=sig_sq,
            grad_norm=torch.sqrt(g_norm_sq), gns=gns,
            alpha_e_pred=predict_alpha_e(self.alpha, t_hc, sig_sq))


def make_probe_step(api: ModelAPI, mesh, *, alpha: float, stacked: bool,
                    lanczos_iters: int = 8, hutchinson_samples: int = 4,
                    reorth: str = "auto", gather: str = "whole",
                    device=None) -> Callable:
    """``probe(params, batch, gen=None, *, q0=None, probes=None) ->
    landscape.ProbeResult`` on the mesh, every rank calling: ``params``
    is this rank's (1, T_local, 128) shard store (a DPSGD / AD-PSGD
    state's ``params``, or SSGD's with ``stacked=False``), ``batch`` its
    learner's batch (the step's).

    The measurement is the reference's ``probe_landscape`` at the
    learners' mean w_a (an ``all_reduce`` over the learner group) over
    the superbatch of the learners' batches: an HVP is each rank's HVP of
    its rows (weighted in its learner's mean loss) on the learner's
    weights, summed over the model group and all-reduced over the
    learners.  The Lanczos basis is each rank's (m + 1, T_local, 128)
    shard, reorthogonalized through kernels #4 / #5 (``reorth``; the
    dots all-reduced over the model group between the dots and the axpy
    of each CGS2 sweep).  ``Tr(HC)`` all-gathers the learners' shards
    over the learner group (n shards at once, transient).
    ``stacked=False`` (SSGD, a single replica): the spread terms are 0.

    ``gather``: ``"whole"`` gathers w_a's full tree once and each HVP's
    vector whole, and differentiates reverse over reverse
    (``landscape/hvp.py``); ``"period"`` keeps at most the non-period
    leaves and one period full on a rank: each gradient and HVP is a
    forward-over-reverse sweep a section at a time
    (``launch/periodsweep.py``), its result reduced section by section
    into the rank's shard.  It raises ``ValueError`` for a model it
    cannot sweep (no stacked periods: the encoder-decoder;
    ``use_pallas``; ``moe_backend="shard_map"``).  Over one model rank
    both are ``"whole"``.  ``probe.max_full_bytes`` is the most full
    weight bytes a call held at once.

    ``gen`` draws the Lanczos start vector, then the Hutchinson probes,
    leaf by leaf in tree order as full-tree draws (``"period"`` cuts
    each leaf to the rank's shard as it is drawn: the same draws on
    every rank, and in either mode); ``q0`` / ``probes`` (full trees)
    replace the draws."""
    return _MeshProbe(api, mesh, alpha, stacked, lanczos_iters,
                      hutchinson_samples, reorth, gather, device)


# ---------------------------------------------------------------------------
# spec builders (shapes only: the meta device, nothing allocated)
# ---------------------------------------------------------------------------

class _OnMeta(torch.overrides.TorchFunctionMode):
    """Every factory call's ``device`` becomes ``meta``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


_SHAPES = {}


def param_shapes(api: ModelAPI):
    """One learner's parameter tree (the reference's layout) on the meta
    device: shapes and dtypes, nothing allocated (the meta device runs
    each initializer op through Python: ~25 s for qwen3-moe-235b-a22b's
    128 experts a layer, so the tree is kept per config).  Callers read
    it; none writes it."""
    from ..models import build_model
    tree = _SHAPES.get(api.cfg)
    if tree is None:
        cpu = build_model(api.cfg, device="cpu")
        with torch.device("meta"), _OnMeta():
            tree = _SHAPES[api.cfg] = cpu.param_tree(cpu.init(0))
    return tree


def decode_cache_shapes(api: ModelAPI, batch: int, buf_len: int,
                        enc_len: int = 0):
    """The rotating decode cache of ``batch`` sequences on the meta
    device, as ``api.init_cache`` lays it out: the audio family's from
    ``enc_len`` frames encoded on ``param_shapes``."""
    from ..models.layers import dtype_of
    from ..models.transformer import init_cache
    cfg = api.cfg
    if cfg.family != "audio":
        return init_cache(cfg, batch, buf_len, "meta")
    frames = torch.empty((batch, enc_len, cfg.d_model),
                         dtype=dtype_of(cfg.param_dtype), device="meta")
    with torch.no_grad():
        return api.init_cache(api.params_from_tree(param_shapes(api)),
                              frames, buf_len)


def _meta_like(x, lead=()):
    return torch.empty(tuple(lead) + tuple(x.shape), dtype=x.dtype,
                       device="meta")


def stacked_param_specs(api: ModelAPI, L: int):
    """``param_shapes`` with a leading learner dim of L."""
    return tree_map(lambda x: _meta_like(x, (L,)), param_shapes(api))


def train_state_specs(api: ModelAPI, optimizer: Optimizer, mesh, *,
                      algo: str, elastic: bool = False) -> LaunchState:
    """A ``LaunchState`` of meta tensors: the reference's
    ``train_state_specs``.  DPSGD / AD-PSGD stack every leaf of the
    parameters and the optimizer state over the L learners; SSGD keeps
    one replica.  AD-PSGD adds the buffer and the (L,) ages and clocks,
    ``elastic`` the membership operands."""
    L = n_learners(mesh_shape(mesh))
    single = param_shapes(api)
    with torch.device("meta"), _OnMeta():
        opt = optimizer.init(single)
    extra = {}
    if algo in ("dpsgd", "adpsgd"):
        p = tree_map(lambda x: _meta_like(x, (L,)), single)
        opt = tree_map(lambda x: _meta_like(x, (L,)), opt)
        if algo == "adpsgd":
            extra.update(buffer=p, age=_meta_like(torch.empty(
                (L,), dtype=torch.int32, device="meta")),
                clock=_meta_like(torch.empty((L,), dtype=torch.int32,
                                             device="meta")))
        if elastic:
            extra.update(
                active=torch.empty((L,), dtype=torch.bool, device="meta"),
                slow_every=torch.empty((L,), dtype=torch.int32,
                                       device="meta"),
                drop_round=torch.empty((), dtype=torch.bool, device="meta"))
    else:
        p = single
    return LaunchState(params=p, opt_state=opt, step=0, seed=0, **extra)


def train_state_shardings(state_specs: LaunchState, mesh, *,
                          algo: str) -> LaunchState:
    """The specs of ``train_state_specs``' leaves: the reference's
    ``train_state_shardings``.  The optimizer state mirrors the
    parameters where it has more than one dim; its scalars (and stacked
    scalars) are replicated."""
    from ..tree import tree_flatten, tree_flatten_with_path, tree_unflatten
    from .sharding import P, leaf_spec, params_sharding

    stacked = algo in ("dpsgd", "adpsgd")
    lax = learner_axes(mesh)
    size = mesh_shape(mesh).shape["model"]
    p = params_sharding(state_specs.params, mesh, stacked=stacked)

    def opt_spec(path, leaf):
        if leaf.dim() <= 1:
            return P(*([None] * leaf.dim()))
        return leaf_spec(path, leaf, size,
                         learner_axes=lax if stacked else None)

    _, treedef = tree_flatten(state_specs.opt_state)
    o = tree_unflatten(treedef, [
        opt_spec(pa, leaf)
        for pa, leaf in tree_flatten_with_path(state_specs.opt_state)])
    extra = {}
    if algo == "adpsgd":
        extra.update(buffer=p, age=P(lax), clock=P(lax))
    if state_specs.active is not None:
        extra.update(active=P(lax), slow_every=P(lax), drop_round=P())
    return LaunchState(params=p, opt_state=o, step=P(), seed=P(), **extra)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class _MeshServe:
    """What the mesh's prefill and decode steps share: this rank's shard
    layout, the model group's collectives and the weights gathered from a
    rank's store -- the learner's whole tree once (``"whole"``; kept while
    the same store is passed), or its non-period leaves once and each
    period as the forward reaches it (``"period"``).  The whole tree is
    gathered section by section, each straight into its leaves' own
    dtype, so the transient is one section's stack, not a float32 copy
    of the learner."""

    def __init__(self, api: ModelAPI, mesh, gather: str, device):
        self.device = resolve_device(device)
        self.api, self.mesh = api, mesh
        self.gather = _check_gather(gather)
        self.M, self.j = model_size(mesh), model_rank(mesh)
        self.n, self.learner = n_learners(mesh), learner_rank(mesh)
        self.layout = ShardLayout(param_shapes(api), self.M, self.j)
        if self.gather == "period" and not self.layout.n_periods:
            raise ValueError(
                f"gather='period' does not serve {api.cfg.name}: its tree "
                "has no stacked periods (an encoder-decoder's layers are "
                "not periods)")
        self.comm = GroupComm(model_group(mesh), self.device)
        self._gatherer = LearnerGather(self.layout, self.comm, self.device)
        self._src = self._params = None

    def shard(self, tree) -> torch.Tensor:
        """A learner's full tree -> this rank's (1, T_local, 128) store."""
        return self.layout.flatten_local(tree, device=self.device)[None]

    @property
    def max_full_bytes(self) -> int:
        return self._gatherer.max_full_bytes

    def params(self, store: torch.Tensor):
        """The model's parameters from this rank's store ``store``."""
        if store is self._src:
            return self._params
        lay, dev, gat = self.layout, self.device, self._gatherer
        full, local = lay.full, store.reshape(-1, LANE)
        if self.gather == "whole":
            leaves = [torch.empty(s, dtype=dt, device=dev)
                      for s, dt in zip(full.shapes, full.dtypes)]
            gat.gather(local, None, out=[leaves[i] for i in lay.rest.leaves])
            for p in range(lay.n_periods):
                gat.gather(local, p,
                           out=[leaves[i][p] for i in lay.period.leaves])
            params = self.api.params_from_tree(
                tree_unflatten(full.treedef, leaves))
        else:
            rest = gat.gather(local, None, dtypes=True)
            params = PeriodParams(
                tree_unflatten(lay.rest.meta.treedef, rest), lay.n_periods,
                lambda p: period_layers(tree_unflatten(
                    lay.period.meta.treedef, gat.gather(local, p,
                                                        dtypes=True))))
        if self.gather == "whole":
            gat.release()
        self._src, self._params = store, params
        return params


class _MeshPrefill(_MeshServe):
    def __call__(self, params, batch):
        rows = _model_rows(batch, self.M, self.j)
        with torch.no_grad():
            return self.api.apply(self.params(params), rows)


class _MeshDecode(_MeshServe):
    """The sequence-sharded decode: ``transformer.decode_step``'s
    ``seq_shard`` (``merge``, ``state``, ``keep``), with the softmax
    partials and recurrent states on a collectives object of their own
    (``seq_comm``: its calls are the decode's per-step collectives)."""

    def __init__(self, api, mesh, gather, device):
        super().__init__(api, mesh, gather, device)
        self.rank, self.size = self.j, self.M
        self.seq_comm = GroupComm(model_group(mesh), self.device)
        self._state_dims = None

    def init_cache(self, batch: int, buf_len: int, *, store=None,
                   frames=None):
        """This rank's shard of the rotating decode cache of ``batch``
        sequences (the whole fleet's: each learner serves batch / L of
        them) as ``cache_sharding`` places it: the batch dim over the
        learners, an attention buffer's time dim over ``model`` (W / M
        rows; a windowed layer's own W = min(buf_len, window)), a
        recurrent state's feature dim over ``model``, ``slot_pos``
        whole.  The audio family's cache encodes the learner's ``frames``
        (its B / L rows) on the weights of ``store`` (this rank's shard
        store): ``_encode`` leaves the rank the cross K/V of every one of
        the learner's rows over its slice of the encoder length, S_enc /
        M positions.  A batch the learners do not split, or a buffer or
        an encoder length the model ranks do not, raises
        ``ValueError``."""
        from ..tree import tree_flatten_with_path, tree_leaves
        from .sharding import cache_sharding, spec_dim
        audio = self.api.cfg.family == "audio"
        if audio != (frames is not None) or audio != (store is not None):
            raise ValueError("the audio family's cache takes store= and "
                             "frames= (the learner's), and only it does")
        if audio and frames.shape[0] * self.n != batch:
            raise ValueError(f"frames of {frames.shape[0]} rows are not a "
                             f"learner's share of {batch} sequences")
        full = decode_cache_shapes(self.api, batch, buf_len,
                                   frames.shape[1] if audio else 0)
        specs = tree_leaves(cache_sharding(full, self.mesh))
        out, dims = {}, {}
        for (path, x), spec in zip(tree_flatten_with_path(full), specs):
            layer, name = path
            shape = list(x.shape)
            d = spec_dim(spec)
            if name == "slot_pos":
                out.setdefault(layer, {})[name] = torch.full(
                    shape, -1, dtype=x.dtype, device=self.device)
                continue
            if spec[1] is None:
                raise ValueError(f"a batch of {batch} sequences does not "
                                 f"split over {self.n} learners")
            shape[1] //= self.n
            if name in _BUFFERS and self.M > 1 and d != 2:
                what = ("an encoder length of" if name in ("xk", "xv")
                        else "a buffer of")
                raise ValueError(
                    f"{layer}: {what} {shape[2]} rows does not split "
                    f"over {self.M} model ranks")
            if d is not None:
                shape[d] //= self.M
            if name not in _BUFFERS:
                dims.setdefault(layer, {})[name] = (None if d is None
                                                    else d - 1)
            out.setdefault(layer, {})[name] = torch.zeros(
                shape, dtype=x.dtype, device=self.device)
        self._state_dims = dims
        if audio:
            self._encode(out["cross"], store, frames)
        return out

    def _encode(self, cross, store, frames) -> None:
        """The learner's cross K/V, cut over the model ranks on the encoder
        length: model rank j encodes its B / (L M) rows of ``frames``
        (``_model_rows``) on the gathered weights and computes their cross
        K/V for every decoder layer over the whole encoder length, straight
        into a send buffer (M, 2, n_layers, rows, S_enc / M, KV, hd) whose
        slot m is the slice model rank m keeps; one all-to-all over the
        model group (``moe_shardmap.all_to_all``, raw bytes; it counts
        its calls) gives this rank slot j of every rank's rows, written
        into ``cross``.  The rank holds its own rows' K/V at full length
        and the received slices, never the learner's whole cross
        cache."""
        from ..models.encdec import cross_kv, encode
        from ..models.moe_shardmap import all_to_all
        cfg, M = self.api.cfg, self.M
        params = self.params(store)
        xk = cross["xk"]
        nl, b, s = xk.shape[0], xk.shape[1], xk.shape[2]
        with torch.no_grad():
            memory = encode(params, cfg, _model_rows(frames, M, self.j))
            rows = memory.shape[0]
            send = torch.empty((M, 2, nl, rows) + tuple(xk.shape[2:]),
                               dtype=xk.dtype, device=self.device)
            for l, lp in enumerate(params.dec_layers):
                for t, kv in enumerate(cross_kv(lp, cfg, memory)):
                    send[:, t, l].copy_(kv.unflatten(1, (M, s))
                                        .movedim(1, 0))
            del memory
            recv = (send if M == 1
                    else all_to_all(send, model_group(self.mesh)))
            del send
            for t, name in enumerate(("xk", "xv")):
                cross[name].view((nl, M, b // M) + tuple(xk.shape[2:])) \
                    .copy_(recv[:, t].movedim(0, 1))

    def merge(self, m, lsum, o):
        part = torch.cat([o, m[..., None], lsum[..., None]], dim=-1)
        stack = torch.empty((self.M,) + tuple(part.shape),
                            device=self.device)
        self.seq_comm.all_gather(part, stack)
        return merge_partials(stack)

    def state(self, layer: str, cc):
        """A recurrent layer's whole state: one all_gather of the ranks'
        slices of its sharded leaves (float32 on the wire), its
        replicated leaves as they are (the update writes them in
        place)."""
        dims = self._state_dims[layer]
        cut = [n for n in sorted(cc) if dims.get(n) is not None]
        full = {n: x for n, x in cc.items() if n not in cut}
        if not cut:
            return full
        send = torch.cat([cc[n].float().reshape(-1) for n in cut])
        stack = torch.empty((self.M, send.numel()), device=self.device)
        self.seq_comm.all_gather(send, stack)
        off = 0
        for n in cut:
            x, d = cc[n], dims[n]
            shape = list(x.shape)
            shape[d] *= self.M
            f = torch.empty(shape, dtype=x.dtype, device=self.device)
            piece = f.unflatten(d, (self.M, -1)).movedim(d, 0)
            piece.copy_(stack[:, off:off + x.numel()].view(piece.shape))
            full[n] = f
            off += x.numel()
        return full

    def keep(self, layer: str, cc, full) -> None:
        """This rank's slice of a recurrent layer's new state."""
        for n, d in self._state_dims[layer].items():
            if d is not None:
                k = cc[n].shape[d]
                cc[n].copy_(full[n].narrow(d, self.j * k, k))

    def __call__(self, params, cache, tokens, pos):
        from ..models import encdec, transformer
        if self._state_dims is None:
            raise ValueError("build the cache with step.init_cache")
        family = encdec if self.api.cfg.family == "audio" else transformer
        return family.decode_step(self.params(params), self.api.cfg, cache,
                                  tokens, pos, seq_shard=self)


# a decode cache's attention buffers: cut on their time dim over ``model``
_BUFFERS = ("k", "v", "xk", "xv")


def make_prefill_step(api: ModelAPI, mesh=None, *, gather: str = "whole",
                      device=None) -> Callable:
    """``prefill(params, batch) -> logits``.  Without a mesh: ``api.apply``
    (the reference's step).  With one: ``params`` is this rank's (1,
    T_local, 128) shard store (``step.shard(tree)``), ``batch`` its
    learner's rows; the rank runs its share of them (B / M rows;
    ``_model_rows``, a batch that does not split raises) through
    ``api.apply`` on the gathered weights (``gather``: ``"whole"`` once,
    ``"period"`` a period at a time each call) and returns their logits;
    ``gather_rows`` assembles the learner's.  A ``use_pallas`` config's
    attention runs through the flash kernel on each rank's rows.  The
    audio family serves ``{"frames", "tokens"}`` rows the same way;
    ``gather="period"`` raises ``ValueError`` for it (its tree has no
    stacked periods)."""
    if mesh is None:
        def prefill(params, batch):
            return api.apply(params, batch)
        return prefill
    return _MeshPrefill(api, mesh, gather, device)


def make_decode_step(api: ModelAPI, mesh=None, *, gather: str = "whole",
                     device=None) -> Callable:
    """``decode(params, cache, tokens, pos) -> (logits, cache)``.  Without
    a mesh: ``api.decode_step``.  With one, the sequence-sharded decode
    (``cache_sharding``'s placement): ``params`` is this rank's shard
    store, ``cache`` its shard (``step.init_cache(batch, buf_len)``),
    ``tokens`` its learner's (B / L, 1) rows.  Every model rank of a
    learner runs q / k / v, the MLP and the head for all of the learner's
    rows on gathered weights (``"whole"``: gathered once, at the first
    call with a store; ``"period"``: a period at a time each step); the
    new K/V row is written by the rank whose slice of the buffer holds
    ``pos % W``; each attention layer's softmax over the rank's slice
    gives float32 partials (row max, sum, unnormalized output), which one
    ``all_gather`` of B/L x H x (hd + 2) floats over the model group
    combines in rank order.  A recurrent layer (mamba, mLSTM, sLSTM)
    keeps its state's feature dim sharded: one ``all_gather`` of the
    slices (the state's elements x (M - 1) / M floats into a rank) gives
    the whole state for the update, and the rank keeps its slice of the
    new one.  So a step's collectives (``step.seq_comm``) are one a layer
    with attention or a sharded state; the weights' gathers count on
    ``step.comm``.

    The audio family (seamless-m4t-large-v2's encoder-decoder):
    ``step.init_cache(batch, buf_len, store=, frames=)`` encodes the
    learner's frames, each model rank its rows, and one all-to-all over
    the model group leaves each rank its slice of the encoder length for
    all of the learner's rows (``cache_sharding``'s placement of ``xk`` /
    ``xv``); a decoder layer then merges two attentions' partials, the
    self-attention's over the rank's slice of the buffer and the
    cross-attention's over its slice of the encoder length: two
    collectives a decoder layer a step.  ``gather="period"`` raises
    ``ValueError`` for it (its tree has no stacked periods)."""
    if mesh is None:
        def decode(params, cache, tokens, pos):
            return api.decode_step(params, cache, tokens, pos)
        return decode
    return _MeshDecode(api, mesh, gather, device)


def gather_rows(step, x: torch.Tensor) -> torch.Tensor:
    """A learner's rows of ``x`` (this rank's share, e.g. a mesh prefill's
    logits) from its model group, in rank order: one ``all_gather``, every
    rank of the group calling."""
    if step.M == 1:
        return x
    stack = torch.empty((step.M,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    step.comm.all_gather(x.contiguous(), stack)
    return stack.reshape((-1,) + tuple(x.shape[1:]))
