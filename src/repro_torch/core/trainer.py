"""MultiLearnerTrainer — SSGD / DPSGD / AD-PSGD on the flat engine; the port
of ``repro/core/trainer.py``.

Semantics (paper Sec. 2; Lian et al. 2018 for the async variant):
  SSGD   : g_j = grad L^{mu_j}(w_a);          w_a <- w_a + opt(mean_j g_j)
  DPSGD  : g_j = grad L^{mu_j}(w_j);          w_j <- mix(w)_j + opt_j(g_j)
  AD-PSGD: like DPSGD with pairwise gossip, but the partner's contribution is
           its last *published* weights (stale by up to ``max_staleness``
           ticks), and an injected straggler only completes a step every
           ``slow_factor`` ticks.

The flat engine (DESIGN §11) keeps the stacked parameters as ONE persistent
(n, T, 128) float32 buffer (``core/flatstate.py``), flattened once at init.
Each learner's parameters are views into it, bound once at init: every view
is its own autograd leaf whose ``.grad`` is the matching view of one
(n, T, 128) grad buffer, so a backward pass adds the gradients straight
into that buffer (no parameter-sized ``cat``).  The gossip + momentum-SGD
update then runs as the hand-written kernel (``kernels/ops``), once per
gossip round; ``kernel_backend="ref"`` runs its plain version instead.

Two (n, T, 128) weight buffers alternate: a kernel pass reads one and
writes the other (another learner may still read a row a block would
overwrite), and each buffer carries its own bound views.  So a state is
consumed by ``train_step`` — as the reference donates it — and the trainer
holds one live state at a time.  AD-PSGD's published buffer alternates the
same way; the momentum is updated in place.

The probe seam (DESIGN §10): ``add_probe`` registers a measurement under
a schedule (``landscape.ProbeSchedule``), ``run_probes`` runs the due ones
between steps — each receives the tree view ``state_view(state)``, and its
optional ``on_result`` receives the real flat state, so a controller
(``landscape.AutoLRController`` through ``optim.set_controller_scale``)
writes the live optimizer state.  ``diagnostics`` measures the paper's
alpha_e, sigma_w^2 and Delta split (``core/diagnostics.py``).

What the reference has and this port does not yet (each raises
``NotImplementedError`` naming its ROADMAP slice): the pytree engine and
SSGD* (the rest of slice 2); elastic membership (slice 4).
``engine="auto"`` sends every algorithm, SSGD included, to the flat
engine, since the pytree engine is not ported.

``train_step`` makes no host sync: gossip tables are drawn on the device,
masks are built there from host integers, and the metrics stay device
tensors.  Nor do ``run_probes`` and ``diagnostics`` (``state.step`` is a
host integer); a controller's reads of a probe result are its own.

# lint: hot-path
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..kernels import ops as kops
from ..optim import Optimizer, apply_updates
from . import schedule as gsched
from .diagnostics import DiagStats, compute_diagnostics
from .dpsgd import (AlgoConfig, mean_broadcast, mix_einsum,
                    mix_pair_gather, straggler_active_mask)
from .flatstate import LANE, FlatMeta, flat_meta
from ..tree import tree_leaves, tree_map

_PYTREE = ("the pytree engine is not ported yet: it arrives with the rest "
           "of ROADMAP slice 2")


class TrainState(NamedTuple):
    params: Any           # (n, T, 128) flat store (one of two alternating)
    opt_state: Any        # stacked per-learner
    step: int             # a host integer: no device read to branch on it
    seed: int             # matchings at step t come from (seed, t)
    # -- adpsgd only (None otherwise) --------------------------------------
    buffer: Any = None    # last-published weights, (n, T, 128)
    age: Any = None       # (n,) int32 ticks since each learner published
    clock: Any = None     # (n,) int32 completed local steps per learner
    members: Any = None   # elastic membership: ROADMAP slice 4


class StepMetrics(NamedTuple):
    loss: torch.Tensor          # mean per-learner minibatch loss
    grad_norm: torch.Tensor     # ||g_a|| (consensus gradient)
    sigma_w_sq: torch.Tensor    # weight variance across learners
    staleness_mean: torch.Tensor  # mean buffer age seen at gossip (adpsgd)
    staleness_max: torch.Tensor   # max buffer age seen at gossip (adpsgd)
    n_active: torch.Tensor      # live learner count this tick
    grad_sq_mean: torch.Tensor  # mean_i ||g_i||^2


def _param_leaves(params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return tree_leaves(params)


def _step_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % (2 ** 63)


@dataclasses.dataclass
class ProbeHook:
    """A scheduled measurement on the trainer's probe seam.

    ``schedule.due(step)`` gates it (e.g. ``landscape.ProbeSchedule``);
    ``fn(state_view, batch) -> result`` is the measurement
    (``trainer.diagnostics``, a landscape probe, ...); ``on_result(state,
    result) -> state`` optionally closes a control loop (AutoLR writing its
    multiplier into the optimizer state)."""
    name: str
    schedule: Any
    fn: Callable
    on_result: Optional[Callable] = None


@dataclasses.dataclass
class MultiLearnerTrainer:
    loss_fn: Callable          # (params, batch) -> scalar, one learner
    optimizer: Optimizer
    algo: AlgoConfig
    alpha_for_diag: float = 1.0   # alpha of the alpha_e instrument
    hooks: list = dataclasses.field(default_factory=list)  # [ProbeHook]
    engine: str = "auto"       # auto | flat (pytree: not ported yet)
    kernel_backend: str = "auto"   # auto | cuda | ref (flat-engine dispatch)
    # tree of views (the reference's layout) -> the params object loss_fn
    # takes; identity for dict-of-tensor models such as the FC net
    params_from_tree: Optional[Callable] = None
    device: Any = None         # None -> cuda (raises without a card)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._schedule = gsched.make_schedule(
            self.algo.topology, self.algo.n_learners,
            rounds=self.algo.gossip_rounds)
        opt = self.optimizer
        if (getattr(opt, "wants_mixed", False)
                and self.algo.gossip_order != "mix_then_descend"):
            raise ValueError("decentlam-style optimizers need the gossip "
                             "average: use gossip_order='mix_then_descend'")
        if self.engine not in ("auto", "flat", "pytree"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.kernel_backend not in kops.BACKENDS:
            raise ValueError(f"kernel_backend must be one of {kops.BACKENDS}"
                             f", got {self.kernel_backend!r}")
        if self.engine == "pytree":
            raise NotImplementedError(f"engine='pytree': {_PYTREE}")
        if self.algo.algo == "ssgd_star":
            raise NotImplementedError(
                f"ssgd_star draws per-leaf weight noise on the pytree "
                f"engine; {_PYTREE}")
        if getattr(opt, "layout_sensitive", False):
            raise ValueError(
                "this optimizer's update depends on the per-leaf structure; "
                f"the flat engine would change its semantics, and {_PYTREE}")
        f = getattr(opt, "fused", None)
        self._fused = None
        if (f is not None and self.algo.algo in ("dpsgd", "adpsgd")
                and not getattr(opt, "wants_mixed", False)
                and self.algo.gossip_order == "mix_then_descend"
                and self._schedule is not None):
            self._fused = f
        self._meta: Optional[FlatMeta] = None   # set at init()
        self._gen = torch.Generator(device=self.device)

    # -- engine helpers -------------------------------------------------------
    @property
    def rounds_per_step(self) -> int:
        """Gossip kernel passes per step (0 for ssgd and solo)."""
        if self.algo.algo == "ssgd" or self._schedule is None:
            return 0
        return self._schedule.rounds_per_step

    def _make_params(self, tree):
        return tree if self.params_from_tree is None else \
            self.params_from_tree(tree)

    def _bind(self, w_row: torch.Tensor, g_row: torch.Tensor):
        """The loss_fn's params object for one learner's row of the store:
        every parameter a view of ``w_row`` and an autograd leaf whose
        ``.grad`` is the matching view of ``g_row``."""
        meta = self._meta
        pw = self._make_params(tree_map(lambda v: v.detach().requires_grad_(),
                                        meta.unflatten(w_row)))
        pg = self._make_params(meta.unflatten(g_row))
        for a, b in zip(_param_leaves(pw), _param_leaves(pg)):
            a.grad = b.detach()
        return pw

    def _bound(self, w: torch.Tensor):
        return self._views[0 if w is self._w[0] else 1]

    def _other(self, t: torch.Tensor, pair) -> torch.Tensor:
        return pair[1] if t is pair[0] else pair[0]

    def params_tree(self, state_or_params):
        """The stacked parameter tree view of a state (leaves (n, ...))."""
        p = (state_or_params.params if isinstance(state_or_params, TrainState)
             else state_or_params)
        return self._meta.unflatten(p)

    def state_view(self, state: TrainState) -> TrainState:
        """Tree-layout view of a flat state: parameters, buffer and any
        (n, T, 128) optimizer leaves (momentum) come back as stacked trees
        of views; other optimizer leaves pass through."""
        meta = self._meta

        def leafview(x):
            if (isinstance(x, torch.Tensor) and x.dim() >= 2
                    and tuple(x.shape[-2:]) == (meta.rows, LANE)):
                return meta.unflatten(x)
            return x

        return state._replace(
            params=meta.unflatten(state.params),
            buffer=(None if state.buffer is None
                    else meta.unflatten(state.buffer)),
            opt_state=tree_map(leafview, state.opt_state))

    # -- init -----------------------------------------------------------------
    def init(self, seed: int, params_single) -> TrainState:
        """``params_single``: one learner's parameter tree in the
        reference's layout (e.g. ``fcnet.init_params`` or
        ``api.param_tree(api.init(seed))``), float32 leaves.  Every learner
        starts from it."""
        n = self.algo.n_learners
        meta = flat_meta(params_single)
        bad = [d for d in meta.dtypes if d != torch.float32]
        if bad:
            raise ValueError(f"the flat engine trains float32 leaves; got "
                             f"{sorted(set(map(str, bad)))}")
        self._meta = meta
        one = meta.flatten(params_single, device=self.device)
        shape = (n, meta.rows, LANE)
        self._w = [torch.empty(shape, device=self.device) for _ in range(2)]
        self._w[0].copy_(one.expand(shape))
        del one
        self._g = torch.zeros(shape, device=self.device)
        self._views = [[self._bind(w[i], self._g[i]) for i in range(n)]
                       for w in self._w]
        self._wa, self._views_wa = None, None
        if self.algo.algo == "ssgd":
            self._wa = torch.empty(shape[1:], device=self.device)
            self._views_wa = [self._bind(self._wa, self._g[i])
                              for i in range(n)]
        opt_state = self.optimizer.init(self._w[0])
        buffer = age = clock = None
        if self.algo.algo == "adpsgd":
            self._buf = [self._w[0].clone(), torch.empty(shape,
                                                         device=self.device)]
            buffer = self._buf[0]
            age = torch.zeros((n,), dtype=torch.int32, device=self.device)
            clock = torch.zeros((n,), dtype=torch.int32, device=self.device)
        return TrainState(self._w[0], opt_state, 0, seed, buffer=buffer,
                          age=age, clock=clock)

    # -- optimizer pieces -----------------------------------------------------
    def _opt_update(self, grads, opt_state, params, mixed):
        if getattr(self.optimizer, "wants_mixed", False):
            return self.optimizer.update(grads, opt_state, params, mixed)
        return self.optimizer.update(grads, opt_state, params)

    def _fused_step(self, w, remote, grads, opt_state, partners, coefs, *,
                    out, active=None, buffer=None, buffer_out=None,
                    nbr_fresh=None, publish=None, weight_decay=None):
        """Dispatch the gossip + SGD kernel and thread the optimizer state.
        Returns (w_new, opt_state[, buffer_new])."""
        f = self._fused
        n = w.shape[0]
        ones = torch.ones((n,), dtype=torch.float32, device=w.device)
        scale = ones * f.scale(opt_state)
        act = ones if active is None else active.to(torch.float32)
        cols = [coefs, scale[:, None], act[:, None]]
        if buffer is not None:
            cols += [nbr_fresh.to(torch.float32)[:, None],
                     publish.to(torch.float32)[:, None]]
        table = torch.cat(cols, dim=1)
        wd = f.weight_decay if weight_decay is None else weight_decay
        res = kops.flat_gossip_update(
            w, remote, grads, f.read_mu(opt_state), partners, table,
            lr=f.lr, beta=f.beta, weight_decay=wd, buffer=buffer, out=out,
            buffer_out=buffer_out, backend=self.kernel_backend)
        opt_state = f.bump(opt_state)
        if res[1] is not None:
            opt_state = f.write_mu(opt_state, res[1])
        if buffer is not None:
            return res[0], opt_state, res[2]
        return res[0], opt_state

    def _select_nonflat(self, mask, new, old):
        """Per-learner select on the small optimizer leaves (schedule
        counters, scales); (n, T, 128) leaves were selected in the kernel."""
        def _sel(a, b):
            if a.dim() >= 2 and tuple(a.shape[-2:]) == (self._meta.rows,
                                                         LANE):
                return a
            m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        return tree_map(_sel, new, old)

    def _mix_sched(self, stacked, rounds, step: int):
        """Schedule-driven gossip for the unfused paths: matchings as
        gathers, deterministic schedules as the step's matrix."""
        s = self._schedule
        if s is None:
            return stacked
        if s.randomized:
            out = stacked
            for partners, _ in rounds:
                out = mix_pair_gather(out, partners[0])
            return out
        return mix_einsum(stacked, s.step_matrix(None, step,
                                                 device=stacked.device))

    def _rounds(self, state: TrainState, rounds):
        if self._schedule is None or self.algo.algo == "ssgd":
            return []
        if rounds is None:
            self._gen.manual_seed(_step_seed(state.seed, state.step))
            return self._schedule.step_rounds(self._gen, state.step,
                                              device=self.device)
        return [(torch.as_tensor(p, dtype=torch.int32, device=self.device),
                 torch.as_tensor(c, dtype=torch.float32, device=self.device))
                for p, c in rounds]

    def _grads(self, bound, batch) -> torch.Tensor:
        """Forward + backward per learner, one at a time; gradients land in
        the grad buffer through the bound views.  Returns the (n,) losses."""
        self._g.zero_()
        losses = []
        with torch.enable_grad():
            for i, params in enumerate(bound):
                loss = self.loss_fn(params, tree_map(lambda x: x[i], batch))
                loss.backward()
                losses.append(loss.detach())
        return torch.stack(losses)

    # -- one training step ----------------------------------------------------
    def train_step(self, state: TrainState, stacked_batch, rounds=None):
        """stacked_batch leaves: (n, B_local, ...).  ``rounds``: optional
        per-round ``(partners (K, n) int32, coefs (n, K + 1) float32)``
        tables that replace the schedule's draw for this step (the parity
        tests inject the reference's).  Returns (new state, StepMetrics)."""
        if state.members is not None:
            raise NotImplementedError(
                "elastic membership arrives with ROADMAP slice 4")
        algo = self.algo
        n = algo.n_learners
        dev = self.device
        zero = torch.zeros((), device=dev)
        stale_mean, stale_max = zero, zero
        buffer, age, clock = state.buffer, state.age, state.clock
        w = state.params
        w_next = self._other(w, self._w)
        g = self._g
        rounds = self._rounds(state, rounds)

        if algo.algo == "ssgd":
            torch.mean(w, dim=0, out=self._wa)
            losses = self._grads(self._views_wa, stacked_batch)
            g_stacked = torch.mean(g, dim=0)[None].expand(w.shape)
            updates, opt_state = self._opt_update(g_stacked, state.opt_state,
                                                  w, w)
            new_params = w_next.copy_(mean_broadcast(apply_updates(w,
                                                                   updates)))

        elif algo.algo == "dpsgd":
            losses = self._grads(self._bound(w), stacked_batch)
            if self._fused is not None:
                # leading rounds mix only; the last fuses the update
                g_upd, wd = g, None
                if len(rounds) > 1 and self._fused.weight_decay:
                    # decay the PRE-mix local weights, as the reference does
                    g_upd = g + self._fused.weight_decay * w
                    wd = 0.0
                cur = w
                for partners, coefs in rounds[:-1]:
                    cur = kops.flat_gossip_mix(
                        cur, partners, coefs, out=self._other(cur, self._w),
                        backend=self.kernel_backend)
                partners, coefs = rounds[-1]
                new_params, opt_state = self._fused_step(
                    cur, cur, g_upd, state.opt_state, partners, coefs,
                    out=self._other(cur, self._w), weight_decay=wd)
            elif algo.gossip_order == "mix_then_descend":
                mixed = self._mix_sched(w, rounds, state.step)
                updates, opt_state = self._opt_update(g, state.opt_state, w,
                                                      mixed)
                new_params = w_next.copy_(apply_updates(mixed, updates))
            else:                                       # descend_then_mix
                updates, opt_state = self._opt_update(g, state.opt_state, w,
                                                      w)
                new_params = w_next.copy_(self._mix_sched(
                    apply_updates(w, updates), rounds, state.step))

        elif algo.algo == "adpsgd":
            active = straggler_active_mask(state.step, n, algo.slow_learner,
                                           algo.slow_factor, device=dev)
            fresh = age >= algo.max_staleness
            stale_seen = torch.where(fresh, 0, age)
            stale_mean = torch.mean(stale_seen.to(torch.float32))
            stale_max = torch.max(stale_seen).to(torch.float32)
            losses = self._grads(self._bound(w), stacked_batch)
            (partners, coefs), = rounds
            partner = partners[0].long()
            buf_next = self._other(buffer, self._buf)
            if self._fused is not None:
                new_params, opt_state_new, buffer = self._fused_step(
                    w, w, g, state.opt_state, partners, coefs, out=w_next,
                    active=active, buffer=buffer, buffer_out=buf_next,
                    nbr_fresh=fresh[partner], publish=active | fresh)
                opt_state = self._select_nonflat(active, opt_state_new,
                                                 state.opt_state)
            else:
                remote = torch.where(fresh[:, None, None], w, buffer)
                mixed = mix_pair_gather(w, partner, remote)
                updates, opt_state_new = self._opt_update(
                    g, state.opt_state, w, mixed)
                stepped = apply_updates(mixed, updates)
                new_params = w_next.copy_(
                    torch.where(active[:, None, None], stepped, w))
                opt_state = tree_map(
                    lambda a, b: torch.where(
                        active.reshape((-1,) + (1,) * (a.dim() - 1)), a, b),
                    opt_state_new, state.opt_state)
                buffer = buf_next.copy_(torch.where(
                    (active | fresh)[:, None, None], new_params, buffer))
            age = torch.where(active | fresh, 0, age + 1).to(torch.int32)
            clock = clock + active.to(torch.int32)
        else:
            raise ValueError(f"the flat engine does not run {algo.algo}")

        # centered two-pass variance on the flat buffer (pads contribute 0)
        gsq = torch.sum(torch.square(g), dim=(1, 2))
        g_mean = torch.mean(g, dim=0)
        dev_w = new_params - torch.mean(new_params, dim=0)
        metrics = StepMetrics(
            loss=torch.mean(losses),
            grad_norm=torch.sqrt(torch.sum(torch.square(g_mean))),
            sigma_w_sq=torch.sum(torch.square(dev_w)) / n,
            staleness_mean=stale_mean,
            staleness_max=stale_max,
            n_active=torch.full((), float(n), device=dev),
            grad_sq_mean=torch.mean(gsq),
        )
        return TrainState(new_params, opt_state, state.step + 1, state.seed,
                          buffer=buffer, age=age, clock=clock), metrics

    # -- multi-step loop -----------------------------------------------------
    def run_steps(self, state: TrainState, stacked_batches, k: int = None,
                  rounds=None):
        """Run the steps of ``stacked_batches`` (leaves (k, n, B_local, ...))
        one after another; ``rounds``, when given, is a list of per-step
        round tables.  Returns (final state, StepMetrics with a leading (k,)
        axis)."""
        lead = tree_leaves(stacked_batches)[0].shape[0]
        if k is not None and lead != k:
            raise ValueError(f"stacked_batches carry {lead} steps, "
                             f"expected k={k}")
        out = []
        for t in range(lead):
            state, m = self.train_step(
                state, tree_map(lambda x: x[t], stacked_batches),
                None if rounds is None else rounds[t])
            out.append(m)
        return state, StepMetrics(*[torch.stack(f) for f in zip(*out)])

    # -- probe seam (DESIGN §10) ----------------------------------------------
    def add_probe(self, name: str, schedule, fn,
                  on_result: Optional[Callable] = None) -> None:
        """Register a scheduled probe: ``schedule.due(step)`` gates it;
        ``fn(state_view, batch) -> result``; the optional
        ``on_result(state, result) -> state`` feeds a controller back into
        the training state."""
        self.hooks.append(ProbeHook(name, schedule, fn, on_result))

    def probes_due(self, step: int) -> bool:
        """True if any registered probe fires at ``step`` (lets the host
        loop skip fetching a probe superbatch on quiet steps)."""
        return any(h.schedule.due(step) for h in self.hooks)

    def run_probes(self, state: TrainState, stacked_batch, step: int = None):
        """Run every due probe; returns (possibly updated state, {name:
        result}).  ``step`` defaults to ``state.step``; pass the step you
        gated on with ``probes_due``.

        Probe fns receive the tree view ``state_view(state)``, rebuilt per
        hook so a later probe sees what an earlier ``on_result`` wrote;
        ``on_result`` receives the real state, so a controller writes the
        live optimizer state.  A probe does not consume the state."""
        step = state.step if step is None else step
        results = {}
        for h in self.hooks:
            if not h.schedule.due(step):
                continue
            r = h.fn(self.state_view(state), stacked_batch)
            results[h.name] = r
            if h.on_result is not None:
                state = h.on_result(state, r)
        return state, results

    # -- diagnostics (paper Fig. 2b / Fig. 4) ---------------------------------
    def diagnostics(self, state: TrainState, stacked_batch) -> DiagStats:
        """The paper's instruments at ``state`` over ``stacked_batch``
        (leaves (n, B_local, ...)): alpha_e at ``alpha_for_diag``, sigma_w^2
        and the Delta split.  ``state`` may be the real state or its
        ``state_view`` (what a probe hook receives)."""
        params = state.params
        if isinstance(params, torch.Tensor):
            params = self._meta.unflatten(params)
        return compute_diagnostics(self.loss_fn, params, stacked_batch,
                                   self.alpha_for_diag, age=state.age,
                                   params_from_tree=self.params_from_tree)

    # -- eval ----------------------------------------------------------------
    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch):
        """Loss of the average model on a (B, ...) batch (held-out metric)."""
        w_a = self._meta.unflatten(torch.mean(state.params, dim=0))
        return self.loss_fn(self._make_params(w_a), batch)
