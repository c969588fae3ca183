"""MultiLearnerTrainer — SSGD / SSGD* / DPSGD / AD-PSGD; the port of
``repro/core/trainer.py``.

Semantics (paper Sec. 2; Lian et al. 2018 for the async variant):
  SSGD   : g_j = grad L^{mu_j}(w_a);          w_a <- w_a + opt(mean_j g_j)
  SSGD*  : g_j = grad L^{mu_j}(w_a + delta_j) with delta_j ~ N(0, sigma0^2 I)
  DPSGD  : g_j = grad L^{mu_j}(w_j);          w_j <- mix(w)_j + opt_j(g_j)
  AD-PSGD: like DPSGD with pairwise gossip, but the partner's contribution is
           its last *published* weights (stale by up to ``max_staleness``
           ticks), and an injected straggler only completes a step every
           ``slow_factor`` ticks.

Two engines (DESIGN §11), routed as the reference routes them:

  * ``engine="flat"`` (the default for DPSGD and AD-PSGD) keeps the stacked
    parameters as ONE persistent (n, T, 128) float32 buffer
    (``core/flatstate.py``), flattened once at init.  Each learner's
    parameters are views into it, bound once at init: every view is its
    own autograd leaf whose ``.grad`` is the matching view of one
    (n, T, 128) grad buffer, so a backward pass adds the gradients straight
    into that buffer (no parameter-sized ``cat``).  A leaf of another
    dtype (bf16) is cast from its row into a persistent leaf of its own
    dtype before each learner's forward, and its gradient written back
    into the float32 grad buffer after the backward.  The gossip +
    momentum-SGD update then runs as the hand-written kernel
    (``kernels/ops``), once per gossip round; ``kernel_backend="ref"``
    runs its plain version instead.
  * ``engine="pytree"`` (the default for SSGD, SSGD* and a
    ``layout_sensitive`` optimizer such as lamb) keeps stacked parameter
    trees (leaves (n, ...)) and runs the unfused tree updates, the paper's
    form.  Its gradients land in a stacked grad tree through the same
    binding, leaf by leaf: each learner's row of every stacked leaf is its
    own autograd leaf whose ``.grad`` is the matching row of the grad tree.

The flat engine keeps two alternating parameter stores, since its kernel
writes out of place: a step reads one and writes the other, and each store
carries its own bound views.  The pytree engine's updates build new trees,
so it keeps one bound store and copies each step's result into it.  Either
way a state is consumed by ``train_step`` — as the reference donates it —
and the trainer holds one live state at a time: ``train_step`` raises on a
state whose parameters are not its store (``state_from_view`` restores a
saved one).  AD-PSGD's published buffer on the flat engine alternates like
its parameters; the momentum is updated in place.

The probe seam (DESIGN §10): ``add_probe`` registers a measurement under
a schedule (``landscape.ProbeSchedule``), ``run_probes`` runs the due ones
between steps — each receives the tree view ``state_view(state)``, and its
optional ``on_result`` receives the real state, so a controller
(``landscape.AutoLRController`` through ``optim.set_controller_scale``)
writes the live optimizer state.  ``diagnostics`` measures the paper's
alpha_e, sigma_w^2 and Delta split (``core/diagnostics.py``).

Elastic membership (DESIGN §15, ``core/membership.py``): ``set_membership``
puts a ``MemberState`` into the state; its tables and masks are device
tensors built there.  Dead learners' rows get the kernel's ``active`` column
0 (selected, never blended: their parameter, momentum and buffer rows stay
bitwise put in whichever store the next step reads), matchings are drawn
over the live slots only (``topology.masked_pair_partners``) and
deterministic topologies run their ``reschedule`` tables, whose live rows
never point at a dead slot.  AD-PSGD gates each learner by its
``slow_every`` divisor.  The metrics average over the live learners only.
With everyone live, an elastic state trains bitwise as a fixed fleet does.

``train_step`` makes no host sync: gossip tables and SSGD*'s noise are
drawn on the device, masks are built there from host integers, and the
metrics stay device tensors.  Nor do ``run_probes`` and ``diagnostics``
(``state.step`` is a host integer); a controller's reads of a probe
result are its own.

# lint: hot-path
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from .. import obs
from ..device import resolve_device
from ..kernels import ops as kops
from ..optim import Optimizer, apply_updates
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import schedule as gsched
from .diagnostics import DiagStats, compute_diagnostics
from . import topology as topo
from .dpsgd import (AlgoConfig, mean_broadcast, member_active_mask,
                    mix_einsum, mix_pair_gather, straggler_active_mask)
from .flatstate import LANE, FlatMeta, flat_meta
from .membership import Membership, MemberState
from .util import (learner_mean, learner_var, masked_learner_mean,
                   masked_learner_var, tree_gaussian_like, tree_norm_sq)

# the SSGD* noise stream's seeds: the matchings' seeds XOR this, so the
# two streams differ at every (seed, step)
_NOISE_STREAM = 0x5DEECE66D2B7E151


class TrainState(NamedTuple):
    params: Any           # flat: (n, T, 128) store; pytree: stacked tree
    opt_state: Any        # stacked per-learner
    step: int             # a host integer: no device read to branch on it
    seed: int             # matchings (and SSGD*'s noise) at step t come
    #                       from (seed, t)
    # -- adpsgd only (None otherwise) --------------------------------------
    buffer: Any = None    # last-published weights, laid out like params
    age: Any = None       # (n,) int32 ticks since each learner published
    clock: Any = None     # (n,) int32 completed local steps per learner
    # -- elastic membership (None = a fixed fleet; DESIGN §15) -------------
    members: Any = None   # MemberState: masks and tables as device tensors


class StepMetrics(NamedTuple):
    loss: torch.Tensor          # mean per-learner minibatch loss (live only)
    grad_norm: torch.Tensor     # ||g_a|| (consensus gradient, live only)
    sigma_w_sq: torch.Tensor    # weight variance across (live) learners
    staleness_mean: torch.Tensor  # mean buffer age seen at gossip (adpsgd)
    staleness_max: torch.Tensor   # max buffer age seen at gossip (adpsgd)
    n_active: torch.Tensor      # live learner count this tick
    grad_sq_mean: torch.Tensor  # mean_i ||g_i||^2 over live learners


class _Bound(NamedTuple):
    """One learner's parameters bound to one store: the object ``loss_fn``
    takes, and per cast leaf (store view, cast leaf, cast grad, grad
    view)."""
    params: Any
    casts: tuple


def _param_leaves(params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return tree_leaves(params)


def _step_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % (2 ** 63)


def _noise_seed(seed: int, step: int) -> int:
    return _step_seed(seed, step) ^ _NOISE_STREAM


def _select(mask, new, old):
    """Per-learner select: leaf[j] = new[j] if mask[j] else old[j]."""
    def _sel(a, b):
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return tree_map(_sel, new, old)


def _copy_tree(dst, src):
    """Write ``src``'s leaves into ``dst``'s (a store) in place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)
    return dst


def cast_leaves(meta: FlatMeta, device) -> dict:
    """Per leaf slot of another dtype than float32 (bf16): a persistent
    autograd leaf of its own dtype and its gradient, what ``bind_learner``
    binds in place of a float32 store view."""
    return {j: (torch.empty(shape, dtype=dt, device=device).requires_grad_(),
                torch.zeros(shape, dtype=dt, device=device))
            for j, (shape, dt) in enumerate(zip(meta.shapes, meta.dtypes))
            if dt != torch.float32}


def bind_learner(meta: FlatMeta, casts, make_params, w_leaves,
                 g_leaves) -> _Bound:
    """The loss_fn's params object for one learner, from its leaves in a
    store (``w_leaves``) and in the grad store (``g_leaves``), in tree
    order.  A leaf in its recorded dtype becomes an autograd leaf sharing
    the store's memory, its ``.grad`` the matching grad leaf; a leaf of
    another dtype (a bf16 leaf of the float32 flat store) is bound through
    the persistent cast leaf and cast grad of its slot (``casts``, from
    ``cast_leaves``), copied in and out around each forward/backward."""
    pw, pg, bound_casts = [], [], []
    for j, (w, g) in enumerate(zip(w_leaves, g_leaves)):
        if w.dtype == meta.dtypes[j]:
            pw.append(w.detach().requires_grad_())
            pg.append(g)
        else:
            cw, cg = casts[j]
            pw.append(cw)
            pg.append(cg)
            bound_casts.append((w, cw, cg, g))
    pw = make_params(tree_unflatten(meta.treedef, pw))
    pg = make_params(tree_unflatten(meta.treedef, pg))
    for a, b in zip(_param_leaves(pw), _param_leaves(pg)):
        a.grad = b.detach()
    return _Bound(pw, tuple(bound_casts))


def backward_into(loss_fn, bound: _Bound, batch) -> torch.Tensor:
    """One learner's forward and backward on ``batch``: its gradient adds
    into the grad leaves ``bound`` was bound to (zero them first), a cast
    leaf's written back after the backward.  Returns the detached loss."""
    with torch.no_grad():
        for src, cw, cg, _ in bound.casts:
            cw.copy_(src)
            cg.zero_()
    with torch.enable_grad():
        loss = loss_fn(bound.params, batch)
        with obs.span("train.backward"):
            loss.backward()
    with torch.no_grad():
        for _, _, cg, dst in bound.casts:
            dst.copy_(cg)
    return loss.detach()


def fused_update(f, w, remote, grads, opt_state, partners, coefs, *, out,
                 active=None, buffer=None, buffer_out=None, nbr_fresh=None,
                 publish=None, weight_decay=None, backend: str = "auto"):
    """One gossip + SGD pass of the fused recipe ``f`` (``FusedSGD``)
    through ``ops.flat_gossip_update``, threading the optimizer state: the
    kernel's coefficient table is ``coefs`` (n, K + 1) with the recipe's lr
    scale and the ``active`` column (and in publish mode the ``nbr_fresh``
    and ``publish`` columns) appended, all device tensors.  Returns
    (w_new, opt_state[, buffer_new])."""
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
        w, remote, grads, f.read_mu(opt_state), partners, table, lr=f.lr,
        beta=f.beta, weight_decay=wd, buffer=buffer, out=out,
        buffer_out=buffer_out, backend=backend)
    opt_state = f.bump(opt_state)
    if res[1] is not None:
        opt_state = f.write_mu(opt_state, res[1])
    if buffer is not None:
        return res[0], opt_state, res[2]
    return res[0], opt_state


def _per_learner_grad_sq(grads) -> torch.Tensor:
    """(n,) float32: ||g_i||^2 per learner, summed leaf by leaf."""
    return sum(torch.sum(torch.square(g.float()),
                         dim=tuple(range(1, g.dim())))
               for g in tree_leaves(grads))


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
    engine: str = "auto"       # auto | flat | pytree (DESIGN §11)
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
        wants_mixed = getattr(opt, "wants_mixed", False)
        if wants_mixed and self.algo.gossip_order != "mix_then_descend":
            raise ValueError("decentlam-style optimizers need the gossip "
                             "average: use gossip_order='mix_then_descend'")
        if (wants_mixed and getattr(opt, "static_mixing_only", False)
                and self._schedule is not None
                and self._schedule.time_varying):
            raise ValueError(
                "this optimizer's correction assumes a STATIC mixing "
                f"matrix, but topology='{self.algo.topology}' compiles to a "
                "time-varying GossipSchedule: the exact DecentLaM drift "
                "diverges under switching matchings (see optim/decentlam.py)."
                " Use drift_scale=1-momentum, a static topology, or "
                "unsafe_switching=True to demonstrate the divergence")
        if self.engine not in ("auto", "flat", "pytree"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.kernel_backend not in kops.BACKENDS:
            raise ValueError(f"kernel_backend must be one of {kops.BACKENDS}"
                             f", got {self.kernel_backend!r}")
        layout_sensitive = getattr(opt, "layout_sensitive", False)
        if self.engine == "auto":
            # the flat fused engine carries the decentralized algorithms;
            # SSGD / SSGD* keep the reference layout (no gossip to fuse;
            # SSGD* draws per-leaf noise), and so does a layout-sensitive
            # optimizer (lamb's layer-wise trust ratio would collapse on
            # the one flat leaf)
            self._flat = (self.algo.algo in ("dpsgd", "adpsgd")
                          and not layout_sensitive)
        else:
            if self.engine == "flat" and self.algo.algo == "ssgd_star":
                raise ValueError("ssgd_star draws per-leaf weight noise; "
                                 "use engine='pytree'")
            if self.engine == "flat" and layout_sensitive:
                raise ValueError(
                    "this optimizer's update depends on the per-leaf "
                    "structure (layout_sensitive=True, e.g. lamb's "
                    "layer-wise trust ratio): the flat engine would change "
                    "its semantics; use engine='pytree'")
            self._flat = self.engine == "flat"
        f = getattr(opt, "fused", None)
        self._fused = None
        if (self._flat and f is not None
                and self.algo.algo in ("dpsgd", "adpsgd")
                and not wants_mixed
                and self.algo.gossip_order == "mix_then_descend"
                and self._schedule is not None):
            self._fused = f
        self._meta: Optional[FlatMeta] = None   # set at init()
        self._casts = {}                        # flat engine: cast_leaves
        self._gen = torch.Generator(device=self.device)
        self._noise_gen = torch.Generator(device=self.device)

    # -- engine helpers -------------------------------------------------------
    @property
    def is_flat(self) -> bool:
        return self._flat

    @property
    def is_fused(self) -> bool:
        """True if the gossip + update runs as the flat engine's kernel."""
        return self._fused is not None

    @property
    def rounds_per_step(self) -> int:
        """Gossip passes per step (0 for ssgd, ssgd_star and solo)."""
        if self.algo.algo in ("ssgd", "ssgd_star") or self._schedule is None:
            return 0
        return self._schedule.rounds_per_step

    def _make_params(self, tree):
        return tree if self.params_from_tree is None else \
            self.params_from_tree(tree)

    def _bind(self, w_leaves, g_leaves) -> _Bound:
        """One learner's binding (``bind_learner``) to a store's leaves."""
        return bind_learner(self._meta, self._casts, self._make_params,
                            w_leaves, g_leaves)

    def _bind_all(self, store) -> List[_Bound]:
        """Every learner's binding to ``store`` (flat or stacked tree)."""
        if self._flat:
            gs = self._meta.views(self._g)
            ws = self._meta.views(store)
        else:
            gs, ws = tree_leaves(self._g), tree_leaves(store)
        return [self._bind([x[i] for x in ws], [x[i] for x in gs])
                for i in range(self.algo.n_learners)]

    def _bound(self, w):
        """The bindings of the store ``w`` (one of ``self._w``)."""
        for s, views in zip(self._w, self._views):
            if w is s:
                return views
        raise ValueError(
            "the state's parameters are not this trainer's live store: "
            "train the state train_step returned, or restore a saved one "
            "with state_from_view")

    def _other(self, t, pair):
        return pair[1] if t is pair[0] else pair[0]

    def params_tree(self, state_or_params):
        """The stacked parameter tree of a state (leaves (n, ...)): views of
        a flat store, or the pytree engine's tree itself."""
        p = (state_or_params.params if isinstance(state_or_params, TrainState)
             else state_or_params)
        if self._flat and isinstance(p, torch.Tensor):
            return self._meta.unflatten(p)
        return p

    def _is_store_leaf(self, x) -> bool:
        return (isinstance(x, torch.Tensor) and x.dim() >= 2
                and tuple(x.shape[-2:]) == (self._meta.rows, LANE))

    def state_view(self, state: TrainState) -> TrainState:
        """Tree-layout view of a state.  A flat state's parameters, buffer
        and (n, T, 128) optimizer leaves (momentum) come back as stacked
        trees of views; other optimizer leaves pass through.  A pytree
        state comes back unchanged."""
        if not self._flat:
            return state
        meta = self._meta
        return state._replace(
            params=meta.unflatten(state.params),
            buffer=(None if state.buffer is None
                    else meta.unflatten(state.buffer)),
            opt_state=tree_map(
                lambda x: meta.unflatten(x) if self._is_store_leaf(x) else x,
                state.opt_state))

    def state_from_view(self, view: TrainState) -> TrainState:
        """Inverse of ``state_view``: re-flatten a tree-layout state (e.g. a
        checkpoint saved as ``state_view(state)``).  Its parameters and
        buffer are written into this trainer's live stores, and every
        optimizer subtree with the parameters' structure (momentum) is
        flattened into a (n, T, 128) buffer; everything else passes
        through.  A pytree trainer copies the parameters into its store
        and passes the rest through."""
        if not self._flat:
            return view._replace(params=_copy_tree(self._w[0], view.params))
        meta, dev = self._meta, self.device

        def reflatten(x):
            if (not isinstance(x, torch.Tensor)
                    and tree_flatten(x)[1] == meta.treedef):
                return meta.flatten(x, device=dev)
            if isinstance(x, dict):
                return {k: reflatten(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(reflatten(v) for v in x)
            return x

        params = self._w[0].copy_(meta.flatten(view.params, device=dev))
        buffer = None
        if view.buffer is not None:
            buffer = self._buf[0].copy_(meta.flatten(view.buffer,
                                                     device=dev))
        return view._replace(params=params, buffer=buffer,
                             opt_state=reflatten(view.opt_state))

    # -- init -----------------------------------------------------------------
    def init(self, seed: int, params_single) -> TrainState:
        """``params_single``: one learner's parameter tree in the
        reference's layout (e.g. ``fcnet.init_params`` or
        ``api.param_tree(api.init(seed))``).  Every learner starts from it.
        The flat engine stores every leaf as float32 (bf16 leaves are cast
        on the way in and out of each forward/backward); the pytree engine
        keeps each leaf's dtype."""
        n = self.algo.n_learners
        dev = self.device
        meta = self._meta = flat_meta(params_single)
        if self._flat:
            self._casts = cast_leaves(meta, dev)
            one = meta.flatten(params_single, device=dev)
            shape = (n, meta.rows, LANE)
            self._w = [torch.empty(shape, device=dev) for _ in range(2)]
            self._w[0].copy_(one.expand(shape))
            del one
            self._g = torch.zeros(shape, device=dev)
            self._wa, self._views_wa = None, None
            if self.algo.algo == "ssgd":
                self._wa = torch.empty(shape[1:], device=dev)
                wa, gs = meta.views(self._wa), meta.views(self._g)
                self._views_wa = [self._bind(wa, [x[i] for x in gs])
                                  for i in range(n)]
        else:
            def stacked():
                return tree_map(lambda p: torch.empty(
                    (n,) + tuple(p.shape), dtype=p.dtype, device=dev),
                    params_single)
            self._w = [stacked()]
            _copy_tree(self._w[0], tree_map(
                lambda p: p.to(dev)[None].expand((n,) + tuple(p.shape)),
                params_single))
            self._g = tree_map(torch.zeros_like, self._w[0])
        self._views = [self._bind_all(w) for w in self._w]
        opt_state = self.optimizer.init(self._w[0])
        buffer = age = clock = None
        if self.algo.algo == "adpsgd":
            if self._flat:
                self._buf = [self._w[0].clone(), torch.empty_like(self._w[0])]
                buffer = self._buf[0]
            else:
                buffer = tree_map(torch.clone, self._w[0])
            age = torch.zeros((n,), dtype=torch.int32, device=dev)
            clock = torch.zeros((n,), dtype=torch.int32, device=dev)
        return TrainState(self._w[0], opt_state, 0, seed, buffer=buffer,
                          age=age, clock=clock)

    # -- optimizer pieces -----------------------------------------------------
    def _opt_update(self, grads, opt_state, params, mixed):
        if getattr(self.optimizer, "wants_mixed", False):
            return self.optimizer.update(grads, opt_state, params, mixed)
        return self.optimizer.update(grads, opt_state, params)

    def _fused_step(self, w, remote, grads, opt_state, partners, coefs,
                    **kw):
        """``fused_update`` with this trainer's recipe and backend."""
        return fused_update(self._fused, w, remote, grads, opt_state,
                            partners, coefs, backend=self.kernel_backend,
                            **kw)

    def _select_nonflat(self, mask, new, old):
        """Per-learner select on the small optimizer leaves (schedule
        counters, scales); (n, T, 128) leaves were selected in the kernel."""
        def _sel(a, b):
            if self._is_store_leaf(a):
                return a
            m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        return tree_map(_sel, new, old)

    def _mix_sched(self, stacked, rounds, step: int):
        """Schedule-driven gossip for the unfused paths (a flat store or a
        stacked tree): matchings as gathers, deterministic schedules as
        the step's matrix."""
        s = self._schedule
        if s is None:
            return stacked
        if s.randomized:
            out = stacked
            for partners, _ in rounds:
                out = mix_pair_gather(out, partners[0])
            return out
        return mix_einsum(stacked, s.step_matrix(None, step,
                                                 device=self.device))

    def _rounds(self, state: TrainState, rounds):
        if self.rounds_per_step == 0:
            return []
        if rounds is None:
            self._gen.manual_seed(_step_seed(state.seed, state.step))
            return self._schedule.step_rounds(self._gen, state.step,
                                              device=self.device)
        return [(torch.as_tensor(p, dtype=torch.int32, device=self.device),
                 torch.as_tensor(c, dtype=torch.float32, device=self.device))
                for p, c in rounds]

    # -- elastic membership (DESIGN §15) --------------------------------------
    def membership_state(self, membership: Membership, *,
                         drop_round: bool = False) -> MemberState:
        """The device bundle of ``membership`` for this trainer's topology:
        a deterministic DPSGD schedule embeds its ``reschedule`` tables;
        randomized matchings and AD-PSGD draw from the mask at each
        step."""
        topo_name = None
        if (self.algo.algo == "dpsgd" and self._schedule is not None
                and not self._schedule.randomized):
            topo_name = self.algo.topology
        return membership.member_state(
            topo_name, gossip_rounds=self.algo.gossip_rounds,
            drop_round=drop_round, device=self.device)

    def set_membership(self, state: TrainState, membership: Membership, *,
                       drop_round: bool = False) -> TrainState:
        """``state`` with ``membership`` swapped in (its tables and masks
        built on the device here, once, never in the step).  Raises
        ``ValueError`` for a centralized algorithm, for an optimizer that
        corrects for a static mixing matrix (decentlam) and for a fleet of
        another capacity."""
        if self.algo.algo not in ("dpsgd", "adpsgd"):
            raise ValueError("elastic membership rides the decentralized "
                             f"paths, not {self.algo.algo}")
        if getattr(self.optimizer, "wants_mixed", False):
            raise ValueError(
                "a mixing-matrix-corrected optimizer (decentlam) assumes a "
                "static fleet: its drift term diverges when membership "
                "changes the realized matrix; use plain (momentum-)SGD")
        if membership.capacity != self.algo.n_learners:
            raise ValueError(
                f"membership capacity {membership.capacity} != "
                f"n_learners {self.algo.n_learners}")
        return state._replace(members=self.membership_state(
            membership, drop_round=drop_round))

    def _member_rounds(self, mem: MemberState, state: TrainState):
        """The elastic form of ``_rounds``: this step's per-round
        (partners (K, n) int32, coefs (n, K + 1) float32) tables from the
        membership's device tensors.  Randomized matchings are drawn over
        the live slots from the step's generator (consumed as the fixed
        fleet's draw consumes it); deterministic tables come from the
        ``reschedule`` operand, ``one_peer_exp`` one round of its cycle a
        step.  A dropped round gets identity coefficients."""
        if self.rounds_per_step == 0:
            return []
        n = self.algo.n_learners
        dev = self.device
        if mem.partners is None:            # only-active matchings
            rps = (max(1, self.algo.gossip_rounds)
                   if self.algo.topology == "random_matching" else 1)
            self._gen.manual_seed(_step_seed(state.seed, state.step))
            idx = torch.arange(n, device=dev)
            out = []
            for _ in range(rps):
                partner = topo.masked_pair_partners(self._gen, mem.active,
                                                    drop=mem.drop_round)
                self_c = torch.where(partner == idx, 1.0, 0.5).to(
                    torch.float32)
                out.append((partner[None].to(torch.int32),
                             torch.stack([self_c, 1.0 - self_c], dim=1)))
            return out
        period, K = mem.partners.shape[0], mem.partners.shape[1]
        # the rounds a step runs follow from the operand's shape: the whole
        # cycle, or one round of it for one_peer_exp
        rps = 1 if self.algo.topology == "one_peer_exp" else period
        id_c = torch.cat([torch.ones((n, 1), device=dev),
                          torch.zeros((n, K), device=dev)], dim=1)
        out = []
        for j in range(rps):
            r = j % period if rps % period == 0 else \
                (state.step * rps + j) % period
            out.append((mem.partners[r],
                        torch.where(mem.drop_round, id_c, mem.coefs[r])))
        return out

    def _mix_member_rounds(self, stacked, rounds, active):
        """Unfused elastic mixing of a stacked tree or a flat store.
        Matchings keep the pair-gather form (solo rows, every inactive one
        among them, bitwise untouched); deterministic rounds realize each
        round's matrix, with the quarantined rows zeroed before the einsum
        and restored after, so a non-finite parked row cannot bleed through
        its 0-weight column (0 * NaN is NaN in a product, not in a
        where)."""
        out = stacked
        randomized = self._schedule is not None and self._schedule.randomized
        for partners, coefs in rounds:
            if randomized:      # drop and solo already in the partners
                out = mix_pair_gather(out, partners[0])
                continue
            n = partners.shape[1]
            ar = torch.arange(n, device=partners.device)
            m = torch.zeros((n, n), dtype=torch.float32,
                            device=partners.device)
            m.index_put_((ar, ar), coefs[:, 0], accumulate=True)
            for k in range(partners.shape[0]):
                m.index_put_((ar, partners[k].long()), coefs[:, 1 + k],
                             accumulate=True)
            safe = _select(active, out, tree_map(torch.zeros_like, out))
            out = _select(active, mix_einsum(safe, m), out)
        return out

    def _member_update(self, w, g, opt_state, rounds, active):
        """The unfused elastic DPSGD update of either engine: (new
        weights, new optimizer state), the dead learners' rows of both
        kept bitwise."""
        if self.algo.gossip_order == "mix_then_descend":
            mixed = self._mix_member_rounds(w, rounds, active)
            updates, opt_new = self._opt_update(g, opt_state, w, mixed)
            stepped = apply_updates(mixed, updates)
        else:                                           # descend_then_mix
            updates, opt_new = self._opt_update(g, opt_state, w, w)
            stepped = self._mix_member_rounds(apply_updates(w, updates),
                                              rounds, active)
        return (_select(active, stepped, w),
                _select(active, opt_new, opt_state))

    def _noise(self, state: TrainState, like, noise):
        """SSGD*'s weight noise for this step, laid out like ``like``
        (stacked): ``noise`` when given (a stacked tree, e.g. the
        reference's draw), else N(0, noise_std^2) drawn on the device from
        the noise stream of (seed, step)."""
        if noise is not None:
            return tree_map(lambda x, d: d.to(device=self.device,
                                              dtype=x.dtype), like, noise)
        self._noise_gen.manual_seed(_noise_seed(state.seed, state.step))
        return tree_gaussian_like(self._noise_gen, like, self.algo.noise_std)

    def _async_masks(self, state: TrainState):
        """AD-PSGD's (active, fresh, stale_seen) for this tick: who
        completes a local step (the injected straggler's law, or each
        member's ``slow_every`` divisor and liveness), who is forced to
        publish at the staleness bound, and the buffer ages gossip reads.
        A dead learner neither steps nor publishes its quarantined rows."""
        algo, mem, age = self.algo, state.members, state.age
        if mem is None:
            active = straggler_active_mask(
                state.step, algo.n_learners, algo.slow_learner,
                algo.slow_factor, device=self.device)
            fresh = age >= algo.max_staleness
            return active, fresh, torch.where(fresh, 0, age)
        active = member_active_mask(state.step, mem.active, mem.slow_every)
        fresh = (age >= algo.max_staleness) & mem.active
        return active, fresh, torch.where(fresh | ~mem.active, 0, age)

    def _grads(self, bound, batch) -> torch.Tensor:
        """Forward + backward per learner, one at a time; gradients land in
        the grad store through the bound views (``backward_into``).
        Returns the (n,) losses."""
        with obs.span("train.grads"):
            for g in tree_leaves(self._g):
                g.zero_()
            return torch.stack([backward_into(self.loss_fn, b,
                                              tree_map(lambda x: x[i], batch))
                                for i, b in enumerate(bound)])

    # -- one training step ----------------------------------------------------
    def train_step(self, state: TrainState, stacked_batch, rounds=None,
                   noise=None):
        """stacked_batch leaves: (n, B_local, ...).  ``rounds``: optional
        per-round ``(partners (K, n) int32, coefs (n, K + 1) float32)``
        tables that replace the schedule's draw for this step; ``noise``:
        optional SSGD* weight noise (a stacked tree of tensors) that
        replaces the draw (the parity tests inject the reference's).
        Returns (new state, StepMetrics).  A state with ``members`` trains
        the elastic fleet; injected ``rounds`` then replace its draw (or
        its tables) too."""
        with obs.span("train.step"):
            self._bound(state.params)       # raises on a state not its own
            if rounds is None and state.members is not None:
                rounds = self._member_rounds(state.members, state)
            else:
                rounds = self._rounds(state, rounds)
            if self._flat:
                return self._train_step_flat(state, stacked_batch, rounds)
            return self._train_step_tree(state, stacked_batch, rounds, noise)

    def _train_step_tree(self, state: TrainState, stacked_batch, rounds,
                         noise):
        """The pytree engine: stacked trees and unfused tree updates (the
        reference's ``_train_step_tree``)."""
        algo = self.algo
        n = algo.n_learners
        dev = self.device
        zero = torch.zeros((), device=dev)
        stale_mean, stale_max = zero, zero
        buffer, age, clock = state.buffer, state.age, state.clock
        w = state.params
        bound = self._bound(w)
        g = self._g
        mem = state.members

        def stack(tree):
            return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)),
                            tree)

        if algo.algo in ("ssgd", "ssgd_star"):
            # every learner's gradient at w_a (SSGD*: at w_a + delta_j),
            # taken at that point written into the store; the update then
            # applies to w_a (every learner of an SSGD state holds it)
            w_a = learner_mean(w)
            if algo.algo == "ssgd_star":
                for s, m, d in zip(tree_leaves(w), tree_leaves(w_a),
                                   tree_leaves(self._noise(state, w, noise))):
                    torch.add(m, d, out=s)
            else:
                _copy_tree(w, stack(w_a))
            losses = self._grads(bound, stacked_batch)
            with obs.span("train.update"):
                w_b = stack(w_a)
                updates, opt_state = self._opt_update(
                    stack(learner_mean(g)), state.opt_state, w_b, w_b)
                new_params = mean_broadcast(apply_updates(w_b, updates))

        elif algo.algo == "dpsgd" and mem is not None:  # elastic fleet
            losses = self._grads(bound, stacked_batch)
            with obs.span("train.update"):
                new_params, opt_state = self._member_update(
                    w, g, state.opt_state, rounds, mem.active)

        elif algo.algo == "dpsgd":
            losses = self._grads(bound, stacked_batch)
            with obs.span("train.update"):
                if algo.gossip_order == "mix_then_descend":
                    mixed = self._mix_sched(w, rounds, state.step)
                    updates, opt_state = self._opt_update(
                        g, state.opt_state, w, mixed)
                    new_params = apply_updates(mixed, updates)
                else:                                       # descend_then_mix
                    updates, opt_state = self._opt_update(
                        g, state.opt_state, w, w)
                    new_params = self._mix_sched(apply_updates(w, updates),
                                                 rounds, state.step)

        else:                                           # adpsgd
            active, fresh, stale_seen = self._async_masks(state)
            stale_mean = torch.mean(stale_seen.to(torch.float32))
            stale_max = torch.max(stale_seen).to(torch.float32)
            (partners, _), = rounds
            losses = self._grads(bound, stacked_batch)
            with obs.span("train.update"):
                mixed = mix_pair_gather(w, partners[0],
                                        _select(fresh, w, buffer))
                updates, opt_state_new = self._opt_update(
                    g, state.opt_state, w, mixed)
                new_params = _select(active, apply_updates(mixed, updates), w)
                opt_state = _select(active, opt_state_new, state.opt_state)
                buffer = _select(active | fresh, new_params, buffer)
                age = torch.where(active | fresh, 0, age + 1).to(torch.int32)
                clock = clock + active.to(torch.int32)

        new_params = _copy_tree(w, new_params)
        with obs.span("train.stats"):
            gsq = _per_learner_grad_sq(g)
            if mem is None:
                nact = torch.full((), float(n), device=dev)
                loss, gsq_mean = torch.mean(losses), torch.mean(gsq)
                g_mean, sigma = learner_mean(g), learner_var(new_params)
            else:       # live-only statistics: quarantined rows are excluded
                act = mem.active
                nact = torch.clamp(torch.sum(act), min=1).to(torch.float32)
                loss = torch.sum(torch.where(act, losses, 0.0)) / nact
                gsq_mean = torch.sum(torch.where(act, gsq, 0.0)) / nact
                g_mean = masked_learner_mean(g, act)
                sigma = masked_learner_var(new_params, act)
            metrics = StepMetrics(
                loss=loss,
                grad_norm=torch.sqrt(tree_norm_sq(g_mean)),
                sigma_w_sq=sigma,
                staleness_mean=stale_mean,
                staleness_max=stale_max,
                n_active=nact,
                grad_sq_mean=gsq_mean,
            )
        return TrainState(new_params, opt_state, state.step + 1, state.seed,
                          buffer=buffer, age=age, clock=clock,
                          members=mem), metrics

    def _train_step_flat(self, state: TrainState, stacked_batch, rounds):
        """The flat engine: the same algorithms on the (n, T, 128) store,
        the gossip + update as the fused kernel where the optimizer allows
        it."""
        algo = self.algo
        n = algo.n_learners
        dev = self.device
        zero = torch.zeros((), device=dev)
        stale_mean, stale_max = zero, zero
        buffer, age, clock = state.buffer, state.age, state.clock
        w = state.params
        w_next = self._other(w, self._w)
        g = self._g
        mem = state.members

        if algo.algo == "ssgd":
            torch.mean(w, dim=0, out=self._wa)
            losses = self._grads(self._views_wa, stacked_batch)
            with obs.span("train.update"):
                g_stacked = torch.mean(g, dim=0)[None].expand(w.shape)
                updates, opt_state = self._opt_update(
                    g_stacked, state.opt_state, w, w)
                new_params = w_next.copy_(mean_broadcast(
                    apply_updates(w, updates)))

        elif algo.algo == "dpsgd":
            losses = self._grads(self._bound(w), stacked_batch)
            with obs.span("train.update"):
                if self._fused is not None:
                    # leading rounds mix only; the last fuses the update.  An
                    # elastic fleet's dead rows get the kernel's active column
                    # 0: copied into each output, so whichever store the next
                    # step reads holds them unchanged
                    act = None if mem is None else mem.active
                    g_upd, wd = g, None
                    if len(rounds) > 1 and self._fused.weight_decay:
                        # decay the PRE-mix local weights, as the reference
                        # does
                        g_upd = g + self._fused.weight_decay * w
                        wd = 0.0
                    cur = w
                    for partners, coefs in rounds[:-1]:
                        cur = kops.flat_gossip_mix(
                            cur, partners, coefs, active=act,
                            out=self._other(cur, self._w),
                            backend=self.kernel_backend)
                    partners, coefs = rounds[-1]
                    new_params, opt_state = self._fused_step(
                        cur, cur, g_upd, state.opt_state, partners, coefs,
                        out=self._other(cur, self._w), active=act,
                        weight_decay=wd)
                    if mem is not None:
                        opt_state = self._select_nonflat(act, opt_state,
                                                         state.opt_state)
                elif mem is not None:                       # elastic, unfused
                    stepped, opt_state = self._member_update(
                        w, g, state.opt_state, rounds, mem.active)
                    new_params = w_next.copy_(stepped)
                elif algo.gossip_order == "mix_then_descend":
                    mixed = self._mix_sched(w, rounds, state.step)
                    updates, opt_state = self._opt_update(
                        g, state.opt_state, w, mixed)
                    new_params = w_next.copy_(apply_updates(mixed, updates))
                else:                                       # descend_then_mix
                    updates, opt_state = self._opt_update(
                        g, state.opt_state, w, w)
                    new_params = w_next.copy_(self._mix_sched(
                        apply_updates(w, updates), rounds, state.step))

        else:                                           # adpsgd
            active, fresh, stale_seen = self._async_masks(state)
            stale_mean = torch.mean(stale_seen.to(torch.float32))
            stale_max = torch.max(stale_seen).to(torch.float32)
            losses = self._grads(self._bound(w), stacked_batch)
            with obs.span("train.update"):
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
                    opt_state = _select(active, opt_state_new, state.opt_state)
                    buffer = buf_next.copy_(torch.where(
                        (active | fresh)[:, None, None], new_params, buffer))
                age = torch.where(active | fresh, 0, age + 1).to(torch.int32)
                clock = clock + active.to(torch.int32)

        # centered two-pass variance on the flat buffer (pads contribute 0)
        with obs.span("train.stats"):
            gsq = torch.sum(torch.square(g), dim=(1, 2))
            if mem is None:
                nact = torch.full((), float(n), device=dev)
                loss, gsq_mean = torch.mean(losses), torch.mean(gsq)
                g_mean = torch.mean(g, dim=0)
                dev_w = new_params - torch.mean(new_params, dim=0)
                sigma = torch.sum(torch.square(dev_w)) / n
            else:       # live-only statistics: quarantined rows are excluded
                act = mem.active
                m3 = act[:, None, None]
                nact = torch.clamp(torch.sum(act), min=1).to(torch.float32)
                loss = torch.sum(torch.where(act, losses, 0.0)) / nact
                gsq_mean = torch.sum(torch.where(act, gsq, 0.0)) / nact
                g_mean = torch.sum(torch.where(m3, g, 0.0), dim=0) / nact
                w_mean = torch.sum(torch.where(m3, new_params, 0.0),
                                   dim=0) / nact
                dev_w = torch.where(m3, new_params - w_mean[None], 0.0)
                sigma = torch.sum(torch.square(dev_w)) / nact
            metrics = StepMetrics(
                loss=loss,
                grad_norm=torch.sqrt(torch.sum(torch.square(g_mean))),
                sigma_w_sq=sigma,
                staleness_mean=stale_mean,
                staleness_max=stale_max,
                n_active=nact,
                grad_sq_mean=gsq_mean,
            )
        return TrainState(new_params, opt_state, state.step + 1, state.seed,
                          buffer=buffer, age=age, clock=clock,
                          members=mem), metrics

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
        return compute_diagnostics(self.loss_fn, self.params_tree(state),
                                   stacked_batch,
                                   self.alpha_for_diag, age=state.age,
                                   params_from_tree=self.params_from_tree)

    # -- eval ----------------------------------------------------------------
    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch):
        """Loss of the average model on a (B, ...) batch (held-out metric)."""
        if self._flat:
            w_a = self._meta.unflatten(torch.mean(state.params, dim=0))
        else:
            w_a = learner_mean(state.params)
        return self.loss_fn(self._make_params(w_a), batch)
