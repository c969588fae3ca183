"""Shared harness for the port's paper benchmarks — the twin of
``benchmarks/common.py`` (``train_fc``, ``final_loss``)."""
from __future__ import annotations

import math
import time

import torch

from ..core import AlgoConfig, Membership, MultiLearnerTrainer, Supervisor
from ..data import ShardedLoader, TemplateImages
from ..device import resolve_device
from ..landscape import AutoLRController, ProbeSchedule, make_trainer_probe
from ..models import fcnet
from ..optim import scale_by_controller, set_controller_scale, sgd

PROBE_BATCH_OFFSET = 50_000    # probe superbatches: loader steps 50,000 + i


def train_fc(algo: str, lr: float, *, n: int = 5, local_batch: int = 400,
             steps: int = 150, seed: int = 0, noise_std: float = 0.01,
             topology: str = "random_pair", diag_every: int = 0,
             landscape_every: int = 0, autolr=None, probe_kwargs=None,
             dataset=None, optimizer=None, algo_kwargs=None,
             engine: str = "auto", fault_plan=None, device=None,
             kernel_backend: str = "auto"):
    """Train the paper's FC net; returns dict(losses, diags, probes,
    scales, us_per_step, trainer, state, loader, staleness_max,
    controller, supervisor); ``scales`` holds the controller's (step,
    multiplier) pairs.

    Probes ride the trainer's hook seam: ``diag_every`` runs the paper's
    diagnostics, ``landscape_every`` the curvature probe (``probe_kwargs``
    go to ``make_trainer_probe``, e.g. ``reorth="ref"``); results land in
    ``diags`` / ``probes`` as (step, result) pairs.  ``algo="ssgd_autolr"``
    runs SSGD with the optimizer wrapped in ``scale_by_controller`` and an
    ``AutoLRController`` closing the loop at ``landscape_every`` cadence
    (default every 10 steps).  ``device`` is where everything runs (cuda
    unless told otherwise), ``kernel_backend`` the trainer's kernel
    dispatch.  Losses are read from the device once, at the end.

    ``fault_plan`` (a ``core.FaultPlan``) trains an elastic fleet under a
    ``Supervisor`` with the plan: the membership is set before the first
    step and the supervisor ticks before every step, the warm-up
    included."""
    dev = resolve_device(device)
    ds = dataset or TemplateImages()
    loader = ShardedLoader(ds, n_learners=n, local_batch=local_batch,
                           seed=seed, device=dev)
    params = fcnet.init_params(torch.Generator(device=dev).manual_seed(seed),
                               in_dim=784, hidden=50)

    controller = None
    opt = optimizer or sgd(lr)
    if algo == "ssgd_autolr":
        algo = "ssgd"
        opt = scale_by_controller(opt)
        controller = autolr or AutoLRController(alpha0=lr)
        landscape_every = landscape_every or 10

    tr = MultiLearnerTrainer(
        fcnet.loss_fn, opt,
        AlgoConfig(algo=algo, topology=topology, n_learners=n,
                   noise_std=noise_std, **(algo_kwargs or {})),
        alpha_for_diag=lr, engine=engine, kernel_backend=kernel_backend,
        device=dev)

    diags, probes, scales = [], [], []
    if diag_every:
        tr.add_probe(
            "diag", ProbeSchedule(every=diag_every, start=diag_every),
            lambda st, b: tr.diagnostics(st, b),
            on_result=lambda st, d: (diags.append((st.step, d)), st)[1])
    if landscape_every:
        probe_fn = make_trainer_probe(fcnet.loss_fn, alpha=lr,
                                      **(probe_kwargs or {}))

        def on_probe(st, r):
            probes.append((st.step, r))
            if controller is not None:
                scale = controller.update(r)
                scales.append((st.step, scale))
                st = st._replace(opt_state=set_controller_scale(
                    st.opt_state, scale))
            return st
        tr.add_probe("landscape", ProbeSchedule(every=landscape_every),
                     probe_fn, on_result=on_probe)

    st = tr.init(seed, params)
    supervisor = None
    if fault_plan is not None:
        supervisor = Supervisor(tr, Membership(n), fault_plan)
        st = tr.set_membership(st, supervisor.membership)
    if tr.probes_due(0):   # let a controller engage before the first step
        st, _ = tr.run_probes(st, loader.batch(PROBE_BATCH_OFFSET), step=0)
    if supervisor is not None:
        st = supervisor.tick(st, 0)
    st, m = tr.train_step(st, loader.batch(0))    # warm-up, not timed
    losses, stale = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(1, steps):
        if tr.probes_due(i):
            t_probe = time.perf_counter()
            st, _ = tr.run_probes(st, loader.batch(PROBE_BATCH_OFFSET + i),
                                  step=i)
            _sync(dev)
            t0 += time.perf_counter() - t_probe   # keep step timing clean
        if supervisor is not None:
            st = supervisor.tick(st, i)
        st, m = tr.train_step(st, loader.batch(i))
        losses.append(m.loss)
        stale.append(m.staleness_max)
    losses = torch.stack(losses).tolist() if losses else []
    stale_max = max(torch.stack(stale).tolist()) if stale else 0.0
    dt = (time.perf_counter() - t0) / max(steps - 1, 1)
    return {"losses": losses, "diags": diags, "probes": probes,
            "scales": scales, "us_per_step": dt * 1e6, "trainer": tr,
            "state": st, "loader": loader, "staleness_max": stale_max,
            "controller": controller, "supervisor": supervisor}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def final_loss(losses, k: int = 10) -> float:
    tail = [x for x in losses[-k:] if math.isfinite(x)]
    return sum(tail) / len(tail) if tail else float("nan")
