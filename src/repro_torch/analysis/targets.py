"""The port's audit targets: trainer, launch step, serve decode (DESIGN §16),
the twin of ``repro/analysis/targets.py``.

Each ``audit_*`` function builds the smallest real instance of one hot
path — the fixtures the reference's audit builds — then runs every
applicable traced rule and the trace sentinel against it and returns the
findings.  The bounds come from the live objects (the parameter store's
size, the cache pools' bytes, the schedule's live slots), never from
frozen constants.  Every target takes ``device``: the card unless the
caller passes ``device="cpu"``.

The pieces a caller can point at its own step (``chip_smoke.py`` audits
transformer-100m at full width with them): ``audit_train_step`` for a
``MultiLearnerTrainer``, ``audit_launch_step`` for a rank's launch step
inside an initialized process group, ``audit_serve_engine`` for a
``ServeEngine``.  Each warms its step with one untraced call (it fills
lazily made device tables and buffers), then traces the calls it audits
and, on the card, runs them under ``torch.cuda.set_sync_debug_mode("error")``
— but a launch step on a ``gloo`` group with CUDA tensors, whose
exchange syncs the stream by design (``core/dpsgd.HostStaging``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .report import Finding
from .retrace import TraceSentinel, trace_count, watch
from .trace_audit import (StepTrace, aliased_param_bytes, collective_count,
                          count_op, donation_honored, fresh_outputs,
                          max_concat_elems, no_host_callback,
                          no_param_concat, storage_ptrs, wire_dtype)

__all__ = ["live_slots", "rank_sends", "audit_train_step", "audit_trainer",
           "audit_launch_step", "audit_launch", "audit_serve_engine",
           "audit_serve", "audit_all"]

SCALE_WRITE = 0.5           # the controller scale the trainer window writes
LAUNCH_TIMEOUT_S = 600.0    # the launch audit's wait for its ranks


def _bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def live_slots(schedule) -> int:
    """Non-padded neighbor slots across a compiled schedule's period — the
    exact collective budget (one permute per slot, leaf count does not
    multiply it): the reference's ``targets.live_slots``."""
    n = schedule.n
    idx = np.arange(n)
    return int(sum(
        0 if ((schedule.partners[r, k] == idx).all()
              and not schedule.coefs[r][:, 1 + k].any()) else 1
        for r in range(schedule.period) for k in range(schedule.K)))


def rank_sends(tables, rank: int) -> int:
    """The point-to-point sends ``rank`` takes part in over a step's round
    tables (``[(partners (K, n), coefs (n, K + 1))]``, host arrays): in
    each live slot, one send to every other rank that reads its row."""
    out = 0
    for partners, coefs in tables:
        p = np.asarray(partners)
        c = np.asarray(coefs)
        idx = np.arange(p.shape[1])
        for k in range(p.shape[0]):
            if (p[k] == idx).all() and not c[:, 1 + k].any():
                continue                              # a padded slot
            out += int(((p[k] == rank) & (idx != rank)).sum())
    return out


def _describe(report: Optional[dict], trace, state, owned, **extra) -> None:
    """What a caller prints of an audited step: its op count, the kernels
    it launched, its largest concatenate, the state bytes it wrote in
    place, its host reads and its fresh state-sized outputs (``fresh``:
    count, bytes, by op; temporaries included)."""
    if report is None:
        return
    report.update(
        ops=len(trace.ops), launches=dict(trace.launches),
        max_concat_elems=max_concat_elems(trace),
        aliased_bytes=aliased_param_bytes(state, owned),
        state_bytes=_bytes(state),
        host_reads=sum(o.host_read for o in trace.ops),
        fresh=fresh_outputs(trace), **extra)


def _stores(state) -> List[torch.Tensor]:
    """A training state's model-sized tensors: its parameter store, the
    optimizer leaves of the store's shape (momentum) and AD-PSGD's
    published buffer."""
    shape = state.params.shape
    out = [state.params] + [x for x in tree_leaves(state.opt_state)
                            if isinstance(x, torch.Tensor)
                            and x.shape == shape]
    if getattr(state, "buffer", None) is not None:
        out.append(state.buffer)
    return out


# ---------------------------------------------------------------------------
# the trainer (the research path)
# ---------------------------------------------------------------------------

def audit_train_step(trainer, state, batches: Sequence, *, bound: int,
                     target: str = "trainer.train_step",
                     report: Optional[dict] = None) -> List[Finding]:
    """Audit ``trainer.train_step`` and ``run_steps`` from ``state`` (a
    state with ``members``, so the membership swap is a table swap) over
    seven stacked ``batches``: a warm step, one traced step (no
    concatenate of ``bound`` elements, no host read, the parameter and
    momentum stores written in place), ``run_steps`` over two, and a
    sentinel window of three steps around a controller scale write
    (``SCALE_WRITE``; the optimizer must be wrapped by
    ``scale_by_controller``) and a ``Membership`` that lost the last
    learner.
    ``report`` (a dict) receives what the traced step showed."""
    from ..core import Membership
    from ..optim import set_controller_scale

    if len(batches) < 7:
        raise ValueError(f"audit_train_step takes 7 batches, got "
                         f"{len(batches)}")
    dev = trainer.device
    owned = storage_ptrs(_stores(state))
    st, _ = trainer.train_step(state, batches[0])
    owned |= storage_ptrs(_stores(st))
    step = watch(trainer.train_step, dev, label=target,
                 watch_bytes=_bytes([st.params]))
    step.sync_check = True
    st, _ = step(st, batches[1])
    trace = step.last_trace
    stores = _stores(st)
    findings = no_param_concat(trace, bound=bound, target=target)
    findings += no_host_callback(trace, target=target)
    findings += donation_honored(trace, stores, owned,
                                 min_bytes=_bytes(stores), target=target)
    _describe(report, trace, stores, owned)
    del trace, stores
    step.last_trace = None

    runs = watch(trainer.run_steps, dev, label="trainer.run_steps")
    runs.sync_check = True
    stacked = tree_map(lambda *xs: torch.stack(xs), *batches[2:4])
    st, _ = runs(st, stacked)
    findings += no_param_concat(runs.last_trace, bound=bound,
                                target="trainer.run_steps")
    findings += no_host_callback(runs.last_trace,
                                 target="trainer.run_steps")

    with TraceSentinel(step, strict=False, labels=[target]) as sentinel:
        st, _ = step(st, batches[4])
        st = st._replace(opt_state=set_controller_scale(st.opt_state,
                                                        SCALE_WRITE))
        st, _ = step(st, batches[5])
        mem = Membership(trainer.algo.n_learners)
        mem.crash(trainer.algo.n_learners - 1)
        st = trainer.set_membership(st, mem)       # same-shape table swap
        st, _ = step(st, batches[6])
    findings += sentinel.findings
    if report is not None:
        report.update(window_calls=3, signatures=trace_count(step))
    return findings


def audit_trainer(n: int = 4, hidden: int = 32, device=None
                  ) -> List[Finding]:
    """Audit the flat fused trainer on the FC net (the reference's
    fixture: n 4, hidden 32, ``TemplateImages``, DPSGD ring,
    ``scale_by_controller(sgd(0.1, momentum=0.9))``): ``train_step`` and
    ``run_steps`` carry no parameter-sized concatenate and no host read,
    the stores are written in place, and stepping, a controller scale
    write and a membership swap never change the step's trace."""
    from ..core import AlgoConfig, Membership, MultiLearnerTrainer
    from ..data import ShardedLoader, TemplateImages
    from ..models import fcnet
    from ..optim import scale_by_controller, sgd

    dev = resolve_device(device)
    loader = ShardedLoader(TemplateImages(), n_learners=n, local_batch=16,
                           seed=0, device=dev)
    params = fcnet.init_params(torch.Generator(device=dev).manual_seed(0),
                               in_dim=784, hidden=hidden)
    tr = MultiLearnerTrainer(
        fcnet.loss_fn, scale_by_controller(sgd(0.1, momentum=0.9)),
        AlgoConfig(algo="dpsgd", topology="ring", n_learners=n),
        engine="flat", device=dev)
    st = tr.set_membership(tr.init(1, params), Membership(n))
    return audit_train_step(
        tr, st, [loader.batch(i) for i in range(7)],
        bound=st.params.numel() // 100)


# ---------------------------------------------------------------------------
# the launch step (the scale path): one rank of a process group
# ---------------------------------------------------------------------------

def audit_launch_step(step, state, batches: Sequence, *, params_tree,
                      target: str, report: Optional[dict] = None
                      ) -> List[Finding]:
    """Audit this rank's DPSGD launch step (``launch.train``'s, built with
    ``gossip_backend="ppermute"``) over two batches: a warm step, one
    traced.  Its ``c10d.send`` ops equal the sends of the live slots the
    rank takes part in (``rank_sends`` of the step's tables), every send
    carries the parameters' wire dtype, no concatenate reaches 1.5 x the
    learner's padded flat size, no host read, the stores written in
    place.  Every rank of the group must call it together.
    ``params_tree``: the learner's tree (shapes and dtypes are read: meta
    tensors do); ``report`` (a dict) receives what the traced step
    showed."""
    from ..core.dpsgd import HostStaging
    from ..core.flatstate import flat_meta

    meta = flat_meta(params_tree)
    owned = storage_ptrs(_stores(state))
    st, _ = step(state, batches[0])
    owned |= storage_ptrs(_stores(st))
    run = watch(step, step.device, label=target,
                watch_bytes=_bytes([state.params]))
    run.sync_check = not HostStaging.needed(step.group, step.device)
    tables = step.step_tables(st.step, st.seed)
    st, _ = run(st, batches[1])
    trace = run.last_trace
    stores = _stores(st)
    # the ppermute backend's wire is one store a slot (model sharding
    # only shrinks it): 1.5x the learner's padded size catches a
    # fleet-sized gather or a per-leaf pad-and-concat
    findings = no_param_concat(trace, bound=3 * meta.padded // 2,
                               target=target)
    findings += no_host_callback(trace, target=target)
    expected = rank_sends(tables, step.rank)
    findings += collective_count(trace, expected=expected, target=target)
    findings += wire_dtype(trace, expected=meta.wire_dtype(), target=target)
    findings += donation_honored(trace, stores, owned,
                                 min_bytes=_bytes(stores), target=target)
    _describe(report, trace, stores, owned, sends=count_op(trace,
                                                           "c10d.send"),
              live_slot_sends=expected,
              wire=sorted({dt for o in trace.ops
                           if o.packet == "c10d.send" for dt, _ in o.wire}),
              sync_checked=run.sync_check)
    return findings


def _extra_send(step, state, batch, target: str) -> List[Finding]:
    """A step followed by one more send around the learner group's ring:
    the seeded violation ``collective-count`` must flag."""
    import torch.distributed as dist

    g = step.group
    n, r = step.n, step.rank
    tables = step.step_tables(state.step, state.seed)
    with StepTrace(step.device) as trace:
        state, _ = step(state, batch)
        row = state.params[0].reshape(-1)[:8].clone()
        peer = dist.get_global_rank(g, (r + 1) % n) if g is not None \
            else (r + 1) % n
        src = dist.get_global_rank(g, (r - 1) % n) if g is not None \
            else (r - 1) % n
        got = torch.empty_like(row)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, row, peer, g),
                dist.P2POp(dist.irecv, got, src, g)]):
            work.wait()
    return collective_count(trace, expected=rank_sends(tables, r),
                            target=target)


def _launch_rank(rank: int, port: int, shape, arch: str, device,
                 seeded: bool, queue) -> None:
    """One gloo rank of ``audit_launch`` (run in a spawned process): puts
    (rank, findings, None) or (rank, None, the traceback)."""
    import traceback
    try:
        queue.put((rank, _launch_rank_findings(rank, port, shape, arch,
                                               device, seeded), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _launch_rank_findings(rank, port, shape, arch, device, seeded):
    import torch.distributed as dist

    from ..configs import get_config
    from ..data import ShardedLoader, SyntheticTokenStream
    from ..launch import init_learner_group, init_mesh
    from ..launch.train import make_dpsgd_train_step
    from ..models import build_model
    from ..optim import sgd

    torch.set_num_threads(1)
    L, M = shape
    url = f"tcp://127.0.0.1:{port}"
    if M > 1:
        mesh, dev = init_mesh(rank, shape, url, device=device,
                              backend="gloo")
    else:
        mesh, dev = None, init_learner_group(rank, L, url, device=device,
                                             backend="gloo")
    try:
        cfg = get_config(arch).smoke_config()
        api = build_model(cfg, device=dev)
        step = make_dpsgd_train_step(api, sgd(0.1, momentum=0.9),
                                     topology="ring",
                                     gossip_backend="ppermute", mesh=mesh,
                                     device=dev)
        tree = api.param_tree(api.init(step.rank))   # learner i's weights
        state = step.init(tree, seed=0)
        loader = ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                               n_learners=L, local_batch=2 * M,
                               extra_args=(64,), seed=0, device=dev)
        batches = [tree_map(lambda x: x[step.rank], loader.batch(t))
                   for t in range(3)]
        target = f"launch.dpsgd_step[ppermute]@rank{rank}"
        findings = audit_launch_step(step, state, batches[:2],
                                     params_tree=tree, target=target)
        if seeded:
            state = step.init(tree, seed=0)
            findings += _extra_send(step, state, batches[2],
                                    target + "[seeded extra send]")
        return findings
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def audit_launch(arch: str = "transformer-100m", shape=(4, 2), device=None,
                 *, seeded: bool = False) -> List[Finding]:
    """Audit the DPSGD launch step with the point-to-point backend on a
    ``shape`` = (learners, model) mesh of the smoke ``arch``: one gloo
    rank a device, spawned by ``torch.multiprocessing`` (on the card the
    ranks share it).  Each rank runs ``audit_launch_step``; the findings
    of every rank come back labeled by rank.  ``seeded``: each rank also
    runs a step with one extra send (``collective-count`` must flag it:
    the tests' negative control)."""
    import queue as queues
    import time

    dev = resolve_device(device)
    world = int(np.prod(shape))
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_launch_rank,
                         args=(r, port, tuple(shape), arch, str(dev), seeded,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        while len(out) < world:
            try:
                rank, found, err = results.get(
                    timeout=max(deadline - time.monotonic(), 1))
            except queues.Empty:
                raise RuntimeError(f"launch audit ranks silent for "
                                   f"{LAUNCH_TIMEOUT_S} s; got "
                                   f"{sorted(out)}")
            if err is not None:
                raise RuntimeError(f"launch audit rank {rank} failed:\n"
                                   f"{err}")
            out[rank] = found
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    return [f for r in range(world) for f in out[r]]


# ---------------------------------------------------------------------------
# the serve decode step (the inference path)
# ---------------------------------------------------------------------------

def audit_serve_engine(eng, *, bound: int, target: str,
                       report: Optional[dict] = None) -> List[Finding]:
    """Audit ``eng``'s paged decode step: ``api.paged_decode_step`` is
    watched where the engine calls it.  A warm call (``warmup``), one
    traced (no concatenate of ``bound`` elements, no host read, the K/V
    pools written in place); then a sentinel window that submits, steps,
    joins mid-flight and evicts until the queue drains.  ``report`` (a
    dict) receives what the traced step showed."""
    eng.warmup()
    cache = tree_leaves(eng.cache)
    step = watch(eng.api.paged_decode_step, eng.device, label=target,
                 watch_bytes=min(_bytes([t]) for t in cache))
    step.sync_check = True
    eng.api = eng.api._replace(paged_decode_step=step)
    owned = storage_ptrs(cache)
    eng.warmup()
    trace = step.last_trace
    cache = tree_leaves(eng.cache)
    findings = no_param_concat(trace, bound=bound, target=target)
    findings += no_host_callback(trace, target=target)
    findings += donation_honored(trace, cache, owned,
                                 min_bytes=_bytes(cache), target=target)
    _describe(report, trace, cache, owned)
    del trace, cache
    step.last_trace = None

    calls = len(step.history)
    with TraceSentinel(step, strict=False, labels=[target]) as sentinel:
        eng.submit([3, 1, 4], 4)
        for _ in range(3):
            eng.step()
        eng.submit([2, 7], 5)                 # mid-flight join
        eng.submit([5], 3)
        eng.run()
    findings += sentinel.findings
    if report is not None:
        report.update(window_calls=len(step.history) - calls,
                      signatures=trace_count(step))
    return findings


def audit_serve(arch: str = "transformer-100m", device=None
                ) -> List[Finding]:
    """Audit the paged decode step of the smoke ``arch`` behind a
    ``ServeEngine`` of 2 slots, page 4, max length 16 (the reference's
    fixture)."""
    from ..configs import get_config
    from ..models import build_model
    from ..serve import ServeEngine

    dev = resolve_device(device)
    cfg = get_config(arch).smoke_config()
    api = build_model(cfg, device=dev)
    params = api.init(0)
    eng = ServeEngine(api, params, n_slots=2, page_size=4, max_len=16)
    n_params = sum(p.numel() for p in params.parameters())
    return audit_serve_engine(eng, bound=max(1, n_params // 100),
                              target=f"serve.paged_decode_step[{arch}]")


def audit_all(device=None) -> List[Finding]:
    """Everything, in the order the contracts layer: research trainer,
    launch step, serve engine."""
    return (audit_trainer(device=device) + audit_launch(device=device)
            + audit_serve(device=device))
