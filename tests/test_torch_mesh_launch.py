"""The launch path with a model axis (``repro_torch.launch``, a learner
spanning the ranks of a ``DeviceMesh``) against the JAX reference's
launch step builders and probe on meshes with a real ``model`` axis.

Two runs start together from one input file made here with numpy and the
reference's own initializer (transformer-100m's smoke config, 2 learners'
stacked initial parameters, seeded batches of seq 32 and 4 rows a
learner):

  * the reference: three subprocesses (training, the probe stacked, the
    probe unstacked), each with 4 forced host devices and
    Auto-axis ``("data", "model")`` meshes (2, 2) and (1, 4), its params
    placed by ``params_sharding``.  ``make_dpsgd_train_step(gossip_backend=
    "einsum")`` runs 3 steps of ring and random_pair, and
    ``make_ssgd_train_step`` 3 steps, on each mesh (random_pair only
    where there are 2 learners); ``make_probe_step`` measures, stacked
    and ``stacked=False``, on (2, 2).  Its draws are realized from its
    key and handed to the port.  Its ``shard_map`` paths (ppermute,
    AD-PSGD) do not run under jax 0.9, so AD-PSGD is held against the
    port's trainer at n = 2 and the ppermute backend against the einsum
    one;
  * the port: one subprocess spawning 4 gloo ranks on the CPU, which
    build the (2, 2), (1, 4) and (4, 1) meshes on one group and run the
    same cases, each learner's shards gathered for the comparison.

Tiers: parameters and momentum 1e-5 absolute + 1e-4 relative (the
trainer's tier, ``tests/test_torch_launch.py``; measured at most 1.1e-7
absolute on parameters, 5.7e-7 on momentum), losses 1e-5 relative
(measured 1.4e-7).  The probe is held at the landscape tier, 1e-4
relative (``tests/test_torch_landscape.py``; measured at most 8.9e-6,
on Tr(H) from one Hutchinson probe; sharpness 8.8e-7).  A mesh of model
size 1 is slice 7a's step: bitwise, and so are two learner axes against
one.  The probe with ``gather="period"`` (forward over reverse a period
at a time) runs on (2, 2) and (1, 4), stacked and single, beside the
whole probe on the same state and draws: every field within 1e-5 of it,
within 1e-4 of the reference, and its full weights the non-period
leaves and one period.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import topology as jax_topo  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (AlgoConfig, FaultEvent, FaultPlan,  # noqa: E402
                              Membership, MultiLearnerTrainer, apply_plan,
                              flat_meta)
from repro_torch.core import dpsgd as dp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_RANKS, L_MAX, B, SEQ = 4, 4, 4, 32
STEPS, TICKS = 3, 8
MESHES = ((2, 2), (1, 4))
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_RTOL = 1e-5
PROBE_RTOL = 1e-4
ELASTIC_PLAN = FaultPlan(FaultPlan.crash_rejoin(1, 2, 6).events
                         + FaultPlan.straggler(0, 3).events
                         + (FaultEvent(4, "drop_round"),))

COMMON = r"""
import numpy as np


def load_tree(inp, prefix):
    out = {}
    for k in inp.files:
        if k.startswith(prefix):
            node = out
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inp[k]
    return out


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def rows(tree, n):
    if isinstance(tree, dict):
        return {k: rows(v, n) for k, v in tree.items()}
    return tree[:n]
"""

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro import optim
from repro.configs import get_config
from repro.core.flatstate import flat_meta
from repro.core.schedule import make_schedule
from repro.launch.sharding import named_shardings, params_sharding
from repro.launch.train import (PjitTrainState, make_dpsgd_train_step,
                                make_probe_step, make_ssgd_train_step)
from repro.models.model import build_model

src, dst, part = sys.argv[1], sys.argv[2], sys.argv[3]
inp = np.load(src)
params4 = jax.tree_util.tree_map(jnp.asarray, load_tree(inp, "p/"))
api = build_model(get_config("transformer-100m").smoke_config())
single = jax.tree_util.tree_map(lambda x: x[0], params4)
meta = flat_meta(single)


def batch(t, L):
    return {k: jnp.asarray(inp[k][t][:L * B]) for k in ("tokens", "labels",
                                                        "mask")}


def fused():
    return optim.scale_by_schedule(optim.sgd(0.1, momentum=0.9),
                                   optim.warmup_linear_scale(10, 1.0))


def mu_of(opt_state):
    return opt_state["inner"]["mu"]


def place(tree, mesh, stacked):
    return jax.device_put(tree, named_shardings(
        params_sharding(tree, mesh, stacked=stacked), mesh))


out = {}
for shape in MESHES if part == "train" else ():
    L = shape[0]
    tag = f"{shape[0]}x{shape[1]}"
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    params = rows(params4, L)
    for topo in ("ring", "random_pair")[:L]:
        opt = fused()
        step = jax.jit(make_dpsgd_train_step(api, opt, mesh, topology=topo,
                                             gossip_backend="einsum"))
        with mesh:
            state = PjitTrainState(place(params, mesh, True),
                                   jax.vmap(opt.init)(params), jnp.int32(0),
                                   jax.random.PRNGKey(1))
            losses = []
            for t in range(STEPS):
                state, m = step(state, batch(t, L))
                losses.append(float(m["loss"]))
        out[f"{tag}/dpsgd/{topo}/params"] = np.asarray(
            meta.flatten(state.params))
        out[f"{tag}/dpsgd/{topo}/mu"] = np.asarray(
            meta.flatten(mu_of(state.opt_state)))
        out[f"{tag}/dpsgd/{topo}/loss"] = np.asarray(losses)
    if L > 1:
        sched = make_schedule("random_pair", L)
        out[f"{tag}/random_pair/matrices"] = np.stack([np.asarray(
            sched.step_matrix(jax.random.fold_in(jax.random.PRNGKey(1), t),
                              t)) for t in range(STEPS)])
    opt = fused()
    step = jax.jit(make_ssgd_train_step(api, opt, mesh))
    with mesh:
        state = PjitTrainState(place(single, mesh, False), opt.init(single),
                               jnp.int32(0), jax.random.PRNGKey(1))
        losses = []
        for t in range(STEPS):
            state, m = step(state, batch(t, L))
            losses.append(float(m["loss"]))
    out[f"{tag}/ssgd/params"] = np.asarray(meta.flatten(state.params))
    out[f"{tag}/ssgd/mu"] = np.asarray(meta.flatten(mu_of(state.opt_state)))
    out[f"{tag}/ssgd/loss"] = np.asarray(losses)

# the sharded probe on (2, 2), stacked and not
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
params = rows(params4, 2)
for stacked, p in ((True, params), (False, single)):
    if part != ("probe_stacked" if stacked else "probe_single"):
        continue
    probe = jax.jit(make_probe_step(api, mesh, alpha=0.1, stacked=stacked,
                                    lanczos_iters=LANCZOS,
                                    hutchinson_samples=HUTCH))
    with mesh:
        r = probe(place(p, mesh, stacked), batch(0, 2),
                  jax.random.PRNGKey(PROBE_KEY))
    tag = "stacked" if stacked else "single"
    for f in r._fields:
        out[f"probe/{tag}/{f}"] = np.asarray(getattr(r, f))
np.savez(dst, **out)
"""

PORT_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, port, src, dst):
    torch.set_num_threads(1)
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core import FaultEvent, FaultPlan, Membership, apply_plan
    from repro_torch.core import dpsgd as dp
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.mesh import (learner_group, learner_rank,
                                         make_mesh, make_test_mesh,
                                         model_rank)
    from repro_torch.launch.train import (
        gather_learner, jit_train_step, make_adpsgd_train_step,
        make_dpsgd_train_step, make_probe_step, make_ssgd_train_step,
        membership_operands, rank_state_from_numpy)
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_from_jax

    init_learner_group(rank, N_RANKS, f"tcp://127.0.0.1:{port}",
                       device="cpu", backend="gloo")
    meshes = {s: make_test_mesh(*s) for s in MESHES + ((4, 1),)}
    pods = make_mesh((2, 1, 2), ("pod", "data", "model"))
    inp = np.load(src)
    params4 = load_tree(inp, "p/")
    api = build_model(get_config("transformer-100m").smoke_config(),
                      device="cpu")

    def batch(t, i, rows_=B):
        return {k: torch.tensor(inp[k][t % STEPS][i * B:i * B + rows_])
                for k in ("tokens", "labels", "mask")}

    def fused():
        return optim.scale_by_schedule(optim.sgd(0.1, momentum=0.9),
                                       optim.warmup_linear_scale(10, 1.0))

    peers = []
    P2POp = dist.P2POp

    class Recorded(P2POp):
        def __init__(self, op, tensor, peer=None, group=None, tag=0, **kw):
            peers.append(int(peer))
            super().__init__(op, tensor, peer, group, tag, **kw)

    dist.P2POp = Recorded
    out, info = {}, {}

    def run(name, mesh, step, state, steps, each=None, rounds=None):
        i = learner_rank(mesh)
        rec = {"loss": [], "rounds": [], "peers": [], "model_calls": [],
               "collectives": [], "model_kinds": []}
        for t in range(steps):
            del peers[:]
            m0, c0 = step.model_collectives, step.collectives
            k0 = step.model_kinds
            if each is not None:
                state = each(t, state)
            args = (rounds[t],) if rounds is not None else ()
            state, m = step(state, batch(t, i), *args)
            rec["loss"].append(float(m["loss"]))
            rec["rounds"].append(step.last_rounds)
            rec["peers"].append(list(peers))
            rec["model_calls"].append(step.model_collectives - m0)
            rec["model_kinds"].append({k: v - k0.get(k, 0) for k, v in
                                       step.model_kinds.items()})
            rec["collectives"].append(step.collectives - c0)
        rec.update(sends=step.sends, recvs=step.recvs,
                   bytes=step.bytes_received, model_bytes=step.model_bytes,
                   store_bytes=state.params.numel() * 4, learner=i,
                   model_rank=model_rank(mesh))
        info[name] = rec
        full = gather_learner(step, state.params)
        if model_rank(mesh) == 0:
            out[f"{name}/params/{i}"] = full.numpy()
        f = step.optimizer.fused
        if f is not None and f.read_mu(state.opt_state) is not None:
            mu = gather_learner(step, f.read_mu(state.opt_state))
            if model_rank(mesh) == 0:
                out[f"{name}/mu/{i}"] = mu.numpy()
        if state.buffer is not None:
            buf = gather_learner(step, state.buffer)
            if model_rank(mesh) == 0:
                out[f"{name}/buffer/{i}"] = buf.numpy()
            rec.update(age=state.age.tolist(), clock=state.clock.tolist())
        return state

    for shape in MESHES:
        mesh, L = meshes[shape], shape[0]
        tag = f"{shape[0]}x{shape[1]}"
        params = rows(params4, L)
        cases = [("ring", "einsum")] + ([("random_pair", "einsum"),
                                         ("ring", "ppermute")] if L > 1
                                        else [])
        for topo, backend in cases:
            step = make_dpsgd_train_step(api, fused(), mesh=mesh,
                                         topology=topo,
                                         gossip_backend=backend,
                                         device="cpu")
            state = rank_state_from_numpy(step, params)
            rounds = None
            if topo == "random_pair":
                rounds = [[dp.pair_tables(p)]
                          for p in inp[f"rp_partners_{L}"]]
            run(f"{tag}/{backend}/{topo}", mesh, step, state, STEPS,
                rounds=rounds)
        step = make_ssgd_train_step(api, fused(), mesh=mesh, device="cpu")
        state = rank_state_from_numpy(step, broadcast_row0(params))
        run(f"{tag}/ssgd", mesh, step, state, STEPS)

    # two learner axes: the same learners as (2, 2), over (pod, data)
    step = make_dpsgd_train_step(api, fused(), mesh=pods, topology="ring",
                                 device="cpu")
    run("pods/einsum/ring", pods, step,
        rank_state_from_numpy(step, rows(params4, 2)), STEPS)
    # ... whose learner groups the mesh built once: a second step on it
    # gossips over the same group
    again = make_ssgd_train_step(api, fused(), mesh=pods, device="cpu")
    info["pods_group"] = {"same": again.group is step.group,
                          "kept": learner_group(pods) is step.group}

    mesh, params = meshes[(2, 2)], rows(params4, 2)
    step = make_adpsgd_train_step(api, fused(), mesh=mesh, max_staleness=4,
                                  slow_learner=0, slow_factor=3,
                                  device="cpu")
    state = rank_state_from_numpy(step, params, buffer=params)
    run("adpsgd", mesh, step, state, TICKS)

    plan = FaultPlan(FaultPlan.crash_rejoin(1, 2, 6).events
                     + FaultPlan.straggler(0, 3).events
                     + (FaultEvent(4, "drop_round"),))
    mem = Membership(2)

    def members(t, state):
        drop = apply_plan(mem, plan, t)
        return state._replace(**membership_operands(mem, drop_round=drop))

    step = jit_train_step(make_adpsgd_train_step(
        api, fused(), mesh=mesh, max_staleness=4, elastic=True,
        device="cpu"))
    state = rank_state_from_numpy(step, params, buffer=params)
    run("elastic", mesh, step, state, TICKS, each=members)

    # donation: a consumed state raises
    step = jit_train_step(make_dpsgd_train_step(
        api, fused(), mesh=mesh, topology="ring", device="cpu"))
    old = rank_state_from_numpy(step, params)
    new, _ = step(old, batch(0, learner_rank(mesh)))
    try:
        step(old, batch(1, learner_rank(mesh)))
        info["donated"] = "reused"
    except ValueError as e:
        info["donated"] = str(e)
    step(new, batch(1, learner_rank(mesh)))
    try:
        step._step(new, batch(0, learner_rank(mesh), rows_=3))
        info["odd_rows"] = "ran"
    except ValueError as e:
        info["odd_rows"] = str(e)

    # the sharded probe, the reference's draws injected: gather="whole"
    # on (2, 2) (held to the reference), then "period" there and both on
    # (1, 4)
    draws = load_tree(inp, "draws/")
    for shape in MESHES:
        mesh, tag = meshes[shape], f"{shape[0]}x{shape[1]}"
        params = rows(params4, shape[0])
        for stacked, gather in ((True, "whole"), (False, "whole"),
                                (True, "period"), (False, "period")):
            kind = "stacked" if stacked else "single"
            probe = make_probe_step(api, mesh, alpha=0.1, stacked=stacked,
                                    lanczos_iters=LANCZOS,
                                    hutchinson_samples=HUTCH, gather=gather,
                                    device="cpu")
            step = make_dpsgd_train_step(api, fused(), mesh=mesh,
                                         device="cpu")
            state = rank_state_from_numpy(
                step, params if stacked else broadcast_row0(params))
            r = probe(state.params, batch(0, learner_rank(mesh)),
                      q0=tree_from_jax(draws["q0"]),
                      probes=[tree_from_jax(draws[f"z{s}"])
                              for s in range(HUTCH)])
            lay = probe.layout
            key = (f"probe/{kind}" if (shape, gather) == ((2, 2), "whole")
                   else f"probe/{tag}/{gather}/{kind}")
            info[key] = {f: float(getattr(r, f)) for f in r._fields}
            info[key + "/bytes"] = {
                "max_full": probe.max_full_bytes,
                "rest": lay.rest.meta.rows * 128 * 4,
                "period": lay.period.meta.rows * 128 * 4,
                "full": lay.full.rows * 128 * 4}
            if shape == (1, 4) and not stacked:
                # the probe's own draws from a generator, leaf by leaf
                r = probe(state.params, batch(0, learner_rank(mesh)),
                          torch.Generator().manual_seed(PROBE_KEY))
                info[f"probe/drawn/{gather}"] = {
                    f: float(getattr(r, f)) for f in r._fields}

    # a MoE model on (2, 2): the expert-parallel all-to-all inside the
    # step (moe_backend="shard_map") against the einsum route
    import dataclasses
    from repro_torch.models import moe_shardmap
    mesh = meshes[(2, 2)]
    for backend in ("shard_map", "einsum"):
        cfg = dataclasses.replace(
            get_config("granite-moe-3b-a800m").smoke_config(),
            moe_backend=backend, capacity_factor=64.0)
        moe_api = build_model(cfg, device="cpu")
        step = make_dpsgd_train_step(moe_api, fused(), mesh=mesh,
                                     topology="ring", device="cpu")
        state = step.init(moe_api.param_tree(moe_api.init(
            learner_rank(mesh))))
        calls = moe_shardmap.all_to_all.calls
        for t in range(2):      # the smoke configs share vocab 512
            state, _ = step(state, batch(t, learner_rank(mesh)))
        full = gather_learner(step, state.params)
        if model_rank(mesh) == 0:
            out[f"moe/{backend}/{learner_rank(mesh)}"] = full.numpy()
        info[f"moe/{backend}"] = moe_shardmap.all_to_all.calls - calls

    # a mesh of model size 1 is slice 7a's step, bitwise
    mesh = meshes[(4, 1)]
    for name, kw in (("7b_4x1", dict(mesh=mesh)), ("7a", {})):
        step = make_dpsgd_train_step(api, fused(), topology="ring",
                                     device="cpu", **kw)
        state = rank_state_from_numpy(step, params4)
        for t in range(STEPS):
            state, _ = step(state, batch(t, rank))
        out[f"{name}/params/{rank}"] = state.params[0].clone().numpy()
        info[name] = {"model_calls": step.model_collectives}

    np.savez(f"{dst}/rank{rank}.npz", **out)
    with open(f"{dst}/rank{rank}.json", "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


def broadcast_row0(tree):
    if isinstance(tree, dict):
        return {k: broadcast_row0(v) for k, v in tree.items()}
    return np.broadcast_to(tree[:1], tree.shape)


if __name__ == "__main__":
    src, dst, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
    mp.start_processes(rank_main, args=(port, src, dst), nprocs=N_RANKS,
                       start_method="spawn")
"""

LANCZOS, HUTCH, PROBE_KEY = 3, 1, 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probe_draws(params):
    """The reference probe's own draws from its key: the Lanczos start
    vector, then the Hutchinson probes (shapes of one learner; the same
    stacked or not)."""
    from repro.core.util import tree_gaussian_like
    from repro.landscape.hvp import tree_rademacher_like
    w = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a[0]), params)
    k_lanczos, k_hutch = jax.random.split(jax.random.PRNGKey(PROBE_KEY))
    draws = {"q0": tree_gaussian_like(k_lanczos, w, 1.0)}
    for s, k in enumerate(jax.random.split(k_hutch, HUTCH)):
        draws[f"z{s}"] = tree_rademacher_like(k, w)
    return {f"draws/{name}/{path}": np.asarray(leaf)
            for name, tree in draws.items()
            for path, leaf in _paths(tree).items()}


def _partners(L):
    return np.stack([np.asarray(jax_topo.pair_partners(
        jax.random.fold_in(jax.random.PRNGKey(1), t), L))
        for t in range(STEPS)])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_launch")
    jcfg = jax_get_config("transformer-100m").smoke_config()
    japi = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jax.vmap(japi.init)(
        jax.random.split(jax.random.PRNGKey(0), L_MAX)))
    rng = np.random.default_rng(0)
    shape = (STEPS, L_MAX * B, SEQ)
    arrays = {f"p/{k}": v for k, v in _paths(params).items()}
    arrays.update(
        tokens=rng.integers(0, jcfg.vocab, shape).astype(np.int32),
        labels=rng.integers(0, jcfg.vocab, shape).astype(np.int32),
        mask=np.ones(shape, np.float32),
        rp_partners_2=_partners(2), **_probe_draws(params))
    np.savez(d / "inputs.npz", **arrays)
    return d, params, arrays


def _consts():
    return (f"N_RANKS, L_MAX, B, SEQ = {N_RANKS}, {L_MAX}, {B}, {SEQ}\n"
            f"STEPS, TICKS, MESHES = {STEPS}, {TICKS}, {MESHES!r}\n"
            f"LANCZOS, HUTCH, PROBE_KEY = {LANCZOS}, {HUTCH}, {PROBE_KEY}\n"
            + COMMON)


@pytest.fixture(scope="module")
def runs(inputs):
    """Both sides, started together; returns (reference npz, [rank npz],
    [rank info])."""
    d, _, _ = inputs
    (d / "ref.py").write_text(_consts() + REF_SCRIPT)
    (d / "port.py").write_text(_consts() + PORT_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(d / script)] + args, cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for script, args in (
            ("ref.py", [str(d / "inputs.npz"), str(d / "ref_train.npz"),
                        "train"]),
            ("ref.py", [str(d / "inputs.npz"), str(d / "ref_stacked.npz"),
                        "probe_stacked"]),
            ("ref.py", [str(d / "inputs.npz"), str(d / "ref_single.npz"),
                        "probe_single"]),
            ("port.py", [str(d / "inputs.npz"), str(d),
                         str(_free_port())]))]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    ref = {**np.load(d / "ref_train.npz"), **np.load(d / "ref_stacked.npz"),
           **np.load(d / "ref_single.npz")}
    ranks = [np.load(d / f"rank{r}.npz") for r in range(N_RANKS)]
    info = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(N_RANKS)]
    return ref, ranks, info


def _learners(ranks, key, L):
    """Learner i's full store, from the model rank 0 that saved it."""
    got = {}
    for r in ranks:
        for i in range(L):
            if f"{key}/{i}" in r.files:
                got[i] = r[f"{key}/{i}"]
    assert sorted(got) == list(range(L)), (key, sorted(got))
    return np.stack([got[i] for i in range(L)])


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# DPSGD and SSGD against the reference on model-sharded meshes
# ---------------------------------------------------------------------------

CASES = [(s, t) for s in MESHES for t in ("ring", "random_pair")[:s[0]]]


@pytest.mark.parametrize("shape,topo", CASES,
                         ids=[f"{_tag(s)}-{t}" for s, t in CASES])
def test_dpsgd_einsum_matches_the_reference_on_a_model_axis(runs, shape,
                                                            topo):
    ref, ranks, info = runs
    tag, L = _tag(shape), shape[0]
    for what in ("params", "mu"):
        np.testing.assert_allclose(
            _learners(ranks, f"{tag}/einsum/{topo}/{what}", L),
            ref[f"{tag}/dpsgd/{topo}/{what}"], **PARAM_TOL,
            err_msg=f"{tag} {topo} {what}")
    np.testing.assert_allclose(info[0][f"{tag}/einsum/{topo}"]["loss"],
                               ref[f"{tag}/dpsgd/{topo}/loss"],
                               rtol=LOSS_RTOL)


def test_random_pair_tables_are_the_reference_matchings(inputs, runs):
    _, _, arrays = inputs
    ref, _, _ = runs
    for t, partner in enumerate(arrays["rp_partners_2"]):
        m = 0.5 * (np.eye(2) + np.eye(2)[partner])
        np.testing.assert_array_equal(ref["2x2/random_pair/matrices"][t], m)


@pytest.mark.parametrize("shape", MESHES, ids=[_tag(s) for s in MESHES])
def test_ssgd_matches_the_reference_on_a_model_axis(runs, shape):
    ref, ranks, info = runs
    tag, L = _tag(shape), shape[0]
    got = _learners(ranks, f"{tag}/ssgd/params", L)
    for i in range(L):              # the replicas stay equal bitwise
        np.testing.assert_array_equal(got[i], got[0])
    np.testing.assert_allclose(got[0], ref[f"{tag}/ssgd/params"],
                               **PARAM_TOL)
    np.testing.assert_allclose(_learners(ranks, f"{tag}/ssgd/mu", L)[0],
                               ref[f"{tag}/ssgd/mu"], **PARAM_TOL)
    np.testing.assert_allclose(info[0][f"{tag}/ssgd"]["loss"],
                               ref[f"{tag}/ssgd/loss"], rtol=LOSS_RTOL)
    for i in info:                  # one all_reduce a step a learner group
        assert i[f"{tag}/ssgd"]["collectives"] == [1] * STEPS


def test_ppermute_on_a_deterministic_schedule_equals_einsum(runs):
    ref, ranks, _ = runs
    got = _learners(ranks, "2x2/ppermute/ring/params", 2)
    np.testing.assert_allclose(got, _learners(ranks, "2x2/einsum/ring/params",
                                              2), **PARAM_TOL)
    np.testing.assert_allclose(got, ref["2x2/dpsgd/ring/params"],
                               **PARAM_TOL)


def test_two_learner_axes_train_the_same_learners(runs):
    """A (pod 2, data 1, model 2) mesh: learners over two axes, the
    learner group built per model coordinate; the same ranks and rows as
    (2, 2), so the same result bitwise."""
    _, ranks, info = runs
    np.testing.assert_array_equal(
        _learners(ranks, "pods/einsum/ring/params", 2),
        _learners(ranks, "2x2/einsum/ring/params", 2))
    for rank, i in enumerate(info):
        assert i["pods/einsum/ring"]["learner"] == rank // 2
        for peers in i["pods/einsum/ring"]["peers"]:
            assert peers and all(p == rank ^ 2 for p in peers)


def test_steps_on_two_learner_axes_share_one_learner_group(runs):
    """``make_mesh`` builds a (pod, data, model) mesh's learner groups
    once: two steps built on it gossip over the same group, and no step
    makes a group of its own."""
    _, _, info = runs
    for i in info:
        assert i["pods_group"] == {"same": True, "kept": True}


def test_a_mesh_of_model_size_1_is_the_one_learner_a_rank_step(runs):
    _, ranks, info = runs
    for r, rk in enumerate(ranks):
        np.testing.assert_array_equal(rk[f"7b_4x1/params/{r}"],
                                      rk[f"7a/params/{r}"])
        assert info[r]["7b_4x1"]["model_calls"] == 0


# ---------------------------------------------------------------------------
# collectives: the model group's and the gossip's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["2x2/einsum/ring", "2x2/einsum/random_pair",
                                  "2x2/ppermute/ring", "1x4/einsum/ring",
                                  "adpsgd"])
def test_collectives_a_step(runs, name):
    """Each step: one all_gather and one reduce_scatter on the model group
    plus one all_reduce (the replicated leaves' gradients, the token count
    and the loss); one all_reduce of the loss on the learner group; one
    send and one receive a live gossip slot, each to the rank at the same
    model coordinate of the partner learner, each a local store."""
    _, _, info = runs
    M = 2 if name != "1x4/einsum/ring" else 4
    for rank, i in enumerate(info):
        rec = i[name]
        assert rec["model_calls"] == [3] * len(rec["loss"])
        assert rec["model_kinds"] == [{"all_gather": 1, "reduce_scatter": 1,
                                       "all_reduce": 1}] * len(rec["loss"])
        assert rec["collectives"] == [1] * len(rec["loss"])
        for t, (rounds, peers) in enumerate(zip(rec["rounds"],
                                                rec["peers"])):
            sends = sum(s for s, _ in rounds)
            recvs = sum(r for _, r in rounds)
            assert len(peers) == sends + recvs
            for p in peers:
                assert p != rank and p % M == rank % M, (name, t, p)
        assert rec["bytes"] == rec["recvs"] * rec["store_bytes"]
        if M == 4:                  # one learner: no gossip
            assert rec["sends"] == rec["recvs"] == 0


def test_the_model_group_moves_the_shards(runs):
    """A step's all_gather and reduce_scatter each bring (M - 1) local
    stores into a rank; the all_reduce the replicated tail."""
    _, _, info = runs
    for i in info:
        rec = i["2x2/einsum/ring"]
        per_step = rec["model_bytes"] / STEPS
        assert per_step >= 2 * rec["store_bytes"] * (2 - 1)
        assert per_step < 2.2 * rec["store_bytes"]


def test_a_store_is_the_rank_shard(runs, inputs):
    """Each rank's store holds its slice of every leaf: about 1/M of the
    learner's, as the reference's specs cut it."""
    _, params, _ = inputs
    meta = flat_meta(tree_from_jax(jax.tree_util.tree_map(lambda a: a[0],
                                                          params)))
    _, _, info = runs
    full = meta.rows * 128 * 4
    for i in info:
        assert i["2x2/einsum/ring"]["store_bytes"] < 0.56 * full
        assert i["1x4/einsum/ring"]["store_bytes"] < 0.3 * full


def test_a_batch_that_does_not_split_over_the_model_group_raises(runs):
    _, _, info = runs
    for i in info:
        assert "does not split" in i["odd_rows"]


def test_the_all_to_all_moe_trains_inside_the_mesh_step(runs):
    """granite-moe's smoke config on (2, 2) with ``moe_backend=
    "shard_map"``: each layer's all-to-all runs inside the step's
    forward and backward over the model group, and two DPSGD steps equal
    the einsum route's at a capacity that drops nothing."""
    _, ranks, info = runs
    np.testing.assert_allclose(_learners(ranks, "moe/shard_map", 2),
                               _learners(ranks, "moe/einsum", 2),
                               **PARAM_TOL)
    for i in info:
        assert i["moe/shard_map"] > 0 and i["moe/einsum"] == 0


def test_a_consumed_state_raises(runs):
    _, _, info = runs
    for i in info:
        assert "consumed" in i["donated"]


# ---------------------------------------------------------------------------
# AD-PSGD on (2, 2) against the port's trainer at n = 2
# ---------------------------------------------------------------------------

def _trainer_run(params, arrays, elastic):
    api = build_model(get_config("transformer-100m").smoke_config(),
                      device="cpu")
    opt = optim.scale_by_schedule(optim.sgd(0.1, momentum=0.9),
                                  optim.warmup_linear_scale(10, 1.0))
    algo = AlgoConfig(algo="adpsgd", topology="random_pair", n_learners=2,
                      max_staleness=4,
                      **({} if elastic else dict(slow_learner=0,
                                                 slow_factor=3)))
    tr = MultiLearnerTrainer(api.loss_fn, opt, algo,
                             params_from_tree=api.params_from_tree,
                             device="cpu")
    two = jax.tree_util.tree_map(lambda a: a[:2], params)
    single = tree_from_jax(jax.tree_util.tree_map(lambda a: a[0], two))
    state = tr.init(0, single)
    stacked = flat_meta(single).flatten(tree_from_jax(two))
    state.params.copy_(stacked)
    state.buffer.copy_(stacked)
    mem = Membership(2)
    for t in range(TICKS):
        batch = {k: torch.tensor(arrays[k][t % STEPS][:2 * B]).reshape(
            (2, B) + arrays[k].shape[2:]) for k in ("tokens", "labels",
                                                    "mask")}
        gate = None
        if elastic:
            drop = apply_plan(mem, ELASTIC_PLAN, t)
            state = tr.set_membership(state, mem, drop_round=drop)
            gate = mem.active & (not drop)
        state, _ = tr.train_step(state, batch,
                                 [dp.hypercube_tables(t, 2, gate)])
    return state


@pytest.mark.parametrize("elastic", [False, True],
                         ids=["straggler", "elastic"])
def test_adpsgd_on_a_model_axis_matches_the_trainer(inputs, runs, elastic):
    _, params, arrays = inputs
    _, ranks, info = runs
    state = _trainer_run(params, arrays, elastic)
    key = "elastic" if elastic else "adpsgd"
    np.testing.assert_allclose(_learners(ranks, f"{key}/params", 2),
                               state.params.numpy(), **PARAM_TOL)
    np.testing.assert_allclose(_learners(ranks, f"{key}/buffer", 2),
                               state.buffer.numpy(), **PARAM_TOL)
    np.testing.assert_array_equal(info[0][key]["age"], state.age.numpy())
    np.testing.assert_array_equal(info[0][key]["clock"],
                                  state.clock.numpy())


# ---------------------------------------------------------------------------
# the sharded probe against the reference's make_probe_step
# ---------------------------------------------------------------------------

def _probe_fields_close(got, want, rtol, what):
    for field, w in want.items():
        np.testing.assert_allclose(got[field], w, rtol=rtol, atol=0,
                                   err_msg=f"{what} {field}")


@pytest.mark.parametrize("tag", ["stacked", "single"])
def test_sharded_probe_matches_the_reference(runs, tag):
    from repro_torch.landscape import ProbeResult
    ref, _, info = runs
    for i in info:
        got = i[f"probe/{tag}"]
        for field in ProbeResult._fields:
            want = float(ref[f"probe/{tag}/{field}"])
            if tag == "single" and field in ("trace_hc", "sigma_w_sq"):
                assert got[field] == want == 0.0
                continue
            np.testing.assert_allclose(got[field], want, rtol=PROBE_RTOL,
                                       err_msg=f"{tag} {field}")


# ---------------------------------------------------------------------------
# the probe on the per-period gather
# ---------------------------------------------------------------------------

PERIOD_PROBE_RTOL = 1e-5
PROBE_CASES = [(s, k) for s in MESHES for k in ("stacked", "single")]
PROBE_IDS = [f"{s[0]}x{s[1]}-{k}" for s, k in PROBE_CASES]


def _whole_key(shape, kind):
    return (f"probe/{kind}" if shape == (2, 2)
            else f"probe/{_tag(shape)}/whole/{kind}")


@pytest.mark.parametrize("shape,kind", PROBE_CASES, ids=PROBE_IDS)
def test_period_probe_matches_the_whole_probe(runs, shape, kind):
    """Forward over reverse a section at a time against the whole
    gather's reverse over reverse, the same injected draws: every field
    (measured at most 9.1e-6 relative, on Tr(H) from one Hutchinson probe
    on (2, 2) stacked, where the whole probe reads 8.9e-6 from the
    reference and the period probe 1.4e-6: the forward-over-reverse HVP
    is the reference's order)."""
    _, _, info = runs
    for i in info:
        _probe_fields_close(i[f"probe/{_tag(shape)}/period/{kind}"],
                            i[_whole_key(shape, kind)], PERIOD_PROBE_RTOL,
                            f"{shape} {kind}")


def test_period_probe_draws_what_the_whole_probe_draws(runs):
    """With no injected vectors both gathers draw the Lanczos start and
    the Hutchinson probe leaf by leaf from the same generator, the
    period probe cutting each leaf to its shard as it is drawn: the
    same readings on (1, 4)."""
    _, _, info = runs
    for i in info:
        _probe_fields_close(i["probe/drawn/period"], i["probe/drawn/whole"],
                            PERIOD_PROBE_RTOL, "drawn")


@pytest.mark.parametrize("tag", ["stacked", "single"])
def test_period_probe_matches_the_reference(runs, tag):
    from repro_torch.landscape import ProbeResult
    ref, _, info = runs
    want = {f: float(ref[f"probe/{tag}/{f}"]) for f in ProbeResult._fields}
    for i in info:
        _probe_fields_close(i[f"probe/2x2/period/{tag}"], want, PROBE_RTOL,
                            tag)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_period_probe_holds_the_rest_and_one_period_full(runs, shape):
    """The period probe's full weights: the non-period leaves' buffer and
    one period's, below the learner's whole store, which the whole probe
    holds."""
    _, _, info = runs
    for i in info:
        for kind in ("stacked", "single"):
            b = i[f"probe/{_tag(shape)}/period/{kind}/bytes"]
            assert b["max_full"] == b["rest"] + b["period"] < b["full"]
            whole = i[_whole_key(shape, kind) + "/bytes"]
            assert whole["max_full"] == whole["full"] == b["full"]
