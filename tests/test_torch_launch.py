"""The launch path on ``torch.distributed`` (``repro_torch.launch``) against
the JAX reference's launch step builders and the port's trainer.

Two runs start together from one input file made here with numpy and the
reference's own initializer: the stacked initial parameters of
transformer-100m's smoke config for 4 learners (``jax.vmap(api.init)``),
seeded token batches (seq 64, local batch 2) and the matchings the
reference's ``random_pair`` step realizes at steps 0-2:

  * the reference: one subprocess with 4 forced host devices and an
    Auto-axis (4, 1) ``("data", "model")`` mesh.
    ``make_dpsgd_train_step(gossip_backend="einsum")`` runs 3 steps on
    ring, exp, one_peer_exp, torus, hierarchical and random_pair with
    ``sgd(0.1, momentum=0.9)`` under phase 4's warm-up schedule, and on
    ring with ``decentlam`` (the unfused route, ``wants_mixed``);
    ``make_ssgd_train_step`` runs 2 steps.  Its ``shard_map`` paths (the
    ppermute backend, AD-PSGD) do not run under jax 0.9, so AD-PSGD is
    held against the port's ``MultiLearnerTrainer`` fed the hypercube
    tables instead;
  * the port: one subprocess spawning 4 gloo ranks on the CPU that run
    the same cases (random_pair's tables injected through ``rounds=``),
    the ppermute backend, the per-leaf exchange, AD-PSGD (staleness 4, a
    3x straggler) and elastic AD-PSGD under a crash, a rejoin, a
    straggler and a dropped round.

Tiers: the two frameworks run the same float32 algebra but sum matrix
products and the mixing in other orders, so parameters and momentum are
held to the trainer's tier, 1e-5 absolute + 1e-4 relative
(``tests/test_torch_trainer.py``; measured here at most 9.4e-8 absolute
on parameters and 5.3e-7 on momentum after 3 DPSGD steps, 3.8e-8 and
1.8e-7 after 2 SSGD steps), losses to 1e-5 relative (measured 1.5e-7).
The port's launch step against the port's trainer runs the same kernels'
plain versions on gradients summed in other thread counts: the same tier
(measured 3.0e-8).  Two exchanges of the same values (ppermute on
random_pair and on ring; the per-leaf and the flat exchange) agree
bitwise.
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
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.core import (AlgoConfig, FaultEvent, FaultPlan,  # noqa: E402
                              Membership, MultiLearnerTrainer, apply_plan,
                              flat_meta)
from repro_torch.core import dpsgd as dp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, B, SEQ = 4, 2, 64
STEPS, SSGD_STEPS, TICKS = 3, 2, 8
TOPOLOGIES = ("ring", "exp", "one_peer_exp", "torus", "hierarchical",
              "random_pair")
DETERMINISTIC = TOPOLOGIES[:-1]
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_RTOL = 1e-5
ELASTIC_PLAN = FaultPlan(FaultPlan.crash_rejoin(1, 2, 6).events
                         + FaultPlan.straggler(0, 3).events
                         + (FaultEvent(4, "drop_round"),))

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro import optim
from repro.configs import get_config
from repro.core.flatstate import flat_meta
from repro.core.schedule import make_schedule
from repro.launch.train import (PjitTrainState, make_dpsgd_train_step,
                                make_ssgd_train_step)
from repro.models.model import build_model

src, dst = sys.argv[1], sys.argv[2]
inp = np.load(src)


def load_tree(prefix):
    out = {}
    for k in inp.files:
        if k.startswith(prefix):
            node = out
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(inp[k])
    return out


def batch(t, rows=slice(None)):
    return {k: jnp.asarray(inp[k][t][rows]) for k in ("tokens", "labels",
                                                      "mask")}


def fused():
    return optim.scale_by_schedule(optim.sgd(0.1, momentum=0.9),
                                   optim.warmup_linear_scale(10, 1.0))


def mu_of(opt_state):
    return opt_state["inner"]["mu"] if "inner" in opt_state \
        else opt_state["mu"]


params = load_tree("p/")
mesh = jax.make_mesh((N, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
api = build_model(get_config("transformer-100m").smoke_config())
single = jax.tree_util.tree_map(lambda x: x[0], params)
meta = flat_meta(single)
out = {}
cases = [(t, t, fused()) for t in TOPOLOGIES] + [
    ("decentlam_ring", "ring", optim.decentlam(0.1, 0.9))]
for name, topo, opt in cases:
    step = jax.jit(make_dpsgd_train_step(api, opt, mesh, topology=topo,
                                         gossip_backend="einsum"))
    state = PjitTrainState(params, jax.vmap(opt.init)(params),
                           jnp.int32(0), jax.random.PRNGKey(1))
    losses = []
    with mesh:
        for t in range(STEPS):
            state, m = step(state, batch(t))
            losses.append(float(m["loss"]))
    out[f"dpsgd/{name}/params"] = np.asarray(meta.flatten(state.params))
    out[f"dpsgd/{name}/mu"] = np.asarray(meta.flatten(mu_of(state.opt_state)))
    out[f"dpsgd/{name}/loss"] = np.asarray(losses)
sched = make_schedule("random_pair", N)
out["random_pair/matrices"] = np.stack([np.asarray(sched.step_matrix(
    jax.random.fold_in(jax.random.PRNGKey(1), t), t)) for t in range(STEPS)])
opt = fused()
step = jax.jit(make_ssgd_train_step(api, opt, mesh))
state = PjitTrainState(single, opt.init(single), jnp.int32(0),
                       jax.random.PRNGKey(1))
losses = []
with mesh:
    for t in range(SSGD_STEPS):
        state, m = step(state, batch(t))
        losses.append(float(m["loss"]))
out["ssgd/params"] = np.asarray(meta.flatten(state.params))
out["ssgd/mu"] = np.asarray(meta.flatten(mu_of(state.opt_state)))
out["ssgd/loss"] = np.asarray(losses)
np.savez(dst, **out)
"""

PORT_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


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


def rank_main(rank, port, src, dst):
    torch.set_num_threads(1)
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core import FaultEvent, FaultPlan, Membership, apply_plan
    from repro_torch.core import dpsgd as dp
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.train import (
        make_adpsgd_train_step, make_dpsgd_train_step, make_ssgd_train_step,
        membership_operands, rank_state_from_numpy)
    from repro_torch.models import build_model

    init_learner_group(rank, N, f"tcp://127.0.0.1:{port}", device="cpu",
                       backend="gloo")
    inp = np.load(src)
    params = load_tree(inp, "p/")
    api = build_model(get_config("transformer-100m").smoke_config(),
                      device="cpu")
    B = inp["tokens"].shape[1] // N

    def batch(t):
        return {k: torch.tensor(inp[k][t % STEPS][rank * B:(rank + 1) * B])
                for k in ("tokens", "labels", "mask")}

    def fused():
        return optim.scale_by_schedule(optim.sgd(0.1, momentum=0.9),
                                       optim.warmup_linear_scale(10, 1.0))

    rp_rounds = [[dp.pair_tables(p)] for p in inp["rp_partners"]]
    out, info = {}, {}

    def mu_of(step, state):
        f = step.optimizer.fused
        return (f.read_mu(state.opt_state) if f is not None
                else state.opt_state["mu"])

    def run(name, step, state, steps, rounds=None, each=None):
        losses, slots = [], []
        for t in range(steps):
            if rounds is not None:
                state, m = step(state, batch(t), rounds[t])
            else:
                state, m = step(state, batch(t))
            losses.append(float(m["loss"]))
            slots.append(step.last_rounds)
            if each is not None:
                each(t, state, m)
        out[name + "/params"] = state.params[0].clone().numpy()
        info[name] = {"loss": losses, "rounds": slots,
                      "collectives": step.collectives,
                      "sends": step.sends, "recvs": step.recvs,
                      "bytes": step.bytes_received}
        return state

    for name, topo, opt, backend, fuse in (
            [(f"dpsgd/{t}", t, fused(), "einsum", "flat")
             for t in TOPOLOGIES]
            + [("dpsgd/decentlam_ring", "ring", optim.decentlam(0.1, 0.9),
                "einsum", "flat")]
            + [(f"ppermute/{t}", t, fused(), "ppermute", "flat")
               for t in TOPOLOGIES]
            + [("leaf/hierarchical", "hierarchical", fused(), "ppermute",
                "leaf")]):
        step = make_dpsgd_train_step(api, opt, topology=topo,
                                     gossip_backend=backend,
                                     gossip_fuse=fuse, device="cpu")
        state = rank_state_from_numpy(step, params)
        state = run(name, step, state, STEPS,
                    rp_rounds if (topo == "random_pair"
                                  and backend == "einsum") else None)
        out[name + "/mu"] = mu_of(step, state)[0].clone().numpy()

    step = make_ssgd_train_step(api, fused(), device="cpu")
    state = rank_state_from_numpy(step, _broadcast_row0(params))
    state = run("ssgd", step, state, SSGD_STEPS)
    out["ssgd/mu"] = mu_of(step, state)[0].clone().numpy()

    step = make_adpsgd_train_step(api, fused(), max_staleness=4,
                                  slow_learner=0, slow_factor=3,
                                  device="cpu")
    state = rank_state_from_numpy(step, params, buffer=params)
    state = run("adpsgd", step, state, TICKS)
    out["adpsgd/buffer"] = state.buffer[0].clone().numpy()
    out["adpsgd/mu"] = mu_of(step, state)[0].clone().numpy()
    info["adpsgd"].update(age=state.age.tolist(), clock=state.clock.tolist())

    plan = FaultPlan(FaultPlan.crash_rejoin(1, 2, 6).events
                     + FaultPlan.straggler(0, 3).events
                     + (FaultEvent(4, "drop_round"),))
    mem = Membership(N)
    step = make_adpsgd_train_step(api, fused(), max_staleness=4,
                                  elastic=True, device="cpu")
    state = rank_state_from_numpy(step, params, buffer=params)
    elastic = {"n_active": [], "staleness_max": [], "finite": []}
    kept = {}
    for t in range(TICKS):
        drop = apply_plan(mem, plan, t)
        state = state._replace(**membership_operands(mem, drop_round=drop))
        state, m = step(state, batch(t))
        elastic["n_active"].append(float(m["n_active"]))
        elastic["staleness_max"].append(float(m["staleness_max"]))
        elastic["finite"].append(bool(torch.isfinite(m["loss"])))
        elastic.setdefault("rounds", []).append(step.last_rounds)
        if t in (2, 5):
            kept[t] = (state.params.clone(), state.buffer.clone(),
                       mu_of(step, state).clone())
    elastic["frozen"] = all(torch.equal(a, b)
                            for a, b in zip(kept[2], kept[5]))
    out["elastic/params"] = state.params[0].clone().numpy()
    out["elastic/buffer"] = state.buffer[0].clone().numpy()
    elastic.update(age=state.age.tolist(), clock=state.clock.tolist())
    info["elastic"] = elastic

    sub = dist.new_group([0, 1, 2])
    if rank < 3:
        try:
            make_adpsgd_train_step(api, fused(), sub, device="cpu")
            info["hypercube_of_3"] = "built"
        except ValueError as e:
            info["hypercube_of_3"] = str(e)
    np.savez(f"{dst}/rank{rank}.npz", **out)
    with open(f"{dst}/rank{rank}.json", "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


def _broadcast_row0(tree):
    if isinstance(tree, dict):
        return {k: _broadcast_row0(v) for k, v in tree.items()}
    return np.broadcast_to(tree[:1], tree.shape)


if __name__ == "__main__":
    src, dst, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
    mp.start_processes(rank_main, args=(port, src, dst), nprocs=N,
                       start_method="spawn")
"""


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


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The shared inputs: the reference's stacked initial parameters, the
    batches and random_pair's matchings, as numpy."""
    d = tmp_path_factory.mktemp("launch")
    jcfg = jax_get_config("transformer-100m").smoke_config()
    japi = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jax.vmap(japi.init)(
        jax.random.split(jax.random.PRNGKey(0), N)))
    rng = np.random.default_rng(0)
    shape = (STEPS, N * B, SEQ)
    arrays = {f"p/{k}": v for k, v in _paths(params).items()}
    arrays.update(
        tokens=rng.integers(0, jcfg.vocab, shape).astype(np.int32),
        labels=rng.integers(0, jcfg.vocab, shape).astype(np.int32),
        mask=np.ones(shape, np.float32),
        rp_partners=np.stack([np.asarray(jax_topo.pair_partners(
            jax.random.fold_in(jax.random.PRNGKey(1), t), N))
            for t in range(STEPS)]))
    np.savez(d / "inputs.npz", **arrays)
    return d, params, arrays


@pytest.fixture(scope="module")
def runs(inputs):
    """Both sides, started together; returns (reference npz, [rank npz],
    [rank info])."""
    d, _, _ = inputs
    consts = (f"TOPOLOGIES = {TOPOLOGIES!r}\nN, STEPS, SSGD_STEPS, TICKS = "
              f"{N}, {STEPS}, {SSGD_STEPS}, {TICKS}\n")
    (d / "ref.py").write_text(consts + REF_SCRIPT)
    (d / "port.py").write_text(consts + PORT_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(d / script)] + args, cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for script, args in (
            ("ref.py", [str(d / "inputs.npz"), str(d / "ref.npz")]),
            ("port.py", [str(d / "inputs.npz"), str(d),
                         str(_free_port())]))]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    ref = np.load(d / "ref.npz")
    ranks = [np.load(d / f"rank{r}.npz") for r in range(N)]
    info = [json.loads((d / f"rank{r}.json").read_text()) for r in range(N)]
    return ref, ranks, info


def _stacked(ranks, key):
    return np.stack([r[key] for r in ranks])


# ---------------------------------------------------------------------------
# DPSGD and SSGD against the reference's launch step builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES + ("decentlam_ring",))
def test_dpsgd_einsum_matches_the_reference_launch_step(runs, name):
    ref, ranks, info = runs
    for what in ("params", "mu"):
        np.testing.assert_allclose(
            _stacked(ranks, f"dpsgd/{name}/{what}"),
            ref[f"dpsgd/{name}/{what}"], **PARAM_TOL,
            err_msg=f"{name} {what}")
    np.testing.assert_allclose(info[0][f"dpsgd/{name}"]["loss"],
                               ref[f"dpsgd/{name}/loss"], rtol=LOSS_RTOL)


def test_random_pair_tables_are_the_reference_realized_matchings(inputs,
                                                                  runs):
    """The injected matchings are the ones the reference's step drew."""
    _, _, arrays = inputs
    ref, _, _ = runs
    for t, partner in enumerate(arrays["rp_partners"]):
        m = 0.5 * (np.eye(N) + np.eye(N)[partner])
        np.testing.assert_array_equal(ref["random_pair/matrices"][t], m)


@pytest.mark.parametrize("topo", DETERMINISTIC)
def test_ppermute_on_a_deterministic_schedule_gives_the_einsum_result(
        runs, topo):
    ref, ranks, _ = runs
    np.testing.assert_allclose(_stacked(ranks, f"ppermute/{topo}/params"),
                               ref[f"dpsgd/{topo}/params"], **PARAM_TOL)
    np.testing.assert_allclose(_stacked(ranks, f"ppermute/{topo}/params"),
                               _stacked(ranks, f"dpsgd/{topo}/params"),
                               **PARAM_TOL)


def test_ppermute_on_random_pair_runs_the_ring(runs):
    _, ranks, info = runs
    np.testing.assert_array_equal(
        _stacked(ranks, "ppermute/random_pair/params"),
        _stacked(ranks, "ppermute/ring/params"))
    assert info[0]["ppermute/random_pair"]["rounds"] == \
        info[0]["ppermute/ring"]["rounds"]


def test_the_per_leaf_exchange_equals_the_flat_one(runs, inputs):
    _, ranks, info = runs
    np.testing.assert_array_equal(
        _stacked(ranks, "leaf/hierarchical/params"),
        _stacked(ranks, "ppermute/hierarchical/params"))
    leaves = len(_paths(inputs[1]))
    flat = info[0]["ppermute/hierarchical"]
    leaf = info[0]["leaf/hierarchical"]
    assert leaf["recvs"] == leaves * flat["recvs"]
    assert leaf["sends"] == leaves * flat["sends"]


def test_ssgd_matches_the_reference_with_one_all_reduce_a_step(runs):
    ref, ranks, info = runs
    got = _stacked(ranks, "ssgd/params")
    for r in range(N):      # the weights stay replicated bitwise
        np.testing.assert_array_equal(got[r], got[0])
    np.testing.assert_allclose(got[0], ref["ssgd/params"], **PARAM_TOL)
    np.testing.assert_allclose(_stacked(ranks, "ssgd/mu")[0], ref["ssgd/mu"],
                               **PARAM_TOL)
    np.testing.assert_allclose(info[0]["ssgd"]["loss"], ref["ssgd/loss"],
                               rtol=LOSS_RTOL)
    for i in info:
        assert i["ssgd"]["collectives"] == SSGD_STEPS
        assert i["ssgd"]["sends"] == i["ssgd"]["recvs"] == 0


# ---------------------------------------------------------------------------
# point-to-point ops: one send and one receive per live slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", DETERMINISTIC)
def test_p2p_ops_per_round_are_the_non_padded_slots(runs, topo):
    """The twin of tests/test_gossip_schedule_launch.py: the ppermute
    backend posts, per round, one send and one receive per slot that the
    reference's ``_schedule_perms`` issues a collective-permute for, and
    none for a padded slot; the bytes are one wire-dtype store a receive."""
    from repro.core.dpsgd import _schedule_perms
    from repro.core.schedule import make_schedule as jax_make_schedule
    _, ranks, info = runs
    s = jax_make_schedule(topo, N)
    perms = _schedule_perms(s)
    store = ranks[0][f"ppermute/{topo}/params"].nbytes
    for rank, i in enumerate(info):
        rec = i[f"ppermute/{topo}"]
        for t, rounds in enumerate(rec["rounds"]):
            assert len(rounds) == s.rounds_per_step
            for j, (sends, recvs) in enumerate(rounds):
                r = (t * s.rounds_per_step + j) % s.period \
                    if s.time_varying else j % s.period
                live = [dict((dst, src) for src, dst in p)
                        for p in perms[r] if p is not None]
                assert recvs == sum(p[rank] != rank for p in live), \
                    (topo, t, j)
                assert sends == sum(src == rank and dst != rank
                                    for p in live
                                    for dst, src in p.items()), (topo, t, j)
        assert rec["bytes"] == rec["recvs"] * store


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_einsum_p2p_ops_are_the_step_matrix_support(runs, topo):
    """The einsum backend receives each row its row of the step's matrix
    reads (and sends its row to each rank whose row reads it): one round a
    step, one kernel launch."""
    from repro.core.schedule import make_schedule as jax_make_schedule
    ref, _, info = runs
    s = jax_make_schedule(topo, N)
    for rank, i in enumerate(info):
        for t, rounds in enumerate(i[f"dpsgd/{topo}"]["rounds"]):
            m = (ref["random_pair/matrices"][t] if s.randomized
                 else np.asarray(s.step_matrix(None, t)))
            off = (m != 0) & ~np.eye(N, dtype=bool)
            assert rounds == [[int(off[:, rank].sum()),
                               int(off[rank].sum())]], (topo, t)


# ---------------------------------------------------------------------------
# AD-PSGD against the port's trainer fed the hypercube tables
# ---------------------------------------------------------------------------

def _trainer_run(params, arrays, elastic):
    api = build_model(get_config("transformer-100m").smoke_config(),
                      device="cpu")
    opt = optim.scale_by_schedule(optim.sgd(0.1, momentum=0.9),
                                  optim.warmup_linear_scale(10, 1.0))
    algo = AlgoConfig(algo="adpsgd", topology="random_pair", n_learners=N,
                      max_staleness=4,
                      **({} if elastic else dict(slow_learner=0,
                                                 slow_factor=3)))
    tr = MultiLearnerTrainer(api.loss_fn, opt, algo,
                             params_from_tree=api.params_from_tree,
                             device="cpu")
    single = tree_from_jax(jax.tree_util.tree_map(lambda a: a[0], params))
    state = tr.init(0, single)
    meta = flat_meta(single)
    stacked = meta.flatten(tree_from_jax(params))
    state.params.copy_(stacked)
    state.buffer.copy_(stacked)
    mem = Membership(N)
    record = {"n_active": [], "staleness_max": []}
    for t in range(TICKS):
        batch = {k: torch.tensor(arrays[k][t % STEPS]).reshape(
            (N, B) + arrays[k].shape[2:]) for k in ("tokens", "labels",
                                                    "mask")}
        gate = None
        if elastic:
            drop = apply_plan(mem, ELASTIC_PLAN, t)
            state = tr.set_membership(state, mem, drop_round=drop)
            gate = mem.active & (not drop)
        state, m = tr.train_step(state, batch,
                                 [dp.hypercube_tables(t, N, gate)])
        record["n_active"].append(float(m.n_active))
        record["staleness_max"].append(float(m.staleness_max))
    return state, record


@pytest.mark.parametrize("elastic", [False, True],
                         ids=["straggler", "elastic"])
def test_adpsgd_matches_the_trainer_fed_hypercube_tables(inputs, runs,
                                                         elastic):
    _, params, arrays = inputs
    _, ranks, info = runs
    state, record = _trainer_run(params, arrays, elastic)
    key = "elastic" if elastic else "adpsgd"
    np.testing.assert_allclose(_stacked(ranks, f"{key}/params"),
                               state.params.numpy(), **PARAM_TOL)
    np.testing.assert_allclose(_stacked(ranks, f"{key}/buffer"),
                               state.buffer.numpy(), **PARAM_TOL)
    np.testing.assert_array_equal(info[0][key]["age"], state.age.numpy())
    np.testing.assert_array_equal(info[0][key]["clock"],
                                  state.clock.numpy())
    if elastic:
        assert info[0][key]["n_active"] == record["n_active"]
        assert info[0][key]["staleness_max"] == record["staleness_max"]


def test_elastic_membership_on_the_launch_path(runs):
    """The reference's ``test_elastic_membership_on_launch_path``: finite
    losses, the live count tracks the plan (crash at tick 2, rejoin at
    6), the crashed rank's rows bitwise frozen while dead, and a pair with
    a dead end, or a dropped round, posts no op."""
    _, _, info = runs
    el = [i["elastic"] for i in info]
    assert all(el[0]["finite"])
    assert el[0]["n_active"] == [4, 4, 3, 3, 3, 3, 4, 4]
    assert el[1]["frozen"]
    for t in range(TICKS):
        live = np.ones(N, bool)
        if 2 <= t < 6:
            live[1] = False
        partner = [dp.hypercube_partner(r, t, N) for r in range(N)]
        for r in range(N):
            pairs = t != 4 and live[r] and live[partner[r]]
            assert el[r]["rounds"][t] == ([[1, 1]] if pairs else [[0, 0]]), \
                (t, r)


def test_the_hypercube_needs_a_power_of_two_group(runs):
    _, _, info = runs
    for i in info[:3]:
        assert "power-of-two" in i["hypercube_of_3"]
    with pytest.raises(ValueError, match="power-of-two"):
        dp.hypercube_partner(0, 0, 6)


# ---------------------------------------------------------------------------
# pieces that need no process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_analytic_counts_equal_the_reference(name):
    from repro.launch import analytic as ja
    from repro_torch.launch import analytic as pa
    p, j = get_config(name), jax_get_config(name)
    assert (p.n_params(), p.n_active_params()) == (j.n_params(),
                                                   j.n_active_params())
    for gb, seq, chips, learners in ((8, 512, 4, 4), (256, 4096, 256, 16)):
        assert pa.train_flops_per_chip(p, gb, seq, chips) == \
            ja.train_flops_per_chip(j, gb, seq, chips)
        assert pa.prefill_flops_per_chip(p, gb, seq, chips) == \
            ja.prefill_flops_per_chip(j, gb, seq, chips)
        for capped in (False, True):
            assert pa.decode_flops_per_chip(
                p, gb, seq, chips, window_capped=capped) == \
                ja.decode_flops_per_chip(j, gb, seq, chips,
                                         window_capped=capped)
            assert pa.decode_bytes_per_chip(
                p, gb, seq, chips, window_capped=capped) == \
                ja.decode_bytes_per_chip(j, gb, seq, chips,
                                         window_capped=capped)
        assert pa.train_bytes_per_chip(p, gb, seq, chips, learners, 2) == \
            ja.train_bytes_per_chip(j, gb, seq, chips, learners, 2)
        assert pa.prefill_bytes_per_chip(p, gb, seq, chips) == \
            ja.prefill_bytes_per_chip(j, gb, seq, chips)
        for backend in ("einsum", "ppermute"):
            assert pa.gossip_link_bytes_per_chip(p, chips, learners,
                                                 backend) == \
                ja.gossip_link_bytes_per_chip(j, chips, learners, backend)


@pytest.mark.parametrize("publish", [False, True], ids=["plain", "publish"])
def test_plain_update_over_a_remote_stack_of_other_rows(publish):
    """``ops.flat_gossip_update`` with a remote stack of R != n rows (the
    launch path's received rows) equals the reference's plain version."""
    from repro.kernels.ref import gossip_mix_update_flat_ref as jax_ref
    rng = np.random.default_rng(3)
    n, R, T = (1, 1, 16) if publish else (2, 3, 16)
    K = 1 if publish else 2
    w, g, mu, buf = (rng.standard_normal((n, T, 128), dtype=np.float32)
                     for _ in range(4))
    remote = rng.standard_normal((R, T, 128), dtype=np.float32)
    partners = rng.integers(0, R, (K, n)).astype(np.int32)
    cols = [rng.random((n, K + 1)), np.full((n, 1), 0.7),
            np.ones((n, 1))]
    if publish:
        cols += [np.ones((n, 1)), np.ones((n, 1))]
    coefs = np.concatenate(cols, axis=1).astype(np.float32)
    kw = dict(lr=0.05, beta=0.9, weight_decay=0.01)
    got = ops.flat_gossip_update(
        *[torch.tensor(a) for a in (w, remote, g, mu.copy(), partners,
                                    coefs)],
        buffer=torch.tensor(buf) if publish else None, **kw)
    want = jax_ref(w, remote, g, mu, partners, coefs,
                   buffer=buf if publish else None, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n,R", [(2, 1), (4, 3), (2, 3)])
def test_kernel_wrapper_takes_other_remote_rows_only_at_n_1(n, R):
    """The partner ids are trusted, so a fleet of n > 1 rows must pass all
    n as its remote stack; only the launch path's n = 1 takes R rows (and
    then, on CPU tensors, meets the device check)."""
    from repro_torch.kernels.gossip_mix import gossip_mix_update_flat
    T = 8
    w, g, mu = (torch.zeros((n, T, 128)) for _ in range(3))
    partners = torch.zeros((1, n), dtype=torch.int32)
    coefs = torch.ones((n, 4))
    with pytest.raises(ValueError, match="remote must be"):
        gossip_mix_update_flat(w, torch.zeros((R, T, 128)), g, mu,
                               partners, coefs, lr=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_update_flat(w[:1], torch.zeros((R, T, 128)), g[:1],
                               mu[:1], partners[:, :1], coefs[:1], lr=0.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_over_a_remote_stack_of_other_rows(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    w, grads, mu = (torch.randn((1, 64, 128), generator=g,
                                device=cuda_device) for _ in range(3))
    remote = torch.randn((3, 64, 128), generator=g, device=cuda_device)
    partners = torch.arange(3, dtype=torch.int32,
                            device=cuda_device)[:, None]
    coefs = torch.tensor([[0.4, 0.2, 0.2, 0.2, 1.0, 1.0]],
                         device=cuda_device)
    want = ops.flat_gossip_update(w, remote, grads, mu.clone(), partners,
                                  coefs, lr=0.1, beta=0.9, backend="ref")
    got = ops.flat_gossip_update(w, remote, grads, mu, partners, coefs,
                                 lr=0.1, beta=0.9)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_round_slots_skip_padding_and_match_the_reference_perms():
    """``round_slots`` at every rank reads the permutations the reference's
    ``_schedule_perms`` builds, and nothing for a padded slot."""
    from repro.core.dpsgd import _schedule_perms
    from repro.core.schedule import make_schedule as jax_make_schedule
    for topo in DETERMINISTIC + ("full",):
        for n in (4, 8):
            s = jax_make_schedule(topo, n)
            for r, slots_r in enumerate(_schedule_perms(s)):
                for rank in range(n):
                    got = dp.round_slots(s.partners[r], s.coefs[r], rank)
                    want = [(k, perm) for k, perm in enumerate(slots_r)
                            if perm is not None]
                    assert [sl.k for sl in got] == [k for k, _ in want]
                    for sl, (k, perm) in zip(got, want):
                        src = dict((d, a) for a, d in perm)[rank]
                        assert sl.src == (src if src != rank else -1)
                        assert sl.dsts == tuple(d for a, d in perm
                                                if a == rank and d != rank)


def test_matrix_round_realizes_the_matrix():
    from repro_torch.core.schedule import make_schedule
    for topo in TOPOLOGIES[:-1] + ("full",):
        s = make_schedule(topo, 8)
        for v in range(s.step_mats.shape[0]):
            p, c = dp.matrix_round(s.step_mats[v])
            m = np.zeros((8, 8), np.float32)
            m[np.arange(8), np.arange(8)] += c[:, 0]
            for k in range(p.shape[0]):
                m[np.arange(8), p[k]] += c[:, 1 + k]
            np.testing.assert_array_equal(m, s.step_mats[v])


@pytest.mark.parametrize("shapes,allocs", [
    ([(4, 3), (2, 3), (4, 3)], 1),          # the front rows of one buffer
    ([(2, 3), (5, 3), (3, 3)], 2),          # grown once
    ([(4, 3), (4, 5)], 2),                  # other trailing dims
    ([(), ()], 1),                          # a scalar
    ([(3,), ()], 2),
], ids=["front", "grow", "trailing", "scalar", "rank"])
def test_host_staging_keeps_a_buffer_while_it_fits(monkeypatch, shapes,
                                                   allocs):
    """``HostStaging.buffer`` reuses a buffer while its trailing dims and
    dtype stay and its leading dim suffices; every buffer is pinned."""
    empty, made = torch.empty, []

    def pinned(*a, pin_memory=False, **kw):
        assert pin_memory
        made.append(empty(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch, "empty", pinned)
    st = dp.HostStaging()
    for shape in shapes:
        assert tuple(st.buffer("k", shape, torch.float32).shape) == shape
    assert len(made) == allocs
    st.buffer("k", shapes[-1], torch.float64)
    assert len(made) == allocs + 1


def test_nccl_refuses_cpu_tensors(monkeypatch):
    from repro_torch.launch import init_learner_group
    with pytest.raises(ValueError, match="nccl"):
        init_learner_group(0, 1, "tcp://127.0.0.1:1", device="cpu",
                           backend="nccl")
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    row = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="nccl"):
        dp.exchange(row, [dp.Slot(0, 1, (1,), 0.5)],
                    torch.zeros((1, 8, 128)))


def test_launch_entry_points_default_to_cuda():
    from repro_torch.launch import init_learner_group
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    from repro_torch.launch.train import (make_adpsgd_train_step,
                                          make_dpsgd_train_step,
                                          make_ssgd_train_step)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_learner_group(0, 1, "tcp://127.0.0.1:1", backend="gloo")
    api = build_model(get_config("transformer-100m").smoke_config(),
                      device="cpu")
    for make in (make_dpsgd_train_step, make_adpsgd_train_step,
                 make_ssgd_train_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(api, optim.sgd(0.1))
