"""The per-period gather (``gather="period"`` on the mesh steps of
``repro_torch.launch.train``) against the whole-learner gather
(``gather="whole"``), the step it replaces.

One subprocess spawns 4 gloo ranks on the CPU.  On (2, 2) and (1, 4)
meshes each case builds the same step twice, ``"whole"`` and
``"period"``, from the same initial shards (each learner from its own
seed), and runs 2 steps on the same numpy batches (4 rows of 16 tokens a
learner):

  * transformer-100m's smoke config: DPSGD ring and random_pair (the
    matchings injected), SSGD and AD-PSGD (a 3x straggler) on (2, 2),
    where the MLP weights ``periods/l0/mlp/w1..w3`` (Np = 2, M = 2) are
    cut on the period dim (``leaf_spec`` gives ``P('model', None,
    None)``), so each period of them lives on one model rank; DPSGD
    (one learner, no gossip) and SSGD on (1, 4), where AD-PSGD has no
    partner (its hypercube needs two learners);
  * granite-moe-3b-a800m's smoke config (``moe_backend="shard_map"``) on
    (2, 2) and (1, 4): the expert-parallel all-to-all runs inside every
    period's forward, its recompute and its backward.

Held: every rank's parameter shard, momentum and (AD-PSGD) buffer
bitwise equal to the whole gather's (over two model ranks every sum is
one addition; on (1, 4) these configs' sums keep their order too, which
gloo does not promise for every size: jamba's smoke config there reads
2.3e-13 on one rank); the model group's collectives a
step exactly what the layout says (``ShardLayout`` sections: the
non-period leaves once, each period twice -- the forward, then the
recompute -- and its gradient once); the largest full buffer at most one
period plus the non-period leaves.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_RANKS, B, SEQ, STEPS = 4, 4, 16, 2

CASES = [  # (name, mesh, config, algo, topology)
    ("2x2-dpsgd-ring", (2, 2), "transformer-100m", "dpsgd", "ring"),
    ("2x2-dpsgd-random_pair", (2, 2), "transformer-100m", "dpsgd",
     "random_pair"),
    ("2x2-ssgd", (2, 2), "transformer-100m", "ssgd", None),
    ("2x2-adpsgd", (2, 2), "transformer-100m", "adpsgd", None),
    ("1x4-dpsgd-ring", (1, 4), "transformer-100m", "dpsgd", "ring"),
    ("1x4-ssgd", (1, 4), "transformer-100m", "ssgd", None),
    ("2x2-moe-dpsgd-ring", (2, 2), "granite-moe-3b-a800m", "dpsgd", "ring"),
    ("1x4-moe-ssgd", (1, 4), "granite-moe-3b-a800m", "ssgd", None),
]

SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, port, src, dst):
    torch.set_num_threads(1)
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core import dpsgd as dp
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.mesh import learner_rank, make_test_mesh
    from repro_torch.launch.train import (
        make_adpsgd_train_step, make_dpsgd_train_step, make_ssgd_train_step)
    from repro_torch.models import build_model, moe_shardmap

    init_learner_group(rank, N_RANKS, f"tcp://127.0.0.1:{port}",
                       device="cpu", backend="gloo")
    meshes = {s: make_test_mesh(*s) for s in ((2, 2), (1, 4))}
    inp = np.load(src)
    out, info = {}, {}
    for name, shape, arch, algo, topo in CASES:
        mesh = meshes[tuple(shape)]
        cfg = get_config(arch).smoke_config()
        if "moe" in arch:
            cfg = dataclasses.replace(cfg, moe_backend="shard_map",
                                      capacity_factor=64.0)
        api = build_model(cfg, device="cpu")
        i = learner_rank(mesh)
        tree = api.param_tree(api.init(i))

        def batch(t):
            return {k: torch.tensor(inp[k][t][i * B:(i + 1) * B])
                    for k in ("tokens", "labels", "mask")}

        for gather in ("whole", "period"):
            opt = optim.sgd(0.1, momentum=0.9)
            kw = dict(mesh=mesh, device="cpu", gather=gather)
            rounds = None
            if algo == "ssgd":
                step = make_ssgd_train_step(api, opt, **kw)
            elif algo == "adpsgd":
                step = make_adpsgd_train_step(
                    api, opt, max_staleness=2, slow_learner=0,
                    slow_factor=3, **kw)
            else:
                step = make_dpsgd_train_step(api, opt, topology=topo, **kw)
                if topo == "random_pair":
                    rounds = [[dp.pair_tables(p)] for p in inp["partners"]]
            state = step.init(tree)
            if algo == "adpsgd":
                state.buffer.copy_(state.params)
            per_step, a2a = [], []
            for t in range(STEPS):
                k0, c0 = step.model_kinds, moe_shardmap.all_to_all.calls
                args = () if rounds is None else (rounds[t],)
                state, m = step(state, batch(t), *args)
                per_step.append({k: v - k0.get(k, 0)
                                 for k, v in step.model_kinds.items()})
                a2a.append(moe_shardmap.all_to_all.calls - c0)
            key = f"{name}/{gather}/{rank}"
            out[key + "/params"] = state.params.numpy()
            out[key + "/mu"] = step.optimizer.fused.read_mu(
                state.opt_state).numpy()
            if state.buffer is not None:
                out[key + "/buffer"] = state.buffer.numpy()
            lay = step._layout
            info[key] = {
                "kinds": per_step, "all_to_all": a2a,
                "loss": float(m["loss"]),
                "max_full_bytes": step.max_full_bytes,
                "n_periods": lay.n_periods,
                "period": {"ag": lay.period.ag, "own": lay.period.own,
                           "bytes": lay.period.meta.n_elem * 4},
                "rest": {"ag": lay.rest.ag, "own": lay.rest.own,
                         "bytes": lay.rest.meta.n_elem * 4},
                "own_leaves": [lay.paths[x] for x, k in zip(
                    lay.period.leaves, lay.period.kinds) if k == "own"]}
    # a staged all_gather past the staging bound goes in element ranges
    from repro_torch.launch import shardstore
    from repro_torch.launch.mesh import model_group

    class Direct:                   # the staging's interface, run in place
        def run(self, op, key, out, inp):
            op(out, inp)

    comm = shardstore.GroupComm(model_group(meshes[(1, 4)]), "cpu")
    comm._staging = Direct()
    local = torch.arange(1000, dtype=torch.float32) + 1000 * rank
    whole = torch.empty((4, 1000))
    comm.all_gather(local, whole)
    bound, shardstore.STAGE_BYTES = shardstore.STAGE_BYTES, 4 * 4 * 300
    ranged = torch.empty((4, 1000))
    comm.all_gather(local, ranged)
    shardstore.STAGE_BYTES = bound
    info["staged_ranges"] = {"equal": bool(torch.equal(whole, ranged)),
                             "calls": comm.calls, "bytes": comm.bytes}
    np.savez(f"{dst}/rank{rank}.npz", **out)
    with open(f"{dst}/rank{rank}.json", "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    src, dst, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
    mp.start_processes(rank_main, args=(port, src, dst), nprocs=N_RANKS,
                       start_method="spawn")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("period_gather")
    rng = np.random.default_rng(0)
    shape = (STEPS, 2 * B, SEQ)
    np.savez(d / "inputs.npz",
             tokens=rng.integers(0, 512, shape).astype(np.int32),
             labels=rng.integers(0, 512, shape).astype(np.int32),
             mask=np.ones(shape, np.float32),
             partners=np.array([[1, 0]] * STEPS, np.int32))
    consts = (f"N_RANKS, B, STEPS = {N_RANKS}, {B}, {STEPS}\n"
              f"CASES = {CASES!r}\n")
    (d / "run.py").write_text(consts + SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, str(d / "run.py"),
                        str(d / "inputs.npz"), str(d), str(_free_port())],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return ([np.load(d / f"rank{r}.npz") for r in range(N_RANKS)],
            [json.loads((d / f"rank{r}.json").read_text())
             for r in range(N_RANKS)])


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES)
def test_period_gather_is_bitwise_the_whole_gather(runs, name):
    ranks, info = runs
    for r, rk in enumerate(ranks):
        for what in ("params", "mu", "buffer"):
            key = f"{name}/whole/{r}/{what}"
            if key not in rk.files:
                assert what == "buffer"
                continue
            np.testing.assert_array_equal(
                rk[f"{name}/period/{r}/{what}"], rk[key],
                err_msg=f"{name} rank {r} {what}")
        assert info[r][f"{name}/period/{r}"]["loss"] \
            == info[r][f"{name}/whole/{r}"]["loss"]


def test_a_leaf_cut_on_the_period_dim_takes_the_broadcast(runs):
    """transformer-100m at M = 2: the MLP weights live a period a rank;
    at M = 4 (Np = 2) nothing is cut on the period dim."""
    _, info = runs
    for r, i in enumerate(info):
        own = i[f"2x2-dpsgd-ring/period/{r}"]["own_leaves"]
        assert sorted("/".join(p[1:]) for p in own) == [
            "l0/mlp/w1", "l0/mlp/w2", "l0/mlp/w3"]
        assert i[f"1x4-dpsgd-ring/period/{r}"]["own_leaves"] == []


@pytest.mark.parametrize("name", NAMES)
def test_collectives_a_step_are_what_the_layout_says(runs, name):
    """``"whole"``: one all_gather, one reduce_scatter, one all_reduce.
    ``"period"``: the non-period leaves' all_gather and reduce_scatter
    once; per period an all_gather (and a broadcast where a leaf is cut on
    the period dim) in the forward and again in the recompute, and a
    reduce_scatter (and a reduce) of its gradient; one all_reduce."""
    _, info = runs
    for r, i in enumerate(info):
        whole = i[f"{name}/whole/{r}"]
        rec = i[f"{name}/period/{r}"]
        assert whole["kinds"] == [{"all_gather": 1, "reduce_scatter": 1,
                                   "all_reduce": 1}] * STEPS
        Np, per, rest = rec["n_periods"], rec["period"], rec["rest"]
        want = {"all_gather": (rest["ag"] > 0) + 2 * Np * (per["ag"] > 0),
                "broadcast": 2 * Np * (per["own"] > 0),
                "reduce_scatter": (rest["ag"] > 0) + Np * (per["ag"] > 0),
                "reduce": Np * (per["own"] > 0), "all_reduce": 1}
        want = {k: v for k, v in want.items() if v}
        assert rec["kinds"] == [want] * STEPS, (name, r)


def test_the_moe_all_to_all_runs_again_in_the_recompute(runs):
    """granite-moe: each period's forward is recomputed in the backward,
    its all-to-alls with it, on every rank alike."""
    _, info = runs
    for name in ("2x2-moe-dpsgd-ring", "1x4-moe-ssgd"):
        counts = {(i[f"{name}/whole/{r}"]["all_to_all"][0],
                   i[f"{name}/period/{r}"]["all_to_all"][0])
                  for r, i in enumerate(info)}
        assert len(counts) == 1, counts
        (whole, period), = counts
        assert whole > 0 and period > whole, (name, whole, period)


@pytest.mark.parametrize("name", NAMES)
def test_the_largest_full_buffer_is_a_period_and_the_rest(runs, name):
    _, info = runs
    for r, i in enumerate(info):
        rec, whole = i[f"{name}/period/{r}"], i[f"{name}/whole/{r}"]
        bound = rec["period"]["bytes"] + rec["rest"]["bytes"]
        assert 0 < rec["max_full_bytes"] <= bound
        assert rec["max_full_bytes"] < whole["max_full_bytes"]


def test_a_staged_gather_past_its_bound_goes_in_ranges(runs):
    """``GroupComm.all_gather`` through the staging (here a stand-in that
    runs the collective in place) in ranges of at most ``STAGE_BYTES`` of
    stack: the same stack, one call and the same bytes in the counts."""
    _, info = runs
    for i in info:
        assert i["staged_ranges"] == {"equal": True, "calls": 2,
                                      "bytes": 2 * 3 * 1000 * 4}
