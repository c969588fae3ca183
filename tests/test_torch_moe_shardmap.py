"""The expert-parallel MoE (``repro_torch.models.moe_shardmap``) against
the reference's ``moe_forward_shardmap``.

The reference runs its own test's case (``tests/test_moe_shardmap.py``:
E 8, k 2, d 16, ff 32, x (4, 8, 16)) on a (data 2, model 4) mesh of 8
forced host devices, where device (i, j) routes x[2i:2i+2, 2j:2j+2]; the
port runs 4 gloo ranks as one model group of 4 and calls the layer once
per data row i, rank j on the same tokens, so every rank routes the same
tokens with the same capacities.  Outputs, the gradients of sum(y^2) with
respect to the parameters and x, at capacity 64 (nothing dropped) and at
0.5 (binding): 1e-5 absolute + 1e-5 relative (measured at most 5.4e-7 on
outputs of size up to 2.2, 1.05e-5 on gradients of size up to 18, a
relative 6e-7: the two frameworks sum the expert products in other
orders).  At the binding capacity the ranks' own counts show it binds
and that no bucket holds more than its capacity.

``moe_backend="shard_map"`` routes a smoke granite-moe's forward through
the all-to-all under a mesh with a model axis (and through the einsum
path without one), equal to the einsum path at a capacity that drops
nothing.
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
E, K, D, FF, B, S = 8, 2, 16, 32, 4, 8
CAPACITIES = (64.0, 0.5)
TOL = dict(atol=1e-5, rtol=1e-5)

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from repro.models.moe_shardmap import moe_forward_shardmap

inp = np.load(sys.argv[1])
params = {k: jnp.asarray(inp[k]) for k in ("router", "w1", "w3", "w2")}
x = jnp.asarray(inp["x"])
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for cf in CAPACITIES:
    def loss(p, xx):
        return jnp.sum(moe_forward_shardmap(p, xx, n_experts=E, top_k=K,
                                            capacity_factor=cf) ** 2)
    with mesh:
        y = jax.jit(lambda p, xx: moe_forward_shardmap(
            p, xx, n_experts=E, top_k=K, capacity_factor=cf))(params, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    out[f"{cf}/y"] = np.asarray(y)
    out[f"{cf}/x"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"{cf}/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""

PORT_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, port, src, dst):
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import moe_shardmap as ms
    from repro_torch.models.shard_hints import use_mesh

    init_learner_group(rank, 4, f"tcp://127.0.0.1:{port}", device="cpu",
                       backend="gloo")
    mesh = make_mesh((1, 4), ("data", "model"))
    inp = np.load(src)
    out, info = {}, {}
    for cf in CAPACITIES:
        params = {k: torch.tensor(inp[k]).requires_grad_()
                  for k in ("router", "w1", "w3", "w2")}
        total, stats = 0.0, []
        for i in range(2):
            x = torch.tensor(inp["x"][2 * i:2 * i + 2,
                                      2 * rank:2 * rank + 2]
                             ).requires_grad_()
            st = {}
            with use_mesh(mesh):
                y = ms.moe_forward_shardmap(params, x, n_experts=E,
                                            top_k=K, capacity_factor=cf,
                                            stats=st)
            (gx,) = torch.autograd.grad(torch.sum(y ** 2), x,
                                        retain_graph=True)
            total = total + torch.sum(y ** 2)
            out[f"{cf}/y/{i}"] = y.detach().numpy()
            out[f"{cf}/x/{i}"] = gx.numpy()
            stats.append({k: (v.tolist() if torch.is_tensor(v) else v)
                          for k, v in st.items()})
        total.backward()
        for k, v in params.items():
            out[f"{cf}/{k}"] = v.grad.numpy()
        info[str(cf)] = stats

    # the transformer's route: shard_map under the mesh, einsum without
    cfg = dataclasses.replace(
        get_config("granite-moe-3b-a800m").smoke_config(),
        moe_backend="shard_map", capacity_factor=64.0)
    api = build_model(cfg, device="cpu")
    p = api.init(0)
    tokens = torch.tensor(inp["tokens"][rank:rank + 1])
    before = ms.all_to_all.calls
    with use_mesh(mesh):
        sharded = api.apply(p, {"tokens": tokens})
    info["a2a_under_mesh"] = ms.all_to_all.calls - before
    before = ms.all_to_all.calls
    plain = api.apply(p, {"tokens": tokens})
    info["a2a_without_mesh"] = ms.all_to_all.calls - before
    info["route_max_abs_err"] = float((sharded - plain).abs().max())
    info["route_scale"] = float(plain.abs().max())
    np.savez(f"{dst}/rank{rank}.npz", **out)
    with open(f"{dst}/rank{rank}.json", "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    src, dst, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
    mp.start_processes(rank_main, args=(port, src, dst), nprocs=4,
                       start_method="spawn")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_shardmap")
    rng = np.random.default_rng(0)

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    np.savez(d / "inputs.npz", router=dense(D, E), w1=dense(E, D, FF),
             w3=dense(E, D, FF), w2=dense(E, FF, D),
             x=rng.standard_normal((B, S, D)).astype(np.float32),
             tokens=rng.integers(0, 512, (4, 16)).astype(np.int32))
    consts = f"E, K, D, FF = {E}, {K}, {D}, {FF}\nCAPACITIES = {CAPACITIES}\n"
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
    ranks = [np.load(d / f"rank{r}.npz") for r in range(4)]
    info = [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]
    return ref, ranks, info


def _assemble(ranks, key):
    """(4, 8, d): rank j's (2, 2) tile of data row i at [2i:2i+2,
    2j:2j+2]."""
    out = np.zeros((B, S, D), np.float32)
    for j, r in enumerate(ranks):
        for i in range(2):
            out[2 * i:2 * i + 2, 2 * j:2 * j + 2] = r[f"{key}/{i}"]
    return out


@pytest.mark.parametrize("cf", CAPACITIES, ids=["cap64", "binding"])
def test_outputs_match_the_reference(runs, cf):
    ref, ranks, _ = runs
    np.testing.assert_allclose(_assemble(ranks, f"{cf}/y"), ref[f"{cf}/y"],
                               **TOL)


@pytest.mark.parametrize("cf", CAPACITIES, ids=["cap64", "binding"])
def test_gradients_match_the_reference(runs, cf):
    ref, ranks, _ = runs
    for k in ("router", "w1", "w3", "w2"):
        got = sum(r[f"{cf}/{k}"] for r in ranks)
        np.testing.assert_allclose(got, ref[f"{cf}/{k}"], **TOL, err_msg=k)
    np.testing.assert_allclose(_assemble(ranks, f"{cf}/x"), ref[f"{cf}/x"],
                               **TOL)
    assert np.abs(ref[f"{cf}/router"]).sum() > 0


def test_capacity_64_drops_nothing(runs):
    _, _, info = runs
    for i in info:
        for st in i["64.0"]:
            assert st["dropped_send"] == st["dropped_expert"] == 0
            assert sum(st["sent"]) == 2 * 2 * K


def test_a_binding_capacity_keeps_at_most_the_capacity(runs):
    _, _, info = runs
    dropped = 0
    for i in info:
        for st in i["0.5"]:
            assert max(st["sent"]) <= st["cap_send"]
            assert max(st["kept_expert"]) <= st["cap_expert"]
            assert sum(st["sent"]) + st["dropped_send"] == 2 * 2 * K
            dropped += st["dropped_send"] + st["dropped_expert"]
    assert dropped > 0


def test_shard_map_backend_routes_through_the_all_to_all(runs):
    _, _, info = runs
    for i in info:
        assert i["a2a_under_mesh"] > 0
        assert i["a2a_without_mesh"] == 0
        assert i["route_max_abs_err"] <= 1e-5 * max(1.0, i["route_scale"])


def test_not_applicable_without_a_model_axis():
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.moe_shardmap import shardmap_applicable
    from repro_torch.models.shard_hints import use_mesh
    assert not shardmap_applicable(8, 8)
    for shape, e, s, want in (((2, 4), 8, 8, True), ((2, 4), 6, 8, False),
                              ((2, 4), 8, 6, False), ((4, 1), 8, 8, False)):
        with use_mesh(MeshShape(("data", "model"), shape)):
            assert shardmap_applicable(e, s) == want, (shape, e, s)
