"""Serving under a model axis (``repro_torch.launch.train``'s
``make_decode_step`` / ``make_prefill_step`` with ``mesh=``) against the
JAX reference's single-device ``decode_step`` and ``apply``, and against
the port's own single-process decode.

The reference initializes each smoke config (transformer-100m;
gemma2-27b: softcap, GQA, a local and a global layer; granite-moe-3b-
a800m: MoE; jamba-v0.1-52b: mamba states and a MoE) and decodes 8
sequences from an empty rotating buffer of 16 rows for 20 steps (a wrap)
with ``jax.jit(api.decode_step)``; its parameters, tokens and logits go
to the port through numpy.  The MoE configs run at a capacity that drops
nothing, so a learner's rows decode as they do in the whole batch.

The port: one subprocess spawns 4 gloo ranks on the CPU, which build the
(1, 4) and (2, 2) meshes on one group.  Each rank holds its shard of the
weights (``step.shard``) and of the cache (``step.init_cache``: the batch
over the learners, every attention buffer's time dim over the model
ranks, a recurrent state's feature dim over them), decodes its learner's
rows and also runs the port's single-process ``decode_step`` on the whole
batch.  Held:

  * logits within 1e-5 relative of the reference's (float32; measured at
    most 2.5e-6) and of the port's single-process decode (8.9e-7), at
    every step, the steps where a rank's slice holds no live row yet
    included (finite, no uniform average);
  * each rank's K/V slice its slice of the single-process cache: the
    same rows written, ``slot_pos`` bitwise, the first attention layer
    (of the first period) bitwise and the later ones within 1e-5
    relative (measured 6.6e-7: their inputs come through the merged
    attention of the layers before, which rounds otherwise than one
    softmax over the whole buffer);
  * collectives a step: one a layer (each attention layer's all_gather
    of the softmax partials, each recurrent layer's all_gather of its
    state slices);
  * ``gather="period"`` gives the logits ``"whole"`` gives, bitwise;
  * ``make_prefill_step`` on (2, 2): each rank's rows through ``apply``
    on the gathered weights, the learner's rows gathered, within 1e-5
    relative of the reference's ``apply``.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_RANKS, B, W, STEPS, PREFILL_SEQ = 4, 8, 16, 20, 32
ARCHS = ("transformer-100m", "gemma2-27b", "granite-moe-3b-a800m",
         "jamba-v0.1-52b")
MESHES = ((1, 4), (2, 2))
RTOL = 1e-5


def _cfg(get_config, arch):
    cfg = get_config(arch).smoke_config()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    return cfg


SCRIPT = r"""
import dataclasses, json, sys
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


def rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def rank_main(rank, port, src, dst):
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import init_learner_group
    from repro_torch.launch.mesh import learner_rank, make_test_mesh
    from repro_torch.launch.train import (gather_rows, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_from_jax

    init_learner_group(rank, N_RANKS, f"tcp://127.0.0.1:{port}",
                       device="cpu", backend="gloo")
    meshes = {s: make_test_mesh(*s) for s in MESHES}
    inp = np.load(src)
    out, info = {}, {}
    for arch in ARCHS:
        cfg = get_config(arch).smoke_config()
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=64.0)
        api = build_model(cfg, device="cpu")
        tree = tree_from_jax(load_tree(inp, f"{arch}/p/"))
        params = api.params_from_tree(tree)
        toks = torch.tensor(inp[f"{arch}/tokens"])
        # the port's single-process decode of the whole batch
        cache1 = api.init_cache(params, B, W)
        single, caches = [], []
        for t in range(STEPS):
            lg, cache1 = api.decode_step(params, cache1, toks[t], t)
            single.append(lg)
            caches.append({k: {n: x.clone() for n, x in c.items()}
                           for k, c in cache1.items()})
        for shape in MESHES:
            gathers = ("whole", "period") if arch == ARCHS[0] else ("whole",)
            for gather in gathers:
                mesh = meshes[shape]
                L, M = shape
                i, j = learner_rank(mesh), rank % M
                b = B // L
                step = make_decode_step(api, mesh, gather=gather,
                                        device="cpu")
                store = step.shard(tree)
                cache = step.init_cache(B, W)
                rec = {"calls": [], "vs_single": [], "finite": [],
                       "kv": [], "live_rows": []}
                logits = []
                for t in range(STEPS):
                    c0 = step.seq_comm.calls
                    lg, cache = step(store, cache, toks[t, i * b:(i + 1) * b],
                                     t)
                    rec["calls"].append(step.seq_comm.calls - c0)
                    rec["finite"].append(bool(torch.isfinite(lg).all()))
                    rec["vs_single"].append(rel(lg, single[t][i * b:
                                                              (i + 1) * b]))
                    logits.append(lg.numpy())
                    kv = {}
                    for layer, c in cache.items():
                        if "k" not in c:
                            continue
                        w = c["k"].shape[2]
                        ref = caches[t][layer]
                        for n in ("k", "v"):
                            want = ref[n][:, i * b:(i + 1) * b,
                                          j * w:(j + 1) * w]
                            kv[f"{layer}/{n}"] = [
                                bool(torch.equal(c[n][0], want[0])),
                                rel(c[n], want) if want.any() else 0.0,
                                bool(torch.equal(c[n] == 0, want == 0))]
                        kv[f"{layer}/slot_pos"] = bool(torch.equal(
                            c["slot_pos"], ref["slot_pos"]))
                        sp = c["slot_pos"][:, j * w:(j + 1) * w]
                        live = int(((sp >= 0) & (sp <= t)).sum())
                    rec["kv"].append(kv)
                    rec["live_rows"].append(live)
                tag = f"{arch}/{shape[0]}x{shape[1]}/{gather}"
                out[f"{tag}/{rank}"] = np.stack(logits)
                rec.update(learner=i, model_rank=j,
                           max_full_bytes=step.max_full_bytes,
                           weight_kinds=step.comm.kinds)
                info[f"{tag}/{rank}"] = rec
    # an attention buffer the model ranks do not split
    api = build_model(get_config(ARCHS[0]).smoke_config(), device="cpu")
    try:
        make_decode_step(api, meshes[(1, 4)], device="cpu").init_cache(
            B, 6)
        info["odd_buffer"] = "built"
    except ValueError as e:
        info["odd_buffer"] = str(e)
    # prefill on (2, 2): this rank's rows on the gathered weights
    arch = ARCHS[0]
    api = build_model(get_config(arch).smoke_config(), device="cpu")
    tree = tree_from_jax(load_tree(inp, f"{arch}/p/"))
    mesh = meshes[(2, 2)]
    i = learner_rank(mesh)
    b = B // 2
    rows = {"tokens": torch.tensor(inp["prefill_tokens"][i * b:(i + 1) * b])}
    for gather in ("whole", "period"):
        step = make_prefill_step(api, mesh, gather=gather, device="cpu")
        mine = step(step.shard(tree), rows)
        out[f"prefill/{gather}/{rank}"] = gather_rows(step, mine).numpy()
        info[f"prefill/{gather}/{rank}"] = {"rows": mine.shape[0],
                                            "learner": i}
    np.savez(f"{dst}/rank{rank}.npz", **out)
    with open(f"{dst}/rank{rank}.json", "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    src, dst, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
    mp.start_processes(rank_main, args=(port, src, dst), nprocs=N_RANKS,
                       start_method="spawn")
"""


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
def reference(tmp_path_factory):
    """The reference's parameters, tokens, decode logits and prefill
    logits, written for the port's ranks."""
    d = tmp_path_factory.mktemp("mesh_serve")
    rng = np.random.default_rng(0)
    arrays, want = {}, {}
    for k, arch in enumerate(ARCHS):
        cfg = _cfg(jax_get_config, arch)
        api = jax_build_model(cfg)
        params = api.init(jax.random.PRNGKey(k))
        toks = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
        step = jax.jit(api.decode_step)
        cache = api.init_cache(params, B, W)
        logits = []
        for t in range(STEPS):
            lg, cache = step(params, cache, jnp.asarray(toks[t]),
                             jnp.int32(t))
            logits.append(np.asarray(lg))
        want[arch] = np.stack(logits)
        arrays.update({f"{arch}/p/{p}": np.asarray(x)
                       for p, x in _paths(params).items()})
        arrays[f"{arch}/tokens"] = toks
        if k == 0:
            ptoks = rng.integers(0, cfg.vocab, (B, PREFILL_SEQ)).astype(
                np.int32)
            arrays["prefill_tokens"] = ptoks
            want["prefill"] = np.asarray(api.apply(
                params, {"tokens": jnp.asarray(ptoks)}))
    np.savez(d / "inputs.npz", **arrays)
    return d, want


@pytest.fixture(scope="module")
def runs(reference):
    d, _ = reference
    consts = (f"N_RANKS, B, W, STEPS = {N_RANKS}, {B}, {W}, {STEPS}\n"
              f"ARCHS, MESHES = {ARCHS!r}, {MESHES!r}\n")
    (d / "port.py").write_text(consts + SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, str(d / "port.py"),
                        str(d / "inputs.npz"), str(d), str(_free_port())],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return ([np.load(d / f"rank{r}.npz") for r in range(N_RANKS)],
            [json.loads((d / f"rank{r}.json").read_text())
             for r in range(N_RANKS)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


CASES = [(a, s) for a in ARCHS for s in MESHES]
IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]


def _tag(arch, shape, gather="whole"):
    return f"{arch}/{shape[0]}x{shape[1]}/{gather}"


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_sharded_decode_matches_the_reference(reference, runs, arch, shape):
    _, want = reference
    ranks, info = runs
    b = B // shape[0]
    for r, rk in enumerate(ranks):
        i = info[r][f"{_tag(arch, shape)}/{r}"]["learner"]
        got = rk[f"{_tag(arch, shape)}/{r}"]
        for t in range(STEPS):
            rel = _rel(got[t], want[arch][t, i * b:(i + 1) * b])
            assert rel <= RTOL, (arch, shape, r, t, rel)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_sharded_decode_matches_the_single_process_decode(runs, arch,
                                                          shape):
    _, info = runs
    for r, i in enumerate(info):
        rec = i[f"{_tag(arch, shape)}/{r}"]
        assert max(rec["vs_single"]) <= RTOL, rec["vs_single"]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_kv_shards_are_slices_of_the_single_process_cache(runs, arch,
                                                          shape):
    """Each rank's K/V slice is its slice of the single-process cache: the
    same rows written (the rest zero in both), ``slot_pos`` bitwise, and
    the first attention layer of the first period (its input the
    embedding) bitwise; a later layer's rows were computed from the
    merged attention of the layers before it, whose float32 sums over
    the ranks' partials round otherwise than one softmax over the whole
    buffer, so they hold at the logits' tier."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import period_spec
    mixers = [m for m, _ in period_spec(get_config(arch).smoke_config())]
    first = f"l{[m.startswith('attn') for m in mixers].index(True)}"
    _, info = runs
    for r, i in enumerate(info):
        for t, kv in enumerate(i[f"{_tag(arch, shape)}/{r}"]["kv"]):
            for key, v in kv.items():
                if key.endswith("slot_pos"):
                    assert v, (key, t)
                    continue
                bitwise, rel, same_rows = v
                assert same_rows and rel <= RTOL, (key, t, rel)
                if key.startswith(first + "/"):
                    assert bitwise, (key, t)


def test_a_slice_with_no_live_row_adds_nothing(reference, runs):
    """On (1, 4) with 4 rows a rank, ranks 1-3 hold no live row for the
    first steps: the logits are finite and the reference's there."""
    _, want = reference
    ranks, info = runs
    tag = _tag(ARCHS[0], (1, 4))
    for r in range(1, N_RANKS):
        rec = info[r][f"{tag}/{r}"]
        assert rec["live_rows"][:r * 4] == [0] * (r * 4)
        assert all(rec["finite"])
        for t in range(r * 4):
            assert _rel(ranks[r][f"{tag}/{r}"][t], want[ARCHS[0]][t]) <= RTOL


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_one_collective_a_layer_a_step(runs, arch, shape):
    """Every layer of the four smoke configs either attends (one
    all_gather of its partials) or keeps a state the model ranks split
    (one all_gather of its slices)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).smoke_config()
    _, info = runs
    for r, i in enumerate(info):
        assert i[f"{_tag(arch, shape)}/{r}"]["calls"] \
            == [cfg.n_layers] * STEPS


@pytest.mark.parametrize("shape", MESHES, ids=["1x4", "2x2"])
def test_the_period_gather_serves_the_same_logits(runs, shape):
    ranks, info = runs
    for r, rk in enumerate(ranks):
        np.testing.assert_array_equal(
            rk[f"{_tag(ARCHS[0], shape, 'period')}/{r}"],
            rk[f"{_tag(ARCHS[0], shape)}/{r}"])
        whole = info[r][f"{_tag(ARCHS[0], shape)}/{r}"]["max_full_bytes"]
        period = info[r][f"{_tag(ARCHS[0], shape, 'period')}/{r}"]
        assert 0 < period["max_full_bytes"] <= whole


def test_a_buffer_the_model_ranks_do_not_split_raises(runs):
    _, info = runs
    for i in info:
        assert "does not split over 4 model ranks" in i["odd_buffer"]


@pytest.mark.parametrize("gather", ["whole", "period"])
def test_sharded_prefill_matches_the_reference_apply(reference, runs,
                                                     gather):
    _, want = reference
    ranks, info = runs
    b = B // 2
    for r, rk in enumerate(ranks):
        rec = info[r][f"prefill/{gather}/{r}"]
        assert rec["rows"] == b // 2
        i = rec["learner"]
        got = rk[f"prefill/{gather}/{r}"]
        assert _rel(got, want["prefill"][i * b:(i + 1) * b]) <= RTOL
