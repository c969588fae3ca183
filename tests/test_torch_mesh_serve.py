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

The audio family (seamless-m4t-large-v2's smoke config: 2 encoder and 2
decoder layers) in the same spawn: the reference's jitted
``api.init_cache(params, frames, W)`` over 32 frames then ``decode_step``
for 20 steps of a 16-row buffer, on (1, 4) and (2, 2).  Each rank's
``init_cache(B, W, store=, frames=)`` encodes its rows and keeps, after
one all_to_all, its slice of the encoder length for all of the learner's
rows.  Held: logits within 1e-5 relative of the reference (measured
1.2e-6) and of the port's single-process decode (7.0e-7); each rank's
``xk`` / ``xv`` its slice of the single-process cross cache within 1e-6
relative (measured: bitwise), its self-attention buffer as above; two
collectives a decoder layer a step; the sharded prefill within 1e-5 of
the reference's ``apply`` (1.1e-6); ``gather="period"`` raising for the family
(no stacked periods), for the decode, the prefill and the probe.  The
cross-attention's partials merged over 1 and over 4 slices equal the
einsum softmax, without a process group.
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
AUDIO, S_ENC = "seamless-m4t-large-v2", 32
MESHES = ((1, 4), (2, 2))
RTOL = 1e-5
CROSS_RTOL = 1e-6


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
    audio(rank, inp, meshes, out, info)
    np.savez(f"{dst}/rank{rank}.npz", **out)
    with open(f"{dst}/rank{rank}.json", "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


def audio(rank, inp, meshes, out, info):
    # the encoder-decoder: its sharded decode on each mesh against the
    # single-process decode, its sharded prefill on (2, 2), and
    # gather="period" refused
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import learner_rank
    from repro_torch.launch.train import (gather_rows, make_decode_step,
                                          make_prefill_step, make_probe_step)
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_from_jax
    from repro_torch.models.moe_shardmap import all_to_all

    api = build_model(get_config(AUDIO).smoke_config(), device="cpu")
    tree = tree_from_jax(load_tree(inp, f"{AUDIO}/p/"))
    params = api.params_from_tree(tree)
    frames = torch.tensor(inp[f"{AUDIO}/frames"])
    toks = torch.tensor(inp[f"{AUDIO}/tokens"])
    cache1 = api.init_cache(params, frames, W)
    single, selfs = [], []
    for t in range(STEPS):
        lg, cache1 = api.decode_step(params, cache1, toks[t], t)
        single.append(lg)
        selfs.append({n: x.clone() for n, x in cache1["self"].items()})
    for shape in MESHES:
        mesh = meshes[shape]
        L, M = shape
        i, j = learner_rank(mesh), rank % M
        b, s = B // L, S_ENC // M
        step = make_decode_step(api, mesh, device="cpu")
        store = step.shard(tree)
        a2a = all_to_all.calls
        cache = step.init_cache(B, W, store=store,
                                frames=frames[i * b:(i + 1) * b])
        rec = {"weight_kinds": dict(step.comm.kinds), "cross": {},
               "all_to_all": all_to_all.calls - a2a,
               "calls": [], "vs_single": [], "self": []}
        for n in ("xk", "xv"):
            got = cache["cross"][n]
            want = cache1["cross"][n][:, i * b:(i + 1) * b,
                                      j * s:(j + 1) * s]
            rec["cross"][n] = [list(got.shape) == list(want.shape),
                               bool(torch.equal(got, want)), rel(got, want)]
        logits = []
        for t in range(STEPS):
            c0 = step.seq_comm.calls
            lg, cache = step(store, cache, toks[t, i * b:(i + 1) * b], t)
            rec["calls"].append(step.seq_comm.calls - c0)
            rec["vs_single"].append(rel(lg, single[t][i * b:(i + 1) * b]))
            logits.append(lg.numpy())
            c = cache["self"]
            w = c["k"].shape[2]
            kv = {"slot_pos": bool(torch.equal(c["slot_pos"],
                                               selfs[t]["slot_pos"]))}
            for n in ("k", "v"):
                want = selfs[t][n][:, i * b:(i + 1) * b, j * w:(j + 1) * w]
                kv[n] = [rel(c[n], want) if want.any() else 0.0,
                         bool(torch.equal(c[n] == 0, want == 0))]
            rec["self"].append(kv)
        tag = f"{AUDIO}/{shape[0]}x{shape[1]}"
        out[f"{tag}/{rank}"] = np.stack(logits)
        info[f"{tag}/{rank}"] = dict(rec, learner=i)
    mesh = meshes[(1, 4)]
    try:
        make_decode_step(api, mesh, device="cpu").init_cache(
            B, W, store=store, frames=frames[:, :S_ENC - 2])
        info["odd_frames"] = "built"
    except ValueError as e:
        info["odd_frames"] = str(e)
    mesh = meshes[(2, 2)]
    i = learner_rank(mesh)
    b = B // 2
    step = make_prefill_step(api, mesh, device="cpu")
    rows = {"frames": frames[i * b:(i + 1) * b],
            "tokens": torch.tensor(inp[f"{AUDIO}/prefill_tokens"]
                                   [i * b:(i + 1) * b])}
    out[f"{AUDIO}/prefill/{rank}"] = gather_rows(
        step, step(step.shard(tree), rows)).numpy()
    info[f"{AUDIO}/prefill/{rank}"] = {"learner": i}
    refused = {}
    for what, make in (
            ("decode", lambda: make_decode_step(api, mesh, gather="period",
                                                device="cpu")),
            ("prefill", lambda: make_prefill_step(
                api, mesh, gather="period", device="cpu")),
            ("probe", lambda: make_probe_step(
                api, mesh, alpha=0.1, stacked=True, gather="period",
                device="cpu"))):
        try:
            make()
            refused[what] = "built"
        except ValueError as e:
            refused[what] = str(e)
    info[f"{AUDIO}/period"] = refused


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
    cfg = jax_get_config(AUDIO).smoke_config()
    api = jax_build_model(cfg)
    params = api.init(jax.random.PRNGKey(len(ARCHS)))
    frames = (rng.standard_normal((B, S_ENC, cfg.d_model)) * 0.1).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    ptoks = rng.integers(0, cfg.vocab, (B, PREFILL_SEQ)).astype(np.int32)
    step = jax.jit(api.decode_step)
    cache = jax.jit(api.init_cache, static_argnums=2)(
        params, jnp.asarray(frames), W)
    logits = []
    for t in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[t]), jnp.int32(t))
        logits.append(np.asarray(lg))
    want[AUDIO] = np.stack(logits)
    want[f"{AUDIO}/prefill"] = np.asarray(api.apply(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(ptoks)}))
    arrays.update({f"{AUDIO}/p/{p}": np.asarray(x)
                   for p, x in _paths(params).items()})
    arrays.update({f"{AUDIO}/frames": frames, f"{AUDIO}/tokens": toks,
                   f"{AUDIO}/prefill_tokens": ptoks})
    np.savez(d / "inputs.npz", **arrays)
    return d, want


@pytest.fixture(scope="module")
def runs(reference):
    d, _ = reference
    consts = (f"N_RANKS, B, W, STEPS = {N_RANKS}, {B}, {W}, {STEPS}\n"
              f"ARCHS, MESHES = {ARCHS!r}, {MESHES!r}\n"
              f"AUDIO, S_ENC = {AUDIO!r}, {S_ENC}\n")
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


# ---------------------------------------------------------------------------
# the audio family: its cross-attention caches cut on the encoder length
# ---------------------------------------------------------------------------

MESH_IDS = ["1x4", "2x2"]


def _audio_tag(shape):
    return f"{AUDIO}/{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_audio_sharded_decode_matches_the_reference(reference, runs, shape):
    _, want = reference
    ranks, info = runs
    b = B // shape[0]
    for r, rk in enumerate(ranks):
        i = info[r][f"{_audio_tag(shape)}/{r}"]["learner"]
        got = rk[f"{_audio_tag(shape)}/{r}"]
        for t in range(STEPS):
            rel = _rel(got[t], want[AUDIO][t, i * b:(i + 1) * b])
            assert rel <= RTOL, (shape, r, t, rel)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_audio_sharded_decode_matches_the_single_process_decode(runs,
                                                                shape):
    _, info = runs
    for r, i in enumerate(info):
        rec = i[f"{_audio_tag(shape)}/{r}"]
        assert max(rec["vs_single"]) <= RTOL, rec["vs_single"]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_audio_caches_are_slices_of_the_single_process_caches(runs, shape):
    """Each rank's ``xk`` / ``xv``: the learner's rows over its slice of
    the encoder length, within 1e-6 of the single-process cross cache
    (its own rows were encoded on the same weights; the others came
    through the all-to-all); its self-attention buffer the same rows
    written as the single-process buffer's slice, ``slot_pos`` whole."""
    _, info = runs
    for r, i in enumerate(info):
        rec = i[f"{_audio_tag(shape)}/{r}"]
        for n, (same_shape, _, rel) in rec["cross"].items():
            assert same_shape and rel <= CROSS_RTOL, (n, rel)
        for t, kv in enumerate(rec["self"]):
            assert kv["slot_pos"], t
            for n in ("k", "v"):
                rel, same_rows = kv[n]
                assert same_rows and rel <= RTOL, (n, t, rel)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_audio_two_collectives_a_decoder_layer_a_step(runs, shape):
    """A decoder layer merges the self-attention's partials, then the
    cross-attention's; building the cache takes the weights' one gather
    and one all-to-all of the cross K/V."""
    from repro_torch.configs import get_config
    n_layers = get_config(AUDIO).smoke_config().n_layers
    _, info = runs
    for r, i in enumerate(info):
        rec = i[f"{_audio_tag(shape)}/{r}"]
        assert rec["calls"] == [2 * n_layers] * STEPS
        assert rec["weight_kinds"] == {"all_gather": 1}
        assert rec["all_to_all"] == 1


def test_audio_encoder_length_the_model_ranks_do_not_split_raises(runs):
    _, info = runs
    for i in info:
        assert "encoder length of 30 rows does not split over 4 model " \
            "ranks" in i["odd_frames"]


def test_audio_sharded_prefill_matches_the_reference_apply(reference, runs):
    _, want = reference
    ranks, info = runs
    b = B // 2
    for r, rk in enumerate(ranks):
        i = info[r][f"{AUDIO}/prefill/{r}"]["learner"]
        got = rk[f"{AUDIO}/prefill/{r}"]
        assert _rel(got, want[f"{AUDIO}/prefill"][i * b:(i + 1) * b]) <= RTOL


@pytest.mark.parametrize("what", ["decode", "prefill", "probe"])
def test_audio_period_gather_raises(runs, what):
    _, info = runs
    for i in info:
        assert "has no stacked periods" in i[f"{AUDIO}/period"][what]


@pytest.mark.parametrize("size", [1, 4])
def test_cross_decode_partials_merge_to_the_softmax(size):
    """``attn_cross_decode_sharded`` over ``size`` slices of the encoder
    length, merged by ``merge_partials`` in one process, against
    ``encdec.decode_step``'s einsum softmax over the whole memory."""
    from repro_torch.models.attention import (attn_cross_decode_sharded,
                                              init_attn_params,
                                              merge_partials)
    gen = torch.Generator().manual_seed(0)
    Bq, S, d, H, KV, hd = 3, 24, 64, 4, 2, 16
    p = init_attn_params(gen, d, H, KV, hd, torch.float32)
    x = torch.randn((Bq, 1, d), generator=gen)
    xk = torch.randn((Bq, S, KV, hd), generator=gen)
    xv = torch.randn((Bq, S, KV, hd), generator=gen)
    parts, w = [], S // size

    def merge(m, lsum, o):
        # each slice's partials in turn; the last call merges them all
        parts.append(torch.cat([o, m[..., None], lsum[..., None]], -1))
        return merge_partials(torch.stack(parts))

    for r in range(size):
        got = attn_cross_decode_sharded(
            p, xk[:, r * w:(r + 1) * w], xv[:, r * w:(r + 1) * w], x, 5,
            n_heads=H, n_kv=KV, head_dim=hd, rope_fn=None, merge=merge)
    q = (x @ p.wq).reshape(Bq, KV, H // KV, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", q, xk) * hd ** -0.5
    o = torch.einsum("bkgw,bwkd->bkgd", torch.softmax(s, -1), xv)
    want = o.reshape(Bq, 1, H * hd) @ p.wo
    assert _rel(got.detach().numpy(), want.detach().numpy()) <= 1e-6
