"""The dry run's twin (``repro_torch.launch.dryrun``) against the JAX
reference's registry, spec builders and closed-form counts, all on shapes
alone: the port's records are built on the meta device, the reference's
specs on ``jax.eval_shape`` shapes, with no compile and no device.

  * ``ASSIGNED`` / ``SHAPES`` are the reference's;
  * transformer-100m and granite-moe-3b-a800m x train_4k / prefill_32k /
    decode_32k on the single-pod (16, 16) and multi-pod (2, 16, 16)
    meshes: each state part's per-rank resident bytes (params, optimizer
    state, buffer, cache) equal the sum of its leaves' shard sizes under
    the reference's own ``train_state_shardings`` / ``params_sharding`` /
    ``cache_sharding``, and the analytic terms equal the reference's
    ``analytic.*``;
  * seamless-m4t-large-v2 x long_500k is skipped with the reference's
    reason; its decode_32k counts the sequence-sharded decode's flops
    (each rank's slice of the self-attention buffer and of the cross K/V
    on the meta device), and its cache's per-rank bytes equal the
    reference's ``cache_sharding`` of its ``init_cache`` over 4,096 stub
    frames;
  * mistral-large-123b's train_4k on one pod: gathering the whole learner
    holds more than a card's 80 GB a rank, one period at a time less than
    a fiftieth of that;
  * the counted flops (``FlopCounterMode`` on meta tensors) of
    transformer-100m's train_4k step within 10% of the analytic count
    (measured 1.073x: the counter sees every block of the causal
    attention, the analytic count half of them, and no embedding gather).
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch.train import train_state_shardings as jtss  # noqa: E402
from repro.launch.train import train_state_specs as jspecs  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("transformer-100m", "granite-moe-3b-a800m")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
FLOPS_TIER = 0.10


def _mesh(multi):
    sizes = MESHES[multi]
    return SimpleNamespace(shape=sizes, axis_names=tuple(sizes))


def _spec_bytes(shapes, specs, sizes) -> int:
    """The reference's specs applied to its shapes: each leaf's dims cut
    by the product of the mesh axes its spec entry names."""
    leaves = jax.tree_util.tree_leaves(shapes)
    parts = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(parts)
    total = 0
    for leaf, spec in zip(leaves, parts):
        n = 1
        for d, s in enumerate(leaf.shape):
            entry = spec[d] if d < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            for a in axes:
                s //= sizes[a]
            n *= s
        total += n * leaf.dtype.itemsize
    return total


def _reference_bytes(arch, shape, multi):
    cfg = jcfgs.get_config(arch)
    api = jbuild(cfg)
    mesh = _mesh(multi)
    seq, gb, kind = jcfgs.SHAPES[shape]
    if kind == "train":
        specs = jspecs(api, jsgd(lr=0.1, momentum=0.9), mesh, algo="dpsgd")
        shd = jtss(specs, mesh, algo="dpsgd")
        return {"params": _spec_bytes(specs.params, shd.params, mesh.shape),
                "opt_state": _spec_bytes(specs.opt_state, shd.opt_state,
                                         mesh.shape),
                "buffer": 0, "cache": 0}
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    out = {"params": _spec_bytes(params, jshd.params_sharding(
        params, mesh, stacked=False), mesh.shape), "opt_state": 0,
        "buffer": 0, "cache": 0}
    if kind == "decode":
        buf = dryrun.decode_buf_len(cfg, seq)
        cache = jax.eval_shape(lambda: api.init_cache(None, gb, buf))
        out["cache"] = _spec_bytes(cache, jshd.cache_sharding(cache, mesh),
                                   mesh.shape)
    return out


def _reference_analytic(arch, shape, multi):
    cfg = jcfgs.get_config(arch)
    seq, gb, kind = jcfgs.SHAPES[shape]
    n = 512 if multi else 256
    if kind == "train":
        L = 32 if multi else 16
        return (janalytic.train_flops_per_chip(cfg, gb, seq, n),
                janalytic.train_bytes_per_chip(cfg, gb, seq, n, L))
    if kind == "prefill":
        return (janalytic.prefill_flops_per_chip(cfg, gb, seq, n),
                janalytic.prefill_bytes_per_chip(cfg, gb, seq, n))
    capped = seq > 65536
    return (janalytic.decode_flops_per_chip(cfg, gb, seq, n,
                                            window_capped=capped),
            janalytic.decode_bytes_per_chip(cfg, gb, seq, n,
                                            window_capped=capped))


def test_assigned_and_shapes_are_the_references():
    assert configs.ASSIGNED == jcfgs.ASSIGNED
    assert configs.SHAPES == jcfgs.SHAPES


@pytest.fixture(scope="module")
def records():
    return {(a, s, m): dryrun.build_record(a, s, multi_pod=m, algo="dpsgd",
                                           count=False)
            for a in ARCHS for s in KINDS for m in MESHES}


CASES = [(a, s, m) for a in ARCHS for s in KINDS for m in MESHES]
IDS = [f"{a}-{s}-{'multi' if m else 'single'}" for a, s, m in CASES]


@pytest.mark.parametrize("arch,shape,multi", CASES, ids=IDS)
def test_resident_bytes_are_the_reference_specs_shards(records, arch, shape,
                                                       multi):
    got = records[(arch, shape, multi)]["resident_bytes"]
    want = _reference_bytes(arch, shape, multi)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("arch,shape,multi", CASES, ids=IDS)
def test_analytic_terms_are_the_references(records, arch, shape, multi):
    rec = records[(arch, shape, multi)]
    flops, byts = _reference_analytic(arch, shape, multi)
    assert rec["analytic"] == {"flops_per_chip": flops,
                               "bytes_per_chip": byts}
    assert rec["n_chips"] == (512 if multi else 256)


def test_seamless_long_500k_is_skipped_with_the_reference_reason(tmp_path):
    rec = dryrun.run_one("seamless-m4t-large-v2", "long_500k",
                         multi_pod=False, outdir=str(tmp_path), quiet=True)
    assert rec["status"] == "skipped"
    assert rec["reason"] == dryrun.SKIPS[("seamless-m4t-large-v2",
                                          "long_500k")]
    written = json.loads((tmp_path / f"{rec['name']}.json").read_text())
    assert written == rec


def test_seamless_decode_is_counted_on_its_sharded_caches():
    arch, shape = "seamless-m4t-large-v2", "decode_32k"
    rec = dryrun.build_record(arch, shape, multi_pod=False, algo="dpsgd")
    assert rec["counted_flops_per_chip"] > 0
    assert "counted_flops_skipped" not in rec
    cfg = jcfgs.get_config(arch)
    api = jbuild(cfg)
    mesh = _mesh(False)
    seq, gb, _ = jcfgs.SHAPES[shape]
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    frames = jax.ShapeDtypeStruct((gb, dryrun.AUDIO_ENC_LEN, cfg.d_model),
                                  jax.numpy.bfloat16)
    cache = jax.eval_shape(lambda p, f: api.init_cache(
        p, f, dryrun.decode_buf_len(cfg, seq)), params, frames)
    want = _spec_bytes(cache, jshd.cache_sharding(cache, mesh), mesh.shape)
    assert rec["resident_bytes"]["cache"] == want


def test_the_reference_skips_the_same_pairs():
    # the reference's dryrun module forces 512 host devices at import, so
    # its SKIPS are read from its source, not imported here
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    for (arch, shape), reason in dryrun.SKIPS.items():
        assert f'("{arch}", "{shape}")' in src and reason in src


def test_mistral_large_needs_the_per_period_gather():
    rec = dryrun.build_record("mistral-large-123b", "train_4k",
                              multi_pod=False, algo="dpsgd", count=False)
    t = rec["gather_transient_bytes"]
    assert t["whole"] > 80e9
    assert t["period"] < t["whole"] / 50


def test_counted_flops_hold_to_the_analytic_count():
    rec = dryrun.build_record("transformer-100m", "train_4k",
                              multi_pod=False, algo="dpsgd")
    counted = rec["counted_flops_per_chip"]
    analytic = rec["analytic"]["flops_per_chip"]
    assert abs(counted / analytic - 1) <= FLOPS_TIER, counted / analytic
    assert rec["roofline"]["flops_source"] == "counted"
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops_per_chip"] / counted)


def test_the_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "transformer-100m", "--shape", "decode_32k", "--gather", "period",
         "--outdir", str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["gather"] == "period"
    assert rec["counted_flops_per_chip"] > 0
