"""The reference's small public pieces in the port, against the reference.

  * ``core.util.global_norm`` / ``tree_zeros_like`` on one tree;
  * ``core.topology.make_mixing_fn``: every static topology bitwise the
    reference's matrix; ``random_pair`` a doubly stochastic perfect
    matching; the time-varying and unknown names raise;
  * ``data``: ``GaussianMixtureImages``, ``ZipfianTokenStream``,
    ``TeacherStudentRegression`` and ``stack_learner_batches``, checked by
    property (the port cannot replay ``jax.random``): shapes and dtypes,
    the class means' norm, the noise variance, the Zipf law (the
    reference test's own head check and the rank frequencies), the
    teacher's residual variance, seeds that replay and learners that
    differ;
  * the public names of every ``src/repro/`` module against its
    ``src/repro_torch/`` counterpart (read from the source with ``ast``;
    neither package is imported for it), less a list of JAX- or TPU-only
    names, each with its reason.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import topology as jax_topology  # noqa: E402
from repro.core import util as jax_util  # noqa: E402
from repro_torch.core import make_mixing_fn  # noqa: E402
from repro_torch.core import topology, util  # noqa: E402
from repro_torch.data import (GaussianMixtureImages,  # noqa: E402
                              ShardedLoader, TeacherStudentRegression,
                              TemplateImages, ZipfianTokenStream,
                              stack_learner_batches)
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
STATIC = ("full", "ring", "torus", "hierarchical", "exp", "solo")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# core.util
# ---------------------------------------------------------------------------

def test_global_norm_and_tree_zeros_like_match_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((7, 5), dtype=np.float32),
            "b": [rng.standard_normal((5,), dtype=np.float32),
                  (100 * rng.standard_normal((3, 2))).astype(np.float32)]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = {"w": torch.tensor(tree["w"]),
             "b": [torch.tensor(x) for x in tree["b"]]}
    got = util.global_norm(ttree)
    want = np.asarray(jax_util.global_norm(jtree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    zeros = util.tree_zeros_like(ttree)
    jzeros = jax.tree_util.tree_leaves(jax_util.tree_zeros_like(jtree))
    for z, jz, x in zip(tree_leaves(zeros), jzeros, tree_leaves(ttree)):
        assert z.shape == x.shape and z.dtype == x.dtype
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert isinstance(zeros["b"], list)


# ---------------------------------------------------------------------------
# core.topology.make_mixing_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 6, 8, 9, 16])
@pytest.mark.parametrize("name", STATIC)
def test_static_mixing_matrix_is_the_reference_bitwise(name, n):
    want = np.asarray(jax_topology.make_mixing_fn(name, n)(
        jax.random.PRNGKey(0)))
    fn = make_mixing_fn(name, n)
    got = fn(_gen(0))
    assert got.dtype == torch.float32 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # static: the generator is not read
    assert torch.equal(fn(_gen(1)), got)
    assert topology.is_doubly_stochastic(got)
    if name == "solo":
        assert torch.equal(got, torch.eye(n))


@pytest.mark.parametrize("n", [2, 4, 6, 8, 16])
def test_random_pair_is_a_fresh_perfect_matching(n):
    fn = make_mixing_fn("random_pair", n)
    gen = _gen(0)
    draws = [fn(gen) for _ in range(8)]
    for m in draws:
        assert topology.is_doubly_stochastic(m)
        # 0.5 (I + P), P a fixed-point-free involution
        p = (2 * m - torch.eye(n)).numpy()
        assert np.array_equal(p, p.T) and set(np.unique(p)) <= {0.0, 1.0}
        assert np.all(p.sum(1) == 1) and not np.any(np.diag(p))
    if n > 2:
        assert any(not torch.equal(draws[0], m) for m in draws[1:])
    # the same seed replays
    assert torch.equal(make_mixing_fn("random_pair", n)(_gen(0)), draws[0])


@pytest.mark.parametrize("name", ["one_peer_exp", "random_matching", "nope"])
def test_time_varying_and_unknown_topologies_raise(name):
    with pytest.raises(ValueError, match="unknown topology"):
        jax_topology.make_mixing_fn(name, 8)
    with pytest.raises(ValueError, match="unknown topology"):
        make_mixing_fn(name, 8)


def test_hierarchical_falls_back_to_ring_without_a_factor():
    # 7 is prime: no group 1 < g < n, as in the reference
    np.testing.assert_array_equal(
        make_mixing_fn("hierarchical", 7)(_gen()).numpy(),
        topology.ring_matrix(7).numpy())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_gaussian_mixture_shapes_means_and_noise():
    ds = GaussianMixtureImages(n_classes=10, class_sep=3.0, noise=0.5)
    assert ds.dim == 784
    means = ds.means()
    assert means.shape == (10, 784)
    np.testing.assert_allclose(torch.linalg.norm(means, dim=1).numpy(), 3.0,
                               rtol=1e-6)
    b = ds.sample(_gen(1), 4096)
    assert b["image"].shape == (4096, 28, 28, 1)
    assert b["image"].dtype == torch.float32 and b["label"].dtype == \
        torch.int32
    lab = b["label"].long()
    assert int(lab.min()) >= 0 and int(lab.max()) < 10
    assert len(torch.unique(lab)) == 10
    resid = b["image"].reshape(4096, -1) - means[lab]
    # 4096 x 784 draws: the variance within 1% of noise^2
    assert abs(float(resid.var()) / 0.25 - 1) < 1e-2
    assert abs(float(resid.mean())) < 1e-2
    # the means come from the dataset's seed, not the batch's generator
    assert torch.equal(GaussianMixtureImages(class_sep=3.0).means(), means)
    assert not torch.equal(GaussianMixtureImages(class_sep=3.0,
                                                 seed=1).means(), means)
    other = GaussianMixtureImages(height=8, width=4, channels=3)
    assert other.dim == 96
    assert other.sample(_gen(), 2)["image"].shape == (2, 8, 4, 3)


def test_zipf_is_skewed_and_follows_its_law():
    ds = ZipfianTokenStream(vocab=1000, alpha=1.5)
    b = ds.sample(_gen(2), 8, 128)
    assert b["tokens"].shape == b["labels"].shape == (8, 128)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert b["mask"].dtype == torch.float32 and bool((b["mask"] == 1).all())
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    toks = b["tokens"].numpy().ravel()
    # the reference test's own check (tests/test_data_checkpoint.py)
    assert (toks < 10).mean() > 0.3
    # rank frequencies over 65,536 draws against p(c) ~ 1 / (c + 1)^1.5
    big = ZipfianTokenStream(vocab=1000, alpha=1.5).sample(_gen(3), 64,
                                                           1023)
    counts = np.bincount(big["tokens"].numpy().ravel(), minlength=1000)
    p = np.arange(1, 1001, dtype=np.float64) ** -1.5
    p /= p.sum()
    n = counts.sum()
    for c in range(8):              # each head rank within 4 sigma
        sigma = np.sqrt(n * p[c] * (1 - p[c]))
        assert abs(counts[c] - n * p[c]) < 4 * sigma, (c, counts[c],
                                                       n * p[c])
    tail = p[100:].sum()
    assert abs(counts[100:].sum() / n - tail) < 4 * np.sqrt(tail / n)
    assert int(big["tokens"].max()) < 1000


def test_teacher_student_residual_variance():
    ds = TeacherStudentRegression(dim=16, noise=0.1)
    w = ds.teacher()
    assert w.shape == (16, 1) and w.dtype == torch.float32
    assert torch.equal(ds.teacher(), w)
    b = ds.sample(_gen(4), 20000)
    assert b["x"].shape == (20000, 16) and b["y"].shape == (20000, 1)
    resid = b["y"] - b["x"] @ w
    assert abs(float(resid.var()) / 0.01 - 1) < 3e-2
    assert abs(float(b["x"].var()) - 1) < 2e-2


@pytest.mark.parametrize("ds,args", [
    (TemplateImages(), (6,)),
    (GaussianMixtureImages(), (6,)),
    (ZipfianTokenStream(vocab=500), (2, 16)),
    (TeacherStudentRegression(), (6,)),
])
def test_stack_learner_batches_replays_and_learners_differ(ds, args):
    out = stack_learner_batches(ds.sample, 7, 4, *args, device="cpu")
    again = stack_learner_batches(ds.sample, 7, 4, *args, device="cpu")
    single = ds.sample(_gen(), *args)
    assert set(out) == set(single)
    for k, v in out.items():
        assert v.shape == (4,) + tuple(single[k].shape)
        assert v.dtype == single[k].dtype
        assert torch.equal(v, again[k])
    key = "label" if "label" in out else "tokens" if "tokens" in out \
        else "x"
    x = out["image" if "image" in out else key]
    assert all(not torch.equal(x[0], x[j]) for j in range(1, 4))
    other = stack_learner_batches(ds.sample, 8, 4, *args, device="cpu")
    assert not torch.equal(other[key], out[key])
    # learner j's draw is ShardedLoader's at step 0
    if len(args) == 1:
        loader = ShardedLoader(ds, 4, args[0], seed=7, device="cpu")
    else:
        loader = ShardedLoader(ds, 4, args[0], extra_args=args[1:], seed=7,
                               device="cpu")
    assert all(torch.equal(v, loader.batch(0)[k]) for k, v in out.items())


# ---------------------------------------------------------------------------
# the public names of the two packages
# ---------------------------------------------------------------------------

# reference modules with no twin, by decision
NO_TWIN = {
    "analysis/jaxpr_audit.py": "audits jaxprs; the port's "
                               "analysis/trace_audit.py audits the ops a "
                               "step dispatches instead",
    "launch/roofline.py": "parses XLA HLO against TPU v5e constants; the "
                          "port's dry run counts flops with "
                          "FlopCounterMode on the meta device",
}
# (module, name): why the port has no such name there
EXCLUDED = {
    ("analysis/retrace.py", "RetraceSentinel"):
        "watches JAX's trace cache; the port's TraceSentinel watches the "
        "dispatched ops' signature",
    ("analysis/retrace.py", "compile_count"):
        "counts jit compilations; eager PyTorch compiles nothing",
    **{("core/dpsgd.py", f"mix_ppermute_{kind}"):
       "a shard_map ppermute mix; the port's launch path exchanges rows "
       "with core/dpsgd.exchange (batch_isend_irecv)"
       for kind in ("pair", "pair_flat", "ring", "ring_flat", "schedule",
                    "schedule_flat")},
    ("core/flatstate.py", "max_concat_elems"):
        "moved: the port's analysis/trace_audit.max_concat_elems reads a "
        "StepTrace, not a jaxpr",
    ("kernels/gossip_mix.py", "flatten_for_kernel"):
        "moved: the port keeps it in core/flatstate.py (kernels/ holds "
        "kernel modules only)",
    ("kernels/reorth.py", "reorth_pass"):
        "moved: the port's kernels/ops.reorthogonalize runs the pass",
    ("kernels/gossip_mix.py", "BLOCK_ROWS"):
        "a TPU block constant (a (256, 128) VMEM block)",
    ("kernels/reorth.py", "BLOCK_ROWS"):
        "a TPU block constant (a (256, 128) VMEM block)",
    ("kernels/gossip_mix.py", "LANE"):
        "the TPU lane width; the port's store's is core/flatstate.LANE",
    ("kernels/decode_attention.py", "NEG_INF"):
        "the Pallas body's mask fill; the CUDA source holds it (kNegInf), "
        "the plain version kernels/ref.NEG_INF",
    ("kernels/flash_attention.py", "NEG_INF"):
        "the Pallas body's mask fill; the CUDA source holds it (kNegInf), "
        "the plain version kernels/ref.NEG_INF",
    ("launch/dryrun.py", "build_lowered"):
        "lowers a jitted step to XLA; the port's dry run runs on the meta "
        "device",
    ("launch/sharding.py", "named_shardings"):
        "builds jax NamedShardings; the port places shards itself "
        "(launch/shardstore.py)",
    ("launch/train.py", "PjitTrainState"):
        "the pjit step's state; the port's launch steps keep a rank's "
        "shard",
}


def _public_names(path: Path) -> set:
    """Top-level functions, classes (with their public methods) and
    assigned names of a module, underscored names left out."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                        and not sub.name.startswith("_")}
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        out |= {t.id for t in targets if isinstance(t, ast.Name)
                and not t.id.startswith("_")}
    return out


def test_every_public_name_of_the_reference_has_a_twin():
    missing, stale = [], []
    for ref in sorted((SRC / "repro").rglob("*.py")):
        rel = ref.relative_to(SRC / "repro").as_posix()
        port = SRC / "repro_torch" / rel
        if rel in NO_TWIN:
            if port.exists():
                stale.append(rel)
            continue
        if not port.exists():
            missing.append(rel)
            continue
        gone = _public_names(ref) - _public_names(port)
        missing += [f"{rel}::{n}" for n in sorted(gone)
                    if (rel, n) not in EXCLUDED]
        stale += [f"{rel}::{n}" for (m, n) in EXCLUDED
                  if m == rel and n not in gone]
    assert not missing, f"reference names with no twin in the port: " \
                        f"{missing}"
    assert not stale, f"exclusions the port no longer needs: {stale}"
