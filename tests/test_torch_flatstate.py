"""The port's flat parameter store against the JAX reference's.

``repro_torch.core.flatstate`` must lay a parameter tree out exactly as
``repro.core.flatstate`` does — leaf order, offsets, padding, row count —
so the port's (n, T, 128) store equals the reference's bitwise for the
same parameters.  Its views must alias the store, and the trainer's
binding must put every gradient into one grad buffer without a
parameter-sized concatenate (or a buffer-sized zero from a slice
backward).  ``FlatMeta.scatter``, the transpose of ``unflatten``, must
give the reference's buffer for the same tree (a learner axis, a ``None``
leaf) without a concatenate, and ``FlatMeta.for_tree`` the cached
metadata.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.flatstate import flat_meta as jax_flat_meta  # noqa: E402
from repro_torch.analysis import trace_audit  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.core.flatstate import LANE, FlatMeta, flat_meta  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

N = 3


def _jax_trees():
    fc = jax_fcnet.init_params(jax.random.PRNGKey(0), in_dim=784, hidden=50)
    cfg = jax_get_config("transformer-100m").smoke_config()
    tf = jax_build_model(cfg).init(jax.random.PRNGKey(1))
    return {"fcnet": fc, "transformer-100m-smoke": tf}


JAX_TREES = _jax_trees()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_roundtrip_dtypes_and_padding():
    bf16 = torch.ones((3, 5), dtype=torch.bfloat16)
    tree = {"a": torch.arange(10.0), "b": {"c": bf16}, "d": torch.tensor(2.0)}
    meta = flat_meta(tree)
    assert meta.rows % 8 == 0 and meta.n_elem == 10 + 15 + 1
    flat = meta.flatten(tree)
    assert flat.shape == (meta.rows, LANE) and flat.dtype == torch.float32
    back = meta.unflatten(flat)
    assert back["b"]["c"].dtype == torch.bfloat16
    assert back["d"].shape == () and float(back["d"]) == 2.0
    torch.testing.assert_close(back["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(back["b"]["c"], tree["b"]["c"], rtol=0, atol=0)
    # the pad region is exactly zero
    assert (flat.reshape(-1)[meta.n_elem:] == 0).all()
    # a leading learner axis rides along
    stacked = tree_map(lambda x: torch.stack([x, 2 * x]), tree)
    fs = meta.flatten(stacked)
    assert fs.shape == (2, meta.rows, LANE)
    torch.testing.assert_close(meta.unflatten(fs)["a"][1], 2 * tree["a"],
                               rtol=0, atol=0)


def test_unflatten_returns_views_of_the_store():
    tree = {"w": torch.randn(7, 9), "b": torch.zeros(9)}
    meta = flat_meta(tree)
    flat = meta.flatten(tree)
    view = meta.unflatten(flat)
    flat.view(-1)[meta.offsets[1]] = 123.0     # first element of "w"
    assert float(view["w"][0, 0]) == 123.0
    assert view["w"].untyped_storage().data_ptr() == \
        flat.untyped_storage().data_ptr()


@pytest.mark.parametrize("name", sorted(JAX_TREES))
def test_store_equals_reference_bitwise(name):
    jtree = JAX_TREES[name]
    jstacked = jax.tree_util.tree_map(
        lambda p: jnp.broadcast_to(p[None], (N,) + p.shape), jtree)
    jmeta = jax_flat_meta(jtree)
    want = np.asarray(jmeta.flatten(jstacked))

    tree = tree_from_jax(_np_tree(jtree))
    meta = flat_meta(tree)
    assert (meta.offsets, meta.sizes, meta.rows, meta.n_elem) == (
        jmeta.offsets, jmeta.sizes, jmeta.rows, jmeta.n_elem)
    assert meta.shapes == jmeta.shapes
    got = meta.flatten(tree_map(lambda p: torch.stack([p] * N), tree))
    np.testing.assert_array_equal(got.numpy(), want)
    # and back: every leaf of the reference's unflatten, bitwise
    jback = jax.tree_util.tree_leaves(jmeta.unflatten(jnp.asarray(want)))
    for a, b in zip(tree_leaves(meta.unflatten(got)), jback):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(JAX_TREES))
def test_scatter_of_unflatten_is_the_store_bitwise(name):
    """The twin of the reference's
    ``test_flat_meta_scatter_is_unflatten_transpose``; and the metadata is
    cached per structure, ``for_tree`` included."""
    tree = tree_from_jax(_np_tree(JAX_TREES[name]))
    meta = flat_meta(tree)
    assert FlatMeta.for_tree(tree) is meta is flat_meta(tree)
    flat = meta.flatten(tree)
    back = meta.scatter(meta.unflatten(flat))
    assert back.dtype == torch.float32 and back.shape == flat.shape
    assert torch.equal(back, flat)


def test_scatter_equals_reference_with_a_learner_axis_and_a_none_leaf():
    jtree = JAX_TREES["fcnet"]
    rng = np.random.default_rng(3)
    stacked = {k: rng.standard_normal((N,) + tuple(v.shape),
                                      dtype=np.float32)
               for k, v in jtree.items()}
    stacked["b2"] = None            # a leaf with no cotangent
    want = np.asarray(jax_flat_meta(jtree).scatter(
        {k: None if v is None else jnp.asarray(v)
         for k, v in stacked.items()}))
    meta = flat_meta(tree_from_jax(_np_tree(jtree)))
    got = meta.scatter({k: None if v is None else torch.tensor(v)
                        for k, v in stacked.items()})
    assert got.shape == (N, meta.rows, LANE)
    np.testing.assert_array_equal(got.numpy(), want)
    # the None leaf's slot and the pad region stay zero
    i = sorted(jtree).index("b2")
    off, sz = meta.offsets[i], meta.sizes[i]
    v = got.reshape(N, -1)
    assert not v[:, off:off + sz].any() and not v[:, meta.n_elem:].any()


def test_scatter_makes_no_concatenate():
    tree = tree_from_jax(_np_tree(JAX_TREES["transformer-100m-smoke"]))
    meta = flat_meta(tree)
    stacked = tree_map(lambda p: torch.stack([p] * N), tree)
    with trace_audit.StepTrace("cpu") as t:
        meta.scatter(stacked)
    assert t.ops and trace_audit.max_concat_elems(t) == 0


class _Recorder(TorchDispatchMode):
    """Records (op name, output numel) of every aten op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(o, torch.Tensor):
                self.ops.append((str(func.overloadpacket.__name__),
                                 o.numel()))
        return out


def _batch(n, b, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": torch.tensor(rng.random((n, b, 784), dtype=np.float32)),
            "label": torch.tensor(rng.integers(0, 10, (n, b)),
                                  dtype=torch.int32)}


def test_gradients_land_in_the_grad_buffer_without_a_cat():
    n, b = 3, 16
    params = fcnet.init_params(torch.Generator().manual_seed(0))
    tr = MultiLearnerTrainer(fcnet.loss_fn, sgd(0.1),
                             AlgoConfig(algo="dpsgd", topology="ring",
                                        n_learners=n), device="cpu")
    st = tr.init(0, params)
    batch = _batch(n, b)
    n_param = tr._meta.n_elem
    with _Recorder() as rec:
        losses = tr._grads(tr._bound(st.params), batch)
    big = [(op, k) for op, k in rec.ops
           if k >= n_param and op not in ("zero_", "add_")]
    assert big == [], big
    # each learner's gradient, computed the ordinary way on a copy
    for i in range(n):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = fcnet.loss_fn(p, {k: v[i] for k, v in batch.items()})
        grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)])
        want = tr._meta.flatten(dict(zip(sorted(p), grads)))
        torch.testing.assert_close(tr._g[i], want, rtol=0, atol=0)
        torch.testing.assert_close(losses[i], loss.detach(), rtol=0, atol=0)
    # the pad rows never receive a gradient
    assert (tr._g.reshape(n, -1)[:, n_param:] == 0).all()


def test_learner_statistics_match_reference():
    from repro.core.util import learner_mean as jax_mean
    from repro.core.util import learner_var as jax_var
    from repro_torch.core.util import learner_mean, learner_var
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 7, 3), dtype=np.float32),
            "b": {"c": rng.standard_normal((5, 11), dtype=np.float32)}}
    port = tree_from_jax(tree)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for a, b in zip(tree_leaves(learner_mean(port)),
                    jax.tree_util.tree_leaves(jax_mean(jtree))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(float(learner_var(port)),
                               float(jax_var(jtree)), rtol=1e-6)
