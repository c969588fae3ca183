"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), leaf by leaf.

Every config of the registry at its full shapes: the reference's from
``jax.eval_shape`` of its initializer, the port's from its initializer on
the meta device (``launch.train.param_shapes``: nothing allocated).  The
shapes and the paths must agree, and so must ``leaf_spec`` /
``params_sharding`` at model sizes 1, 2, 4 and 16, unstacked and stacked
over one learner axis or two (``pod``, ``data``); ``batch_sharding`` of
the config's training batch; ``cache_sharding`` of its decode cache
(every family that takes ``init_cache(params, batch, buf_len)``).  The
reference's own cases (``tests/test_sharding_rules.py``,
``tests/test_cache_sharding.py``) run against the port as parametrised
cases.  Specs are compared as tuples, a 1-tuple of axes read as its axis
(JAX's ``PartitionSpec`` normalizes it so).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import sharding as js  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.launch import sharding as ps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.train import (param_shapes,  # noqa: E402
                                      stacked_param_specs,
                                      train_state_shardings,
                                      train_state_specs)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

CONFIGS = sorted(REGISTRY)
MODEL_SIZES = (1, 2, 4, 16)
L = 4


class _Mesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _meshes(model):
    return [(("data", "model"), (L, model)),
            (("pod", "data", "model"), (2, L // 2, model))]


def _norm(spec):
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out)


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(js._path_str(p), leaf) for p, leaf in flat]


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [_norm(s) for s in flat]


def _port_flat(tree):
    return [("/".join(str(k) for k in p).lower(), leaf)
            for p, leaf in tree_flatten_with_path(tree)]


_SHAPES = {}


def _shapes(name):
    """(reference ShapeDtypeStruct tree, port meta tree) of one learner."""
    if name not in _SHAPES:
        japi = jax_build_model(jax_get_config(name))
        ref = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
        api = build_model(get_config(name), device="cpu")
        _SHAPES[name] = (ref, param_shapes(api), api)
    return _SHAPES[name]


def _stacked(tree):
    """``stacked_param_specs``' tree from shapes already made."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: torch.empty((L,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta"),
                    tree)


def test_stacked_param_specs_add_the_learner_dim():
    _, port, api = _shapes("transformer-100m")
    got, want = stacked_param_specs(api, L), _stacked(port)
    assert [(k, tuple(x.shape), x.dtype, x.device.type)
            for k, x in _port_flat(got)] == \
        [(k, tuple(x.shape), x.dtype, "meta") for k, x in _port_flat(want)]


@pytest.mark.parametrize("name", CONFIGS)
def test_param_shapes_and_paths_equal_the_reference(name):
    ref, port, _ = _shapes(name)
    r, p = _ref_flat(ref), _port_flat(port)
    assert [k for k, _ in r] == [k for k, _ in p]
    for (k, a), (_, b) in zip(r, p):
        assert tuple(a.shape) == tuple(b.shape), k
        assert b.device.type == "meta"


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_equal_the_reference(name, model):
    ref, port, api = _shapes(name)
    stacked_ref = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((L,) + s.shape, s.dtype), ref)
    stacked_port = _stacked(port)
    for names, sizes in _meshes(model):
        jm, pm = _Mesh(names, sizes), MeshShape(names, sizes)
        for stacked, rt, pt in ((False, ref, port),
                                (True, stacked_ref, stacked_port)):
            want = _ref_specs(js.params_sharding(rt, jm, stacked=stacked))
            got = [_norm(s) for s in tree_leaves(
                ps.params_sharding(pt, pm, stacked=stacked))]
            paths = [k for k, _ in _port_flat(pt)]
            assert len(got) == len(want)
            for k, g, w in zip(paths, got, want):
                assert g == w, (names, stacked, k, g, w)


@pytest.mark.parametrize("name", CONFIGS)
def test_batch_specs_equal_the_reference(name):
    _, _, api = _shapes(name)
    japi = jax_build_model(jax_get_config(name))
    for gb in (16, 6, 1):
        want_shapes = japi.train_batch_spec(gb, 4096)
        got_shapes = api.train_batch_spec(gb, 4096)
        for model in (1, 16):
            for names, sizes in _meshes(model):
                want = js.batch_sharding(
                    want_shapes, _Mesh(names, sizes), stacked=False)
                got = ps.batch_sharding(
                    {k: torch.empty(s, device="meta")
                     for k, (s, _) in got_shapes.items()},
                    MeshShape(names, sizes), stacked=False)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert _norm(got[k]) == _norm(want[k]), (gb, names, k)


CACHE_CONFIGS = [n for n in CONFIGS if get_config(n).family != "audio"]


@pytest.mark.parametrize("name", CACHE_CONFIGS)
def test_cache_specs_equal_the_reference(name):
    from repro_torch.launch.train import _OnMeta
    ref_params, _, _ = _shapes(name)
    japi = jax_build_model(jax_get_config(name))
    want_shapes = jax.eval_shape(lambda: japi.init_cache(ref_params, 16,
                                                         4096))
    api = build_model(get_config(name), device="cpu")
    with torch.device("meta"), _OnMeta():
        got_shapes = api.init_cache(None, 16, 4096)
    for model in (2, 16):
        for names, sizes in _meshes(model):
            want = _ref_specs(js.cache_sharding(want_shapes,
                                                _Mesh(names, sizes)))
            got = [_norm(s) for s in tree_leaves(ps.cache_sharding(
                got_shapes, MeshShape(names, sizes)))]
            assert got == want, (names, model)


# ---------------------------------------------------------------------------
# the reference's own cases
# ---------------------------------------------------------------------------

RULE_CASES = [
    (("mlp", "w1"), (1024, 4096), 16, None, (None, "model")),
    (("mlp", "w2"), (4096, 1024), 16, None, ("model", None)),
    (("mixer", "wq"), (1024, 2048), 16, None, (None, "model")),
    (("mixer", "wo"), (2048, 1024), 16, None, ("model", None)),
    (("norm1",), (1024,), 16, None, (None,)),
    (("mlp", "w1"), (128, 4096, 1536), 16, None, ("model", None, None)),
    (("mlp", "w1"), (40, 1536, 512), 16, None, (None, None, "model")),
    (("mlp", "w2"), (40, 512, 1536), 16, None, (None, "model", None)),
    (("mlp", "w1"), (16, 1024, 4096), 16, ("pod", "data"),
     (("pod", "data"), None, "model")),
    (("mixer", "wk"), (100, 6), 16, None, (None, None)),
    (("embed",), (256256, 4096), 16, None, ("model", None)),
]


@pytest.mark.parametrize("path,shape,model,learner,want", RULE_CASES)
def test_reference_rule_cases(path, shape, model, learner, want):
    class _K:
        def __init__(self, k):
            self.key = k

    ref = js.leaf_spec(tuple(_K(n) for n in path),
                       jax.ShapeDtypeStruct(shape, jnp.float32), model,
                       learner_axes=learner)
    got = ps.leaf_spec(path, torch.empty(shape, device="meta"), model,
                       learner_axes=learner)
    assert _norm(got) == _norm(ref) == _norm(want)


CACHE_CASES = [
    ({"k": (44, 128, 32768, 8, 128), "v": (44, 128, 32768, 8, 128),
      "slot_pos": (44, 32768)},
     {"k": (None, "data", "model", None, None),
      "v": (None, "data", "model", None, None), "slot_pos": (None, None)}),
    ({"h": (4, 128, 8192, 16), "conv": (4, 128, 3, 8192)},
     {"h": (None, "data", "model", None),
      "conv": (None, "data", None, "model")}),
    ({"k": (44, 1, 4096, 8, 128)}, {"k": (None, None, "model", None, None)}),
    ({"xk": (24, 128, 4096, 16, 64)},
     {"xk": (None, "data", "model", None, None)}),
]


@pytest.mark.parametrize("shapes,want", CACHE_CASES,
                         ids=["attn", "mamba", "batch_one", "cross_attn"])
def test_reference_cache_cases(shapes, want):
    ref = js.cache_sharding(
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()},
        _Mesh(("data", "model"), (16, 16)))
    got = ps.cache_sharding(
        {k: torch.empty(s, device="meta") for k, s in shapes.items()},
        MeshShape(("data", "model"), (16, 16)))
    for k in shapes:
        assert _norm(got[k]) == _norm(ref[k]) == _norm(want[k]), k


# ---------------------------------------------------------------------------
# placements, and the train-state specs
# ---------------------------------------------------------------------------

def test_placements_name_the_sharded_dims():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape(("pod", "data", "model"), (2, 8, 16))
    assert ps.placements(ps.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert ps.placements(ps.P(None, None), mesh) == (Replicate(),) * 3
    assert ps.spec_dim(ps.P(None, "model")) == 1
    assert ps.spec_dim(ps.P(None, None)) is None


@pytest.mark.parametrize("algo", ["dpsgd", "adpsgd", "ssgd"])
def test_train_state_shardings_equal_the_reference(algo):
    """The reference's ``train_state_specs`` / ``train_state_shardings``
    (which read only the mesh's axis names and sizes) against the port's,
    on granite-moe-3b-a800m with momentum SGD: parameters, momentum,
    buffer and the per-learner operands."""
    from repro import optim as jopt
    from repro.launch import train as jt
    from repro_torch import optim as popt
    name = "granite-moe-3b-a800m"
    _, _, api = _shapes(name)
    japi = jax_build_model(jax_get_config(name))
    names, sizes = ("data", "model"), (L, 4)
    jm, pm = _Mesh(names, sizes), MeshShape(names, sizes)
    want = jt.train_state_shardings(
        jt.train_state_specs(japi, jopt.sgd(0.1, momentum=0.9), jm,
                             algo=algo), jm, algo=algo)
    specs = train_state_specs(api, popt.sgd(0.1, momentum=0.9), pm,
                              algo=algo)
    got = train_state_shardings(specs, pm, algo=algo)
    for leaf in tree_leaves(specs.params) + tree_leaves(specs.opt_state):
        assert leaf.device.type == "meta"
    assert [_norm(s) for s in tree_leaves(got.params)] == \
        _ref_specs(want.params)
    assert [_norm(s) for s in tree_leaves(got.opt_state)] == \
        _ref_specs(want.opt_state)
    if algo == "adpsgd":
        assert [_norm(s) for s in tree_leaves(got.buffer)] == \
            _ref_specs(want.buffer)
        assert _norm(got.age) == _norm(want.age) == ("data",)


# ---------------------------------------------------------------------------
# meshes and the model code's view of them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "two_pods"])
def test_mesh_helpers_equal_the_reference(multi_pod):
    """The reference's production meshes and its learner-axis helpers
    (which read only the mesh's names and sizes) against the port's."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as pmesh
    shape = pmesh.production_mesh_shape(multi_pod=multi_pod)
    want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    assert (shape.sizes, shape.axis_names) == want
    jm = _Mesh(shape.axis_names, shape.sizes)
    assert pmesh.learner_axes(shape) == jmesh.learner_axes(jm)
    assert pmesh.n_learners(shape) == jmesh.n_learners(jm)
    assert pmesh.model_size(shape) == 16


def test_shard_hints_read_the_current_mesh():
    from repro_torch.models import shard_hints as sh
    x = torch.zeros(2, 3, 4)
    assert sh.current_mesh() is None and sh.mesh_axes() == ()
    assert sh.axis_size("model") == 1 and not sh.has_axis("model")
    with sh.use_mesh(MeshShape(("data", "model"), (4, 2))):
        assert sh.mesh_axes() == ("data", "model")
        assert sh.has_axis("model") and sh.axis_size("model") == 2
        assert sh.hint(x, "data", None, "model") is x
        assert sh.residual_hint(x) is x
        assert sh.model_group() is None     # a MeshShape has no groups
        assert sh.batch_axes() == sh.DATA_AXES
        with sh.activation_batch_axes(()):
            assert sh.batch_axes() == ()
        assert sh.batch_axes() == sh.DATA_AXES
    assert sh.current_mesh() is None
