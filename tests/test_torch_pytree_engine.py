"""The port's pytree engine (``engine="pytree"``), SSGD* and the engine
routing against the JAX reference, and the flat engine's bf16 leaves and
``state_from_view``.

Both trainers start from the reference's FC-net parameters and see the
reference's batches, gossip tables (``train_step(..., rounds=...)``) and,
for SSGD*, the reference's weight noise (``train_step(..., noise=...)``,
recomputed here as the reference draws it), so every step's parameters,
momentum and ``StepMetrics`` must agree.

Tolerances:
  * against the reference, per step: ``tests/test_torch_trainer.py``'s
    tiers (parameters, momentum and buffer 1e-5 absolute + 1e-4 relative;
    metrics 1e-4 relative): the same float32 algebra, the matrix products
    summed in other orders;
  * the port's flat engine against its pytree engine: the reference's own
    tier for the same comparison (``tests/test_flat_engine.py``: 2e-5
    absolute and relative after 12 steps, losses 1e-5);
  * bf16 leaves on the flat engine against the reference's flat engine:
    transformer-100m's smoke config in bf16, 2 DPSGD steps; the change of
    the float32 store from its start within 2e-2 relative (Frobenius) of
    the reference's, the losses within 1e-3 relative — the bf16 tier of
    ``tests/test_torch_dense_flash.py`` (each side's bf16 forward and
    backward round in other places; measured 1.4e-2);
  * ``state_view`` then ``state_from_view``: bitwise.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.core.util import tree_gaussian_like as jax_gaussian  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro.data import SyntheticTokenStream as JaxTokens  # noqa: E402
from repro.data import TemplateImages as JaxImages  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.core import trainer as trainer_mod  # noqa: E402
from repro_torch.data import ShardedLoader, TemplateImages  # noqa: E402
from repro_torch.models import build_model, fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_RTOL = 1e-4
ENGINE_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_RTOL = 2e-2
FIELDS = ("loss", "grad_norm", "sigma_w_sq", "staleness_mean",
          "staleness_max", "n_active", "grad_sq_mean")
FC_PARAMS = jax_fcnet.init_params(jax.random.PRNGKey(0), in_dim=784,
                                  hidden=50)
TOPOLOGIES = ["random_pair", "ring", "torus", "full", "hierarchical", "exp",
              "one_peer_exp", "random_matching", "solo"]
ADPSGD_KW = dict(max_staleness=2, slow_learner=1, slow_factor=3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _keys(jstate):
    key = jax.random.fold_in(jstate.rng, jstate.step)
    return jax.random.split(key)


def _ref_rounds(jtr, jstate):
    if jtr._schedule is None:
        return None
    k_mix, _ = _keys(jstate)
    return [(np.array(p), np.array(c))
            for p, c in jtr._schedule.step_rounds(k_mix, int(jstate.step))]


def _ref_noise(jtr, jstate):
    """The reference's SSGD* draw at this step (``_train_step_tree``)."""
    _, k_noise = _keys(jstate)
    return tree_from_jax(_np(jax_gaussian(k_noise, jstate.params,
                                          jtr.algo.noise_std)))


def _mu(opt_state):
    while isinstance(opt_state, dict) and "mu" not in opt_state:
        opt_state = opt_state.get("inner")
    return None if not opt_state else opt_state["mu"]


def _assert_trees(got, want, tol, what):
    want = _np(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **tol,
                                   err_msg=f"{what} {k}")


def _compare(jstate, jm, pstate, pm, what):
    _assert_trees(pstate.params, jstate.params, PARAM_TOL, f"{what} params")
    jmu, pmu = _mu(jstate.opt_state), _mu(pstate.opt_state)
    assert (jmu is None) == (pmu is None)
    if jmu is not None:
        _assert_trees(pmu, jmu, PARAM_TOL, f"{what} momentum")
    if jstate.buffer is not None:
        _assert_trees(pstate.buffer, jstate.buffer, PARAM_TOL,
                      f"{what} buffer")
        np.testing.assert_array_equal(pstate.age.numpy(),
                                      np.asarray(jstate.age))
        np.testing.assert_array_equal(pstate.clock.numpy(),
                                      np.asarray(jstate.clock))
    for f in FIELDS:
        np.testing.assert_allclose(float(getattr(pm, f)),
                                   float(getattr(jm, f)), rtol=METRIC_RTOL,
                                   atol=1e-12, err_msg=f"{what} {f}")


def _tree_parity(algo, topology, steps, *, n=8, jopt=None, popt=None,
                 **algo_kw):
    """The reference's pytree engine against the port's, step by step.
    (At n = 6, descend_then_mix, step 2, one hidden unit's ReLU turns on a
    last-bit difference of its input and moves a column of w1 by 1.7e-5
    on BOTH engines of the port against the reference: the kink, not an
    engine; n = 8 as in ``tests/test_torch_trainer.py``.)"""
    jopt = jopt or jax_optim.sgd(0.1, momentum=0.9)
    popt = popt or optim.sgd(0.1, momentum=0.9)
    loader = JaxLoader(JaxImages(), n_learners=n, local_batch=32, seed=0)
    jtr = JaxTrainer(jax_fcnet.loss_fn, jopt,
                     JaxAlgoConfig(algo=algo, topology=topology,
                                   n_learners=n, **algo_kw),
                     engine="pytree")
    ptr = MultiLearnerTrainer(fcnet.loss_fn, popt,
                              AlgoConfig(algo=algo, topology=topology,
                                         n_learners=n, **algo_kw),
                              engine="pytree", device="cpu")
    assert not ptr.is_flat and not jtr.is_flat
    jstate = jtr.init(jax.random.PRNGKey(0), FC_PARAMS)
    pstate = ptr.init(0, tree_from_jax(_np(FC_PARAMS)))
    for step in range(steps):
        b = loader.batch(step)
        noise = _ref_noise(jtr, jstate) if algo == "ssgd_star" else None
        pstate, pm = ptr.train_step(pstate, _torch_batch(b),
                                    _ref_rounds(jtr, jstate), noise)
        jstate, jm = jtr.train_step(jstate, b)
        _compare(jstate, jm, pstate, pm, what=f"{algo}/{topology} {step}")
    return ptr, pstate, pm


@pytest.mark.parametrize("order", ["mix_then_descend", "descend_then_mix"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_pytree_dpsgd_matches_reference(topology, order):
    kw = dict(gossip_rounds=2) if topology == "random_matching" else {}
    _tree_parity("dpsgd", topology, 3, gossip_order=order, **kw)


@pytest.mark.parametrize("algo", ["ssgd", "ssgd_star"])
def test_pytree_ssgd_and_ssgd_star_match_reference(algo):
    tr, state, m = _tree_parity(algo, "random_pair", 3, noise_std=0.01)
    # every learner holds the same weights, so the variance is exactly 0,
    # as in the reference
    assert float(m.sigma_w_sq) == 0.0
    assert tr.rounds_per_step == 0


@pytest.mark.parametrize("kw", [
    dict(max_staleness=4, slow_learner=0, slow_factor=3),
    dict(max_staleness=1, slow_learner=2, slow_factor=2),
    dict(max_staleness=0)], ids=["tau4-slow3", "tau1-slow2", "sync"])
def test_pytree_adpsgd_matches_reference_with_a_straggler(kw):
    _tree_parity("adpsgd", "random_pair", 4, n=6, **kw)


def _own_trainer(algo, engine, *, n=4, backend="auto", **kw):
    return MultiLearnerTrainer(fcnet.loss_fn, optim.sgd(0.1, momentum=0.9),
                               AlgoConfig(algo=algo, n_learners=n, **kw),
                               engine=engine, kernel_backend=backend,
                               device="cpu")


def _own_loader(n=4):
    return ShardedLoader(TemplateImages(), n_learners=n, local_batch=32,
                         seed=0, device="cpu")


def _own_run(algo, engine, steps, *, n=4, backend="auto", **kw):
    """The port alone, on its own draws (same seed for both engines)."""
    tr = _own_trainer(algo, engine, n=n, backend=backend, **kw)
    loader = _own_loader(n)
    st = tr.init(3, fcnet.init_params(torch.Generator().manual_seed(0)))
    losses = []
    for i in range(steps):
        st, m = tr.train_step(st, loader.batch(i))
        losses.append(float(m.loss))
    return tr, st, losses


@pytest.mark.parametrize("algo,kw", [
    ("dpsgd", {}), ("dpsgd", dict(topology="ring")),
    ("dpsgd", dict(topology="hierarchical", n_learners=None)),
    ("adpsgd", ADPSGD_KW), ("ssgd", {})],
    ids=["dpsgd-pair", "dpsgd-ring", "dpsgd-hier", "adpsgd", "ssgd"])
def test_port_flat_equals_port_pytree(algo, kw):
    kw = dict(kw)
    n = 8 if kw.pop("n_learners", 4) is None else 4
    steps = 12
    tr_t, st_t, l_t = _own_run(algo, "pytree", steps, n=n, **kw)
    tr_f, st_f, l_f = _own_run(algo, "flat", steps, n=n, **kw)
    assert tr_f.is_flat and not tr_t.is_flat
    view = tr_f.state_view(st_f)
    for k in st_t.params:
        np.testing.assert_allclose(view.params[k].numpy(),
                                   st_t.params[k].numpy(), **ENGINE_TOL)
        np.testing.assert_allclose(view.opt_state["mu"][k].numpy(),
                                   st_t.opt_state["mu"][k].numpy(),
                                   **ENGINE_TOL)
    np.testing.assert_allclose(l_f, l_t, atol=1e-5)
    if algo == "adpsgd":
        np.testing.assert_array_equal(st_f.age.numpy(), st_t.age.numpy())
        np.testing.assert_array_equal(st_f.clock.numpy(), st_t.clock.numpy())
        for k in st_t.buffer:
            np.testing.assert_allclose(view.buffer[k].numpy(),
                                       st_t.buffer[k].numpy(), **ENGINE_TOL)


OPTIMIZERS = {
    "sgd": (lambda o: o.sgd(0.1)),
    "momentum": (lambda o: o.sgd(0.1, momentum=0.9)),
    "adam": (lambda o: o.adam(1e-3)),
    "lamb": (lambda o: o.lamb(1e-3)),
    "decentlam": (lambda o: o.decentlam(0.1, momentum=0.9, drift_scale=0.1)),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("algo", ["ssgd", "ssgd_star", "dpsgd", "adpsgd"])
def test_auto_routing_equals_reference(algo, opt):
    make = OPTIMIZERS[opt]
    kw = dict(algo=algo, topology="random_pair", n_learners=4)
    jtr = JaxTrainer(jax_fcnet.loss_fn, make(jax_optim), JaxAlgoConfig(**kw))
    ptr = MultiLearnerTrainer(fcnet.loss_fn, make(optim), AlgoConfig(**kw),
                              device="cpu")
    assert ptr.is_flat == jtr.is_flat
    assert ptr.is_fused == (jtr._fused is not None)
    assert ptr.rounds_per_step == (0 if algo.startswith("ssgd") else 1)
    for engine in ("flat", "pytree"):
        try:
            JaxTrainer(jax_fcnet.loss_fn, make(jax_optim),
                       JaxAlgoConfig(**kw), engine=engine)
        except ValueError:
            with pytest.raises(ValueError):
                MultiLearnerTrainer(fcnet.loss_fn, make(optim),
                                    AlgoConfig(**kw), engine=engine,
                                    device="cpu")
        else:
            tr = MultiLearnerTrainer(fcnet.loss_fn, make(optim),
                                     AlgoConfig(**kw), engine=engine,
                                     device="cpu")
            assert tr.is_flat == (engine == "flat")


@pytest.mark.parametrize("algo,kw", [("dpsgd", {}), ("adpsgd", ADPSGD_KW)])
def test_state_from_view_round_trips_bitwise(algo, kw):
    tr, st, _ = _own_run(algo, "flat", 3, **kw)
    before = [st.params.clone(), st.opt_state["mu"].clone()]
    if st.buffer is not None:
        before.append(st.buffer.clone())
    back = tr.state_from_view(tr.state_view(st))
    after = [back.params, back.opt_state["mu"]]
    if back.buffer is not None:
        after.append(back.buffer)
    for a, b in zip(after, before):
        assert a.shape == b.shape and torch.equal(a, b)
    assert back.params is tr._w[0] and back.step == st.step
    # the restored state trains on as the original would have
    loader = ShardedLoader(TemplateImages(), n_learners=4, local_batch=32,
                           seed=0, device="cpu")
    st2, m2 = tr.train_step(back, loader.batch(3))
    tr3, st3, l3 = _own_run(algo, "flat", 4, **kw)
    assert torch.equal(st2.params, st3.params)
    assert float(m2.loss) == l3[-1]
    # a pytree trainer's view is its state, and restoring it keeps the
    # store
    trt, stt, _ = _own_run(algo, "pytree", 1, **kw)
    before = [x.clone() for x in trt.params_tree(stt).values()]
    assert trt.state_view(stt) is stt
    back = trt.state_from_view(stt)
    assert back.params is trt._w[0] and back.opt_state is stt.opt_state
    for a, b in zip(back.params.values(), before):
        assert torch.equal(a, b)


def _clone_view(view):
    """A saved copy of a tree-layout state: no tensor shared with it."""
    def clone(t):
        return None if t is None else tree_map(torch.clone, t)
    return view._replace(params=clone(view.params),
                         opt_state=clone(view.opt_state),
                         buffer=clone(view.buffer), age=clone(view.age),
                         clock=clone(view.clock))


@pytest.mark.parametrize("engine", ["flat", "pytree"])
@pytest.mark.parametrize("algo,kw", [("dpsgd", {}), ("adpsgd", ADPSGD_KW),
                                     ("ssgd", {})],
                         ids=["dpsgd", "adpsgd", "ssgd"])
def test_state_from_view_restores_into_a_fresh_trainer(algo, kw, engine):
    """A saved view, restored into a fresh trainer started from other
    weights, takes the next step bit for bit as the uninterrupted run;
    ``train_step`` refuses the saved view itself."""
    tr, st, _ = _own_run(algo, engine, 3, **kw)
    saved = _clone_view(tr.state_view(st))
    del tr, st
    fresh = _own_trainer(algo, engine, **kw)
    fresh.init(3, fcnet.init_params(torch.Generator().manual_seed(5)))
    batch = _own_loader().batch(3)
    with pytest.raises(ValueError, match="state_from_view"):
        fresh.train_step(saved, batch)
    st2, m2 = fresh.train_step(fresh.state_from_view(saved), batch)
    tr4, st4, l4 = _own_run(algo, engine, 4, **kw)
    got, want = fresh.params_tree(st2), tr4.params_tree(st4)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(m2.loss) == l4[-1]
    if algo == "adpsgd":
        got, want = fresh.state_view(st2), tr4.state_view(st4)
        for k in want.buffer:
            assert torch.equal(got.buffer[k], want.buffer[k]), k
        assert torch.equal(st2.age, st4.age)


def test_bf16_leaves_on_flat_engine_match_reference():
    n, b, seq = 4, 2, 32
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(
        jax_get_config("transformer-100m").smoke_config(), **kw)
    cfg = dataclasses.replace(get_config("transformer-100m").smoke_config(),
                              **kw)
    japi, api = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jparams = japi.init(jax.random.PRNGKey(0))
    loader = JaxLoader(JaxTokens(vocab=jcfg.vocab), n_learners=n,
                       local_batch=b, extra_args=(seq,))
    algo = dict(algo="dpsgd", topology="random_pair", n_learners=n)
    jtr = JaxTrainer(japi.loss_fn, jax_optim.sgd(0.1, momentum=0.9),
                     JaxAlgoConfig(**algo), engine="flat",
                     kernel_backend="ref")
    ptr = MultiLearnerTrainer(api.loss_fn, optim.sgd(0.1, momentum=0.9),
                              AlgoConfig(**algo),
                              params_from_tree=api.params_from_tree,
                              device="cpu")
    jstate = jtr.init(jax.random.PRNGKey(0), jparams)
    pstate = ptr.init(0, tree_from_jax(_np(jparams)))
    assert ptr.is_flat and ptr.is_fused
    # the weights are bf16 and cast; the norms are float32 and views
    n_bf16 = sum(d == torch.bfloat16 for d in ptr._meta.dtypes)
    assert 0 < len(ptr._casts) == n_bf16 < len(ptr._meta.dtypes)
    start = np.asarray(jstate.params).copy()
    np.testing.assert_array_equal(pstate.params.numpy(), start)
    for step in range(2):
        batch = loader.batch(step)
        rounds = _ref_rounds(jtr, jstate)
        pstate, pm = ptr.train_step(pstate, _torch_batch(batch), rounds)
        jstate, jm = jtr.train_step(jstate, batch)
        np.testing.assert_allclose(float(pm.loss), float(jm.loss),
                                   rtol=1e-3)
        want = np.asarray(jstate.params) - start
        got = pstate.params.numpy() - start
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_RTOL, (step, rel)
    # the views of the store come back in the leaves' own dtype
    view = ptr.params_tree(pstate)
    assert view["embed"].dtype == torch.bfloat16
    assert np.isfinite(pstate.params.numpy()).all()


def test_mixed_dtype_leaves_on_flat_engine_match_pytree():
    """A tree with float32 and bf16 leaves: float32 leaves keep their
    zero-copy views, the bf16 leaf is cast; the flat engine's store holds
    what the pytree engine's float32 leaves hold after each step."""
    n = 4
    gen = torch.Generator().manual_seed(0)
    p0 = fcnet.init_params(gen)
    p0["w3"] = p0["w3"].to(torch.bfloat16)

    def loss(params, batch):
        params = dict(params, w3=params["w3"].float())
        return fcnet.loss_fn(params, batch)

    loader = ShardedLoader(TemplateImages(), n_learners=n, local_batch=32,
                           seed=0, device="cpu")
    tr = MultiLearnerTrainer(loss, optim.sgd(0.1, momentum=0.9),
                             AlgoConfig(algo="dpsgd", n_learners=n),
                             engine="flat", kernel_backend="ref",
                             device="cpu")
    st = tr.init(0, p0)
    assert list(tr._casts) == [tr._meta.shapes.index((50, 10))]
    views = tr._meta.views(st.params)
    for i, b in enumerate(tr._bound(st.params)):
        # float32 leaves share the store's memory; w3 is the cast leaf
        assert b.params["w1"].data_ptr() == views[
            sorted(p0).index("w1")][i].data_ptr()
        assert b.params["w3"].dtype == torch.bfloat16
    g0 = None
    for i in range(2):
        st, m = tr.train_step(st, loader.batch(i))
        if g0 is None:
            g0 = float(m.grad_norm)
    assert np.isfinite(g0) and g0 > 0
    w3 = tr.params_tree(st)["w3"]
    assert w3.dtype == torch.bfloat16 and torch.isfinite(w3.float()).all()
    # the bf16 leaf's gradient reached the float32 grad store
    assert float(tr._meta.views(tr._g)[sorted(p0).index("w3")].abs().sum()) \
        > 0


def _star_trainer(std, n=4):
    return MultiLearnerTrainer(
        fcnet.loss_fn, optim.sgd(0.1),
        AlgoConfig(algo="ssgd_star", n_learners=n, noise_std=std),
        device="cpu")


def test_ssgd_star_draws_by_property():
    tr = _star_trainer(0.01)
    st = tr.init(7, fcnet.init_params(torch.Generator().manual_seed(0)))
    like = st.params
    d0 = tr._noise(st, like, None)
    d0b = tr._noise(st, like, None)
    d1 = tr._noise(st._replace(step=1), like, None)
    z = torch.cat([x.reshape(-1) for x in d0.values()])
    # mean 0 and std 0.01 over ~160k draws (5 sigma of the estimators)
    assert abs(float(z.mean())) < 5 * 0.01 / z.numel() ** 0.5
    assert abs(float(z.std()) / 0.01 - 1) < 5 / (2 * z.numel()) ** 0.5
    for k in d0:
        assert d0[k].shape == like[k].shape
        assert torch.equal(d0[k], d0b[k])          # reproducible per step
        assert not torch.equal(d0[k], d1[k])       # fresh each step
        # the learners draw apart
        assert not torch.equal(d0[k][0], d0[k][1])
    # noise_std scales one stream: the same unit draws
    tr2 = _star_trainer(0.02)
    tr2.init(7, fcnet.init_params(torch.Generator().manual_seed(0)))
    d2 = tr2._noise(st, like, None)
    for k in d0:
        torch.testing.assert_close(d2[k], 2 * d0[k], rtol=1e-6, atol=0)
    # its own stream: never the matchings' seed at the same (seed, step)
    for seed in range(3):
        for step in range(5):
            assert (trainer_mod._noise_seed(seed, step)
                    != trainer_mod._step_seed(seed, step))
    # the matchings' generator is not touched by an SSGD* step
    gen_state = tr._gen.get_state()
    loader = ShardedLoader(TemplateImages(), n_learners=4, local_batch=16,
                           seed=0, device="cpu")
    tr.train_step(st, loader.batch(0))
    assert torch.equal(tr._gen.get_state(), gen_state)


def test_ssgd_star_with_zero_noise_is_ssgd():
    loader = ShardedLoader(TemplateImages(), n_learners=4, local_batch=16,
                           seed=0, device="cpu")
    out = {}
    for algo in ("ssgd", "ssgd_star"):
        tr = MultiLearnerTrainer(fcnet.loss_fn, optim.sgd(0.1, momentum=0.9),
                                 AlgoConfig(algo=algo, n_learners=4,
                                            noise_std=0.0), device="cpu")
        st = tr.init(0, fcnet.init_params(torch.Generator().manual_seed(0)))
        for i in range(3):
            st, m = tr.train_step(st, loader.batch(i))
        out[algo] = (st.params, float(m.loss))
    for k in out["ssgd"][0]:
        assert torch.equal(out["ssgd"][0][k], out["ssgd_star"][0][k])
    assert out["ssgd"][1] == out["ssgd_star"][1]
