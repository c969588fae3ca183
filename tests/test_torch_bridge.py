"""The port's consensus bridge (``repro_torch.serve.bridge``) and the
masked learner statistics it reads, against the reference, on the CPU.

  * ``masked_learner_mean`` / ``masked_learner_var`` equal
    ``repro.core.util``'s on the same stacked trees (1e-6 relative; a
    poisoned inactive row — 1e30, inf or NaN — never reaches the result);
  * the bridge on a live DPSGD trainer (transformer-100m's smoke config,
    ring, 4 learners), mirroring tests/test_serve.py's bridge test: both
    packages train the same weights on the same batches, and the
    snapshot, the served tokens, the staleness and the served divergence
    agree (float32 1e-4: two training steps apart, as
    tests/test_torch_trainer.py holds the transformer's steps);
  * a state whose ``members.active`` marks a learner dead (set by hand;
    tests/test_torch_membership.py drives it through ``set_membership``)
    averages only the live rows, mirroring tests/test_membership.py's
    ``test_bridge_snapshot_excludes_dead_rows``.
"""
import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.core import util as jutil  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.model import make_synthetic_batch  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.serve import ConsensusBridge as JaxBridge  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import served_divergence as jax_divergence  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.core import util  # noqa: E402
from repro_torch.models import build_model, fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.serve import (ConsensusBridge, ServeEngine,  # noqa: E402
                               served_divergence)
from repro_torch.tree import tree_leaves  # noqa: E402

PAGE, MAX_PAGES = 4, 4
BUF = PAGE * MAX_PAGES
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- masked statistics ----------------------------------------------------------

@pytest.mark.parametrize("poison", [1e30, np.inf, np.nan])
def test_masked_statistics_match_reference(poison):
    rng = np.random.default_rng(0)
    n = 5
    stacked = {"a": rng.standard_normal((n, 3, 4)).astype(np.float32),
               "b": {"c": rng.standard_normal((n, 7)).astype(np.float32)}}
    active = np.array([True, True, False, True, True])
    for leaf in (stacked["a"], stacked["b"]["c"]):
        leaf[2] = poison
    jmean = _np(jutil.masked_learner_mean(stacked, active))
    jvar = float(jutil.masked_learner_var(stacked, active))
    t = tree_from_jax(stacked)
    mean = util.masked_learner_mean(t, torch.tensor(active))
    var = float(util.masked_learner_var(t, torch.tensor(active)))
    for got, want in zip(tree_leaves(mean), jax.tree_util.tree_leaves(jmean)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(var)
    np.testing.assert_allclose(var, jvar, rtol=1e-6)
    # with every learner active, the plain statistics
    clean = {"a": torch.randn((n, 3, 4)), "b": torch.randn((n, 7))}
    full = torch.ones(n, dtype=torch.bool)
    np.testing.assert_allclose(float(util.masked_learner_var(clean, full)),
                               float(util.learner_var(clean)), rtol=1e-6)
    for got, want in zip(tree_leaves(util.masked_learner_mean(clean, full)),
                         tree_leaves(util.learner_mean(clean))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_masked_mean_keeps_a_bf16_leaf_dtype():
    x = torch.randn((4, 6)).to(torch.bfloat16)
    act = torch.tensor([True, False, True, True])
    m = util.masked_learner_mean({"w": x}, act)["w"]
    assert m.dtype == torch.bfloat16
    want = x[act].float().mean(0).to(torch.bfloat16)
    assert torch.equal(m, want)
    assert util.masked_learner_mean({"w": x}, torch.zeros(4, dtype=bool))[
        "w"].abs().sum() == 0          # no live learner: 0 over max(0, 1)


# -- the bridge on a live trainer ------------------------------------------------

N = 4


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("transformer-100m").smoke_config()
    cfg = get_config("transformer-100m").smoke_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi, api = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jparams = japi.init(jax.random.PRNGKey(0))
    jtr = JaxTrainer(japi.loss_fn, jax_sgd(0.05),
                     JaxAlgoConfig(algo="dpsgd", topology="ring",
                                   n_learners=N),
                     engine="flat", kernel_backend="ref")
    tr = MultiLearnerTrainer(api.loss_fn, sgd(0.05),
                             AlgoConfig(algo="dpsgd", topology="ring",
                                        n_learners=N),
                             engine="flat", kernel_backend="ref",
                             params_from_tree=api.params_from_tree,
                             device="cpu")
    jst = jtr.init(jax.random.PRNGKey(0), jparams)
    st = tr.init(0, tree_from_jax(_np(jparams)))
    return japi, jtr, jst, api, tr, st


def _batch(cfg, i):
    b = make_synthetic_batch(cfg, jax.random.PRNGKey(i), N * 2, 16)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((N, 2) + x.shape[1:]), b)


def _torch_batch(b):
    return {k: torch.tensor(np.asarray(v)) for k, v in b.items()}


def test_bridge_snapshot_staleness_and_divergence_match_reference(pair):
    japi, jtr, jst, api, tr, st = pair
    for i in range(2):
        b = _batch(japi.cfg, i)
        jst, _ = jtr.train_step(jst, b)
        st, _ = tr.train_step(st, _torch_batch(b))
    jbridge, bridge = JaxBridge(jtr), ConsensusBridge(tr)
    jsnap, snap = jbridge.snapshot(jst), bridge.snapshot(st)
    assert snap.step == jsnap.step == 2 and snap.n_active == N
    np.testing.assert_allclose(snap.consensus_dist, jsnap.consensus_dist,
                               **TOL)
    for got, want in zip(tree_leaves(snap.params),
                         jax.tree_util.tree_leaves(jsnap.params)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the snapshot is the learner mean of the live store
    for got, want in zip(tree_leaves(snap.params), tree_leaves(
            util.learner_mean(tr.params_tree(st)))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)

    # serve from the snapshot while training keeps moving
    jeng = JaxServeEngine(japi, jsnap.params, n_slots=2, page_size=PAGE,
                          max_len=BUF)
    eng = ServeEngine(api, api.params_from_tree(snap.params), n_slots=2,
                      page_size=PAGE, max_len=BUF)
    jr, r = jeng.submit([5, 9, 3], 3), eng.submit([5, 9, 3], 3)
    for i in range(2, 5):
        b = _batch(japi.cfg, i)
        jst, _ = jtr.train_step(jst, b)
        st, _ = tr.train_step(st, _torch_batch(b))
        for e in (jeng, eng):
            if e.has_work:
                e.step()
    jeng.run()
    eng.run()
    assert r.done and list(r.generated) == list(jr.generated)

    stale, jstale = bridge.staleness(st, snap), jbridge.staleness(jst, jsnap)
    assert stale["steps_behind"] == jstale["steps_behind"] == 3
    for k in ("consensus_dist_snapshot", "consensus_dist_now"):
        np.testing.assert_allclose(stale[k], jstale[k], err_msg=k, **TOL)

    live, jlive = bridge.snapshot(st), jbridge.snapshot(jst)
    probe = np.array([[5, 9, 3, 1]])
    div = served_divergence(api, snap.params, live.params, probe)
    jdiv = jax_divergence(japi, jsnap.params, jlive.params, probe)
    assert 0.0 <= div["top1_agreement"] <= 1.0
    assert div["top1_agreement"] == jdiv["top1_agreement"]
    assert div["max_abs_logit_diff"] >= div["mean_abs_logit_diff"] >= 0
    for k in ("mean_abs_logit_diff", "max_abs_logit_diff"):
        np.testing.assert_allclose(div[k], jdiv[k], rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    # the params object itself is taken as well as a tree
    same = served_divergence(api, api.params_from_tree(live.params),
                             live.params, probe)
    assert same["top1_agreement"] == 1.0 and same["max_abs_logit_diff"] == 0
    eng.set_params(api.params_from_tree(live.params))   # hot swap


def test_bridge_snapshot_excludes_dead_rows():
    n = 5
    tr = MultiLearnerTrainer(fcnet.loss_fn, sgd(0.1),
                             AlgoConfig(algo="dpsgd", n_learners=n),
                             engine="flat", device="cpu")
    st = tr.init(0, fcnet.init_params(torch.Generator().manual_seed(5)))
    from repro_torch.data import ShardedLoader, TemplateImages
    loader = ShardedLoader(TemplateImages(), n_learners=n, local_batch=8,
                           device="cpu")
    for i in range(2):
        st, _ = tr.train_step(st, loader.batch(i))
    # poison the dead learner's row: a folded-in row would blow up the mean
    view = tr.state_view(st)
    poisoned = {k: v.clone() for k, v in view.params.items()}
    for v in poisoned.values():
        v[2] = 1e30
    st = tr.state_from_view(view._replace(params=poisoned))
    active = torch.tensor([True, True, False, True, True])
    st = st._replace(members=SimpleNamespace(active=active))

    bridge = ConsensusBridge(tr)
    snap = bridge.snapshot(st)
    assert snap.n_active == n - 1
    live = [0, 1, 3, 4]
    stacked = tr.params_tree(st)
    jmean = jutil.masked_learner_mean(
        {k: np.asarray(v) for k, v in stacked.items()}, active.numpy())
    for k, leaf in stacked.items():
        got = snap.params[k].numpy()
        want = leaf[live].float().mean(0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got, np.asarray(jmean[k]), rtol=1e-6,
                                   atol=1e-7)
        assert np.isfinite(got).all()
    stale = bridge.staleness(st, snap)
    assert np.isfinite(stale["consensus_dist_now"])
    assert stale["steps_behind"] == 0
    assert np.isfinite(snap.consensus_dist) and snap.consensus_dist > 0
    np.testing.assert_allclose(
        snap.consensus_dist ** 2,
        float(jutil.masked_learner_var(
            {k: np.asarray(v) for k, v in stacked.items()}, active.numpy())),
        rtol=1e-5)
