"""The port's adam, lamb, decentlam and AdaScale against the JAX reference.

  * ``update`` on the same stacked inputs: the reference vmaps its update
    over the learner axis, the port's runs on the stacked state; 4
    updates of each optimizer on a two-leaf tree of 3 learners, updates
    and state within 1e-6 absolute + 1e-5 relative (the same float32
    algebra; ``b ** t``, the square roots and lamb's norms may round
    differently);
  * ``AdaScale`` / ``AdaScaleAutoLR`` are host Python in both packages:
    the same gains and scales to 1e-12, composed with each package's own
    ``AutoLRController``;
  * trainer-level parity on the FC net, per step at
    ``tests/test_torch_trainer.py``'s tiers (parameters and optimizer
    state 1e-5 absolute + 1e-4 relative, metrics 1e-4 relative): adam on
    the flat engine (unfused), lamb on the pytree engine, decentlam on the
    flat engine (unfused) with the exact drift on a static ring and with
    drift_scale = 1 - momentum on random matchings;
  * the ``static_mixing_only`` guard raises where the reference's does.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro.data import TemplateImages as JaxImages  # noqa: E402
from repro.landscape import AutoLRController as JaxAutoLR  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.landscape import AutoLRController  # noqa: E402
from repro_torch.models import fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402

UPDATE_TOL = dict(atol=1e-6, rtol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_RTOL = 1e-4
FIELDS = ("loss", "grad_norm", "sigma_w_sq", "grad_sq_mean")
FC_PARAMS = jax_fcnet.init_params(jax.random.PRNGKey(0), in_dim=784,
                                  hidden=50)
OPTS = {
    "adam": lambda o: o.adam(1e-2),
    "adamw": lambda o: o.adam(1e-2, weight_decay=0.1),
    "lamb": lambda o: o.lamb(1e-2),
    "decentlam": lambda o: o.decentlam(0.1, momentum=0.9),
    "decentlam_wd": lambda o: o.decentlam(0.1, momentum=0.9,
                                          weight_decay=0.01,
                                          drift_scale=0.1),
}


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


def _close(got, want, tol, what):
    """Every leaf of a port tree (tensors) against a reference tree."""
    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: x.numpy(), got,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    w = jax.tree_util.tree_leaves(_np(want))
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **tol, err_msg=what)


@pytest.mark.parametrize("name", list(OPTS))
def test_update_matches_reference(name):
    rng = np.random.default_rng(0)
    n = 3

    def tree():
        return {"a": rng.standard_normal((n, 5, 4)).astype(np.float32),
                "b": rng.standard_normal((n, 7)).astype(np.float32)}
    params = tree()
    params["b"][1] = 0.0          # lamb: a zero-norm leaf takes trust 1
    jopt, popt = OPTS[name](jax_optim), OPTS[name](optim)
    assert popt.wants_mixed == jopt.wants_mixed
    assert popt.layout_sensitive == jopt.layout_sensitive
    assert popt.static_mixing_only == jopt.static_mixing_only
    jstate = jax.vmap(jopt.init)(params)
    pstate = popt.init(tree_from_jax(params))
    for step in range(4):
        grads, mixed = tree(), tree()
        extra = (mixed,) if jopt.wants_mixed else ()
        jupd, jstate = jax.vmap(jopt.update)(grads, jstate, params, *extra)
        pextra = tuple(tree_from_jax(x) for x in extra)
        pupd, pstate = popt.update(tree_from_jax(grads), pstate,
                                   tree_from_jax(params), *pextra)
        _close(pupd, jupd, UPDATE_TOL, f"{name} updates {step}")
        _close(pstate, jstate, UPDATE_TOL, f"{name} state {step}")
        params = jax.tree_util.tree_map(lambda p, u: p + np.asarray(u),
                                        params, jupd)


def _probe(lam, lib):
    return types.SimpleNamespace(sharpness=lib.float32(lam))


def test_adascale_and_autolr_composition_match_reference():
    rng = np.random.default_rng(1)
    port = optim.AdaScaleAutoLR(
        AutoLRController(alpha0=0.5, rho=1.8, max_scale=8.0, ema=0.5),
        optim.AdaScale(theta=0.7), max_gain=6.0)
    ref = jax_optim.AdaScaleAutoLR(
        JaxAutoLR(alpha0=0.5, rho=1.8, max_scale=8.0, ema=0.5),
        jax_optim.AdaScale(theta=0.7), max_gain=6.0)
    for i in range(40):
        if i % 8 == 0:
            lam = float(rng.uniform(0.5, 20.0))
            assert port.on_probe(_probe(lam, np)) == pytest.approx(
                ref.on_probe(_probe(lam, jnp)), rel=1e-12, abs=0)
        m = types.SimpleNamespace(
            grad_sq_mean=float(rng.uniform(0, 10)),
            grad_norm=float(rng.uniform(0, 3)),
            n_active=float(rng.integers(1, 9)))
        if i == 20:
            m.grad_sq_mean = float("nan")       # held, not poisoned
        assert port.on_metrics(m) == pytest.approx(ref.on_metrics(m),
                                                   rel=1e-12, abs=0)
        assert port.adascale.gain == pytest.approx(ref.adascale.gain,
                                                   rel=1e-12, abs=0)
    port.adascale.reset_smoothing()
    assert port.adascale.sigma_sq is None
    with pytest.raises(ValueError, match="theta"):
        optim.AdaScale(theta=1.0)


def _trainer_parity(jopt, popt, engine, steps=3, n=8, **algo_kw):
    loader = JaxLoader(JaxImages(), n_learners=n, local_batch=32, seed=0)
    cfg = dict(algo="dpsgd", n_learners=n, **algo_kw)
    jtr = JaxTrainer(jax_fcnet.loss_fn, jopt, JaxAlgoConfig(**cfg),
                     engine=engine, kernel_backend="ref")
    ptr = MultiLearnerTrainer(fcnet.loss_fn, popt, AlgoConfig(**cfg),
                              engine=engine, device="cpu")
    assert ptr.is_flat == (engine == "flat") and not ptr.is_fused
    jstate = jtr.init(jax.random.PRNGKey(0), FC_PARAMS)
    pstate = ptr.init(0, tree_from_jax(_np(FC_PARAMS)))
    for step in range(steps):
        b = loader.batch(step)
        key = jax.random.fold_in(jstate.rng, jstate.step)
        k_mix, _ = jax.random.split(key)
        rounds = [(np.array(p), np.array(c)) for p, c in
                  jtr._schedule.step_rounds(k_mix, int(jstate.step))]
        pstate, pm = ptr.train_step(pstate, _torch_batch(b), rounds)
        jstate, jm = jtr.train_step(jstate, b)
        what = f"{engine} step {step}"
        _close(pstate.params, jstate.params, PARAM_TOL, f"{what} params")
        _close(pstate.opt_state, jstate.opt_state, PARAM_TOL,
               f"{what} opt state")
        for f in FIELDS:
            np.testing.assert_allclose(float(getattr(pm, f)),
                                       float(getattr(jm, f)),
                                       rtol=METRIC_RTOL, atol=1e-12,
                                       err_msg=f"{what} {f}")
    return float(pm.loss)


def test_adam_on_flat_engine_matches_reference():
    _trainer_parity(jax_optim.adam(1e-3), optim.adam(1e-3), "flat")


def test_lamb_on_pytree_engine_matches_reference():
    tr = MultiLearnerTrainer(fcnet.loss_fn, optim.lamb(1e-2),
                             AlgoConfig(n_learners=4), device="cpu")
    assert not tr.is_flat                  # auto keeps lamb off the flat store
    _trainer_parity(jax_optim.lamb(1e-2), optim.lamb(1e-2), "pytree")


@pytest.mark.parametrize("drift,topology", [(1.0, "ring"),
                                            (0.1, "random_pair")])
def test_decentlam_on_flat_engine_matches_reference(drift, topology):
    loss = _trainer_parity(
        jax_optim.decentlam(0.1, momentum=0.9, drift_scale=drift),
        optim.decentlam(0.1, momentum=0.9, drift_scale=drift), "flat",
        topology=topology)
    assert np.isfinite(loss)


@pytest.mark.parametrize("topology", ["ring", "full", "exp", "random_pair",
                                      "one_peer_exp", "random_matching",
                                      "solo"])
@pytest.mark.parametrize("drift,unsafe", [(1.0, False), (0.1, False),
                                          (1.0, True)])
def test_static_mixing_only_guard_raises_where_reference_does(topology,
                                                              drift, unsafe):
    kw = dict(algo="dpsgd", topology=topology, n_learners=8,
              gossip_rounds=2 if topology == "random_matching" else 1)
    try:
        JaxTrainer(jax_fcnet.loss_fn,
                   jax_optim.decentlam(0.1, momentum=0.9, drift_scale=drift,
                                       unsafe_switching=unsafe),
                   JaxAlgoConfig(**kw))
        ref_raised = False
    except ValueError:
        ref_raised = True
    popt = optim.decentlam(0.1, momentum=0.9, drift_scale=drift,
                           unsafe_switching=unsafe)
    if ref_raised:
        with pytest.raises(ValueError, match="STATIC mixing"):
            MultiLearnerTrainer(fcnet.loss_fn, popt, AlgoConfig(**kw),
                                device="cpu")
    else:
        MultiLearnerTrainer(fcnet.loss_fn, popt, AlgoConfig(**kw),
                            device="cpu")
    # the exact drift on a switching schedule is the case that raises
    assert ref_raised == (drift == 1.0 and not unsafe and topology in (
        "random_pair", "one_peer_exp", "random_matching"))


def test_decentlam_refuses_descend_then_mix_and_bad_arguments():
    with pytest.raises(ValueError, match="mix_then_descend"):
        MultiLearnerTrainer(fcnet.loss_fn, optim.decentlam(0.1),
                            AlgoConfig(topology="ring", n_learners=4,
                                       gossip_order="descend_then_mix"),
                            device="cpu")
    with pytest.raises(ValueError, match="lr"):
        optim.decentlam(0.0)
    with pytest.raises(ValueError, match="drift_scale"):
        optim.decentlam(0.1, drift_scale=1.5)
