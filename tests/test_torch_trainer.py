"""The port's MultiLearnerTrainer against the JAX reference, step by step.

Both trainers start from the reference's parameters and see the
reference's batches and gossip tables (passed to the port as numpy, the
tables through ``train_step(..., rounds=...)``), so every step's
parameters, momentum and ``StepMetrics`` must agree:

  * ``ssgd`` (reference ``engine="flat"``), ``dpsgd`` on every scheduled
    topology (fused), the unfused fallbacks (``descend_then_mix``,
    nesterov), and ``adpsgd`` with a straggler, on the paper's FC net;
  * ``dpsgd`` on ``transformer-100m``'s smoke config, two steps of the
    ``examples/train_100m.py`` recipe;
  * the quickstart twin on the reference's batches and matchings.

Tolerances: the two frameworks run the same float32 algebra but sum the
matrix products in other orders (XLA's CPU dots against PyTorch's BLAS),
so gradients differ in the last bits and the differences grow with the
steps.  Parameters, momentum and the published buffer: 1e-5 absolute +
1e-4 relative after 3-4 FC-net steps (measured: at most 1.2e-7 absolute);
the transformer 1e-4 (measured: at most 8.2e-7 after 2 steps at lr 0.5);
metrics 1e-4 relative (measured: at most 1.1e-6); the quickstart losses
1e-3 relative over 10 steps at lr 0.5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro.data import SyntheticTokenStream as JaxTokens  # noqa: E402
from repro.data import TemplateImages as JaxImages  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.models import build_model, fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402

PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_RTOL = 1e-4
FIELDS = ("loss", "grad_norm", "sigma_w_sq", "staleness_mean",
          "staleness_max", "n_active", "grad_sq_mean")
FC_PARAMS = jax_fcnet.init_params(jax.random.PRNGKey(0), in_dim=784,
                                  hidden=50)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several files at once; two threads run these small
    ops as fast as eight and leave the cores to the other workers, some
    of whose benchmarks compare wall-clock rates."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _ref_rounds(tr, state):
    """The tables the reference's flat engine uses at ``state.step``."""
    if tr._schedule is None:
        return None
    key = jax.random.fold_in(state.rng, state.step)
    k_mix, _ = jax.random.split(key)
    return [(np.array(p), np.array(c))
            for p, c in tr._schedule.step_rounds(k_mix, int(state.step))]


def _mu(opt_state):
    """The momentum buffer inside a (possibly wrapped) optimizer state."""
    while isinstance(opt_state, dict) and "mu" not in opt_state:
        opt_state = opt_state.get("inner")
    return None if not opt_state else opt_state["mu"]


def _compare(jstate, jm, pstate, pm, tol=PARAM_TOL, what=""):
    np.testing.assert_allclose(pstate.params.numpy(),
                               np.asarray(jstate.params), **tol,
                               err_msg=f"{what} params")
    jmu, pmu = _mu(jstate.opt_state), _mu(pstate.opt_state)
    assert (jmu is None) == (pmu is None)
    if jmu is not None:
        np.testing.assert_allclose(pmu.numpy(), np.asarray(jmu), **tol,
                                   err_msg=f"{what} momentum")
    if jstate.buffer is not None:
        np.testing.assert_allclose(pstate.buffer.numpy(),
                                   np.asarray(jstate.buffer), **tol,
                                   err_msg=f"{what} buffer")
        np.testing.assert_array_equal(pstate.age.numpy(),
                                      np.asarray(jstate.age))
        np.testing.assert_array_equal(pstate.clock.numpy(),
                                      np.asarray(jstate.clock))
    for f in FIELDS:
        np.testing.assert_allclose(float(getattr(pm, f)),
                                   float(getattr(jm, f)), rtol=METRIC_RTOL,
                                   atol=1e-12, err_msg=f"{what} {f}")


def _parity(algo, topology, steps, *, n=8, jopt=None, popt=None,
            batch=32, engine="auto", **algo_kw):
    jopt = jopt or jax_optim.sgd(0.1, momentum=0.9)
    popt = popt or optim.sgd(0.1, momentum=0.9)
    loader = JaxLoader(JaxImages(), n_learners=n, local_batch=batch, seed=0)
    jtr = JaxTrainer(jax_fcnet.loss_fn, jopt,
                     JaxAlgoConfig(algo=algo, topology=topology,
                                   n_learners=n, **algo_kw),
                     engine="flat", kernel_backend="ref")
    ptr = MultiLearnerTrainer(fcnet.loss_fn, popt,
                              AlgoConfig(algo=algo, topology=topology,
                                         n_learners=n, **algo_kw),
                              engine=engine, device="cpu")
    jstate = jtr.init(jax.random.PRNGKey(0), FC_PARAMS)
    pstate = ptr.init(0, tree_from_jax(_np(FC_PARAMS)))
    assert ptr._fused is None or jtr._fused is not None
    for step in range(steps):
        b = loader.batch(step)
        rounds = _ref_rounds(jtr, jstate)
        pstate, pm = ptr.train_step(pstate, _torch_batch(b), rounds)
        jstate, jm = jtr.train_step(jstate, b)
        _compare(jstate, jm, pstate, pm, what=f"{algo}/{topology} {step}")
    return ptr


@pytest.mark.parametrize("topology", ["random_pair", "ring", "torus", "full",
                                      "hierarchical", "exp", "one_peer_exp",
                                      "random_matching", "solo"])
def test_dpsgd_matches_reference_on_every_topology(topology):
    kw = dict(gossip_rounds=2) if topology == "random_matching" else {}
    tr = _parity("dpsgd", topology, 3, **kw)
    assert (tr._fused is not None) == (topology != "solo")


def test_ssgd_matches_reference_flat_engine():
    _parity("ssgd", "random_pair", 3, engine="flat")


@pytest.mark.parametrize("topology", ["hierarchical", "full",
                                      "random_matching"])
def test_multi_round_weight_decay_matches_reference(topology):
    kw = dict(gossip_rounds=2) if topology == "random_matching" else {}
    _parity("dpsgd", topology, 3,
            jopt=jax_optim.sgd(0.1, momentum=0.9, weight_decay=0.01),
            popt=optim.sgd(0.1, momentum=0.9, weight_decay=0.01), **kw)


@pytest.mark.parametrize("case", ["descend_then_mix", "nesterov",
                                  "descend_then_mix_ring"])
def test_unfused_fallback_matches_reference(case):
    if case == "nesterov":
        tr = _parity("dpsgd", "random_pair", 3,
                     jopt=jax_optim.sgd(0.1, momentum=0.9, nesterov=True),
                     popt=optim.sgd(0.1, momentum=0.9, nesterov=True))
    else:
        topo = "ring" if case.endswith("ring") else "random_pair"
        tr = _parity("dpsgd", topo, 3, gossip_order="descend_then_mix")
    assert tr._fused is None


@pytest.mark.parametrize("kw", [
    dict(max_staleness=4, slow_learner=0, slow_factor=3),
    dict(max_staleness=1, slow_learner=2, slow_factor=2),
    dict(max_staleness=0)], ids=["tau4-slow3", "tau1-slow2", "sync"])
def test_adpsgd_matches_reference_with_a_straggler(kw):
    tr = _parity("adpsgd", "random_pair", 4, n=6, **kw)
    assert tr._fused is not None


def test_adpsgd_unfused_matches_reference():
    _parity("adpsgd", "random_pair", 4, n=6,
            jopt=jax_optim.sgd(0.1, momentum=0.9, nesterov=True),
            popt=optim.sgd(0.1, momentum=0.9, nesterov=True),
            max_staleness=2, slow_learner=1, slow_factor=2)


def test_schedule_wrapped_optimizer_matches_reference():
    sched_j = jax_optim.warmup_linear_scale(2, 3.0)
    sched_p = optim.warmup_linear_scale(2, 3.0)
    _parity("dpsgd", "ring", 3,
            jopt=jax_optim.scale_by_schedule(
                jax_optim.sgd(0.05, momentum=0.9), sched_j),
            popt=optim.scale_by_schedule(optim.sgd(0.05, momentum=0.9),
                                         sched_p))


def test_transformer_smoke_dpsgd_two_steps_match_reference():
    n, b, seq = 4, 2, 64
    jcfg = jax_get_config("transformer-100m").smoke_config()
    cfg = get_config("transformer-100m").smoke_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi, api = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jparams = japi.init(jax.random.PRNGKey(0))
    loader = JaxLoader(JaxTokens(vocab=jcfg.vocab), n_learners=n,
                       local_batch=b, extra_args=(seq,))
    jopt = jax_optim.scale_by_schedule(jax_optim.sgd(0.5, momentum=0.9),
                                       jax_optim.warmup_linear_scale(10, 1.0))
    popt = optim.scale_by_schedule(optim.sgd(0.5, momentum=0.9),
                                   optim.warmup_linear_scale(10, 1.0))
    jtr = JaxTrainer(japi.loss_fn, jopt,
                     JaxAlgoConfig(algo="dpsgd", topology="random_pair",
                                   n_learners=n), kernel_backend="ref")
    ptr = MultiLearnerTrainer(api.loss_fn, popt,
                              AlgoConfig(algo="dpsgd",
                                         topology="random_pair",
                                         n_learners=n),
                              params_from_tree=api.params_from_tree,
                              device="cpu")
    jstate = jtr.init(jax.random.PRNGKey(0), jparams)
    pstate = ptr.init(0, tree_from_jax(_np(jparams)))
    for step in range(2):
        batch = loader.batch(step)
        rounds = _ref_rounds(jtr, jstate)
        pstate, pm = ptr.train_step(pstate, _torch_batch(batch), rounds)
        jstate, jm = jtr.train_step(jstate, batch)
        _compare(jstate, jm, pstate, pm, tol=dict(atol=1e-4, rtol=1e-4),
                 what=f"transformer step {step}")
    assert np.isfinite(float(pm.loss))
    # the step counter of the schedule wrapper advanced on every learner
    np.testing.assert_array_equal(pstate.opt_state["step"].numpy(), [2] * n)
    # the trained store read back through the model's own parameter object
    view = ptr.params_tree(pstate)
    np.testing.assert_allclose(
        view["periods"]["l0"]["mixer"]["wq"][1].numpy(),
        np.asarray(jtr.params_tree(jstate)["periods"]["l0"]["mixer"]["wq"]
                   [1]), atol=1e-4, rtol=1e-4)


def _jax_quickstart(algo, steps, loader):
    """examples/quickstart.py's loop, returning every step's loss."""
    key = jax.random.PRNGKey(0)
    tr = JaxTrainer(jax_fcnet.loss_fn, jax_optim.sgd(quickstart.LR),
                    JaxAlgoConfig(algo=algo, topology="random_pair",
                                  n_learners=quickstart.N_LEARNERS))
    state = tr.init(key, jax_fcnet.init_params(key, in_dim=784, hidden=50))
    losses = []
    for step in range(steps):
        state, m = tr.train_step(state, loader.batch(step))
        losses.append(float(m.loss))
    return tr, losses


def test_quickstart_twin_matches_reference_and_reproduces_fig2a():
    steps, first = quickstart.STEPS, 10
    loader = JaxLoader(JaxImages(), n_learners=quickstart.N_LEARNERS,
                       local_batch=quickstart.LOCAL_BATCH, seed=0)
    key = jax.random.PRNGKey(0)
    init = tree_from_jax(_np(jax_fcnet.init_params(key, in_dim=784,
                                                   hidden=50)))
    jtr, _ = _jax_quickstart("dpsgd", 0, loader)

    def rounds_fn(step):
        k_mix, _ = jax.random.split(jax.random.fold_in(key, step))
        return [(np.array(p), np.array(c))
                for p, c in jtr._schedule.step_rounds(k_mix, step)]

    out = {}
    for algo in ("ssgd", "dpsgd"):
        out[algo] = quickstart.train(
            algo, steps=steps, device="cpu", log_every=0,
            init_params={k: v.clone() for k, v in init.items()},
            batch_fn=lambda s: _torch_batch(loader.batch(s)),
            rounds_fn=rounds_fn if algo == "dpsgd" else None)
        _, ref = _jax_quickstart(algo, first, loader)
        np.testing.assert_allclose(out[algo][:first], ref, rtol=1e-3,
                                   err_msg=algo)
    # the paper's Fig. 2a at lr 0.5, nB = 2000, as the reference finds it
    # (examples/quickstart.py: SSGD 1.98, DPSGD 0.0007 at step 120)
    assert out["dpsgd"][-1] < 0.05 < 1.0 < out["ssgd"][-1]
    assert np.isfinite(out["ssgd"]).all() and np.isfinite(out["dpsgd"]).all()


@pytest.mark.parametrize("name", ["constant", "warmup", "decay", "goyal"])
def test_lr_schedules_match_reference(name):
    """Each schedule on a stacked (n,) step counter equals the reference's
    on each scalar step, within 1e-7 relative (float32 on both sides; the
    power in the annealing factor may round differently)."""
    make = {
        "constant": lambda o: o.constant_schedule(0.3),
        "warmup": lambda o: o.linear_warmup(5, peak=2.0, base=0.1),
        "decay": lambda o: o.step_decay([3, 7], [0.1, 0.01, 0.001]),
        "goyal": lambda o: o.warmup_linear_scale(4, 8.0, (6, 9), 0.1),
    }[name]
    port, ref = make(optim), make(jax_optim)
    steps = np.arange(12, dtype=np.int32)
    got = port(torch.tensor(steps)).numpy()
    want = np.array([float(ref(jax.numpy.int32(s))) for s in steps],
                    np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_controller_scale_write_matches_reference():
    """A controller write between steps reaches the fused update through
    the coefficient table, as in the reference."""
    n = 4
    loader = JaxLoader(JaxImages(), n_learners=n, local_batch=32, seed=0)
    jtr = JaxTrainer(jax_fcnet.loss_fn, jax_optim.scale_by_controller(
        jax_optim.sgd(0.1, momentum=0.9)),
        JaxAlgoConfig(algo="dpsgd", topology="ring", n_learners=n),
        kernel_backend="ref")
    ptr = MultiLearnerTrainer(fcnet.loss_fn, optim.scale_by_controller(
        optim.sgd(0.1, momentum=0.9)),
        AlgoConfig(algo="dpsgd", topology="ring", n_learners=n),
        device="cpu")
    jstate = jtr.init(jax.random.PRNGKey(0), FC_PARAMS)
    pstate = ptr.init(0, tree_from_jax(_np(FC_PARAMS)))
    for step, scale in enumerate([1.0, 0.25, 3.0]):
        jstate = jstate._replace(opt_state=jax_optim.set_controller_scale(
            jstate.opt_state, scale))
        pstate = pstate._replace(opt_state=optim.set_controller_scale(
            pstate.opt_state, scale))
        np.testing.assert_array_equal(
            optim.controller_scale(pstate.opt_state).numpy(), [scale] * n)
        b = loader.batch(step)
        pstate, pm = ptr.train_step(pstate, _torch_batch(b))
        jstate, jm = jtr.train_step(jstate, b)
        _compare(jstate, jm, pstate, pm, what=f"controller step {step}")


def test_run_steps_equals_sequential_steps():
    n, k = 4, 3
    loader = JaxLoader(JaxImages(), n_learners=n, local_batch=16, seed=0)
    batches = [_torch_batch(loader.batch(i)) for i in range(k)]

    def trainer():
        tr = MultiLearnerTrainer(
            fcnet.loss_fn, optim.sgd(0.1, momentum=0.9),
            AlgoConfig(algo="dpsgd", topology="random_pair", n_learners=n),
            device="cpu")
        return tr, tr.init(3, tree_from_jax(_np(FC_PARAMS)))

    tr, st = trainer()
    losses = []
    for b in batches:
        st, m = tr.train_step(st, b)
        losses.append(float(m.loss))
    seq = st.params.clone()
    tr2, st2 = trainer()
    stacked = {key: torch.stack([b[key] for b in batches]) for key in
               batches[0]}
    st2, ms = tr2.run_steps(st2, stacked, k=k)
    torch.testing.assert_close(st2.params, seq, rtol=0, atol=0)
    assert ms.loss.shape == (k,) and st2.step == k
    np.testing.assert_array_equal(ms.loss.numpy(),
                                  np.asarray(losses, np.float32))
    with pytest.raises(ValueError, match="k=2"):
        tr2.run_steps(st2, stacked, k=2)
