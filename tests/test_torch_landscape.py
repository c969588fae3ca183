"""The port's landscape probe engine and AutoLR against the JAX reference.

The same inputs reach both packages as numpy: the reference's parameters
(``jax.random`` inits), its batches, and its random vectors — the Lanczos
start vector and the Hutchinson Rademacher probes are drawn with
``jax.random`` exactly as the reference draws them and injected into the
port (``q0=``, ``probes=``).  Tolerances:

  * HVPs, FC net and transformer smoke config: relative 1e-4 in norm (the
    frameworks sum products in other orders; measured 2.3e-7 on the FC
    net);
  * Lanczos Ritz values with an injected q0: relative 1e-5 on the rotated
    quadratic of tests/test_landscape.py (exact HVPs) and on the FC net's
    top value;
  * ``hutchinson_trace`` / ``trace_hc`` / ``probe_landscape`` fields with
    injected draws: relative 1e-4 (measured at most 2.9e-7);
  * the predictor's algebra 1e-6.

Then the port's own behaviour: ``ProbeSchedule``, the controller's clamps,
and the headline scenario on the port's trainer — at alpha * lambda_max =
2.4 SSGD diverges while SSGD+AutoLR converges (tests/test_landscape.py's
assertions).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.util import tree_gaussian_like as jax_gauss  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro.data import SyntheticTokenStream as JaxTokens  # noqa: E402
from repro.data import TemplateImages as JaxImages  # noqa: E402
from repro import landscape as jl  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import landscape as pl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.models import build_model, fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.optim import scale_by_controller, set_controller_scale, \
    sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

HVP_RTOL = 1e-4
RITZ_RTOL = 1e-5
PROBE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops; two threads leave the cores to the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return tree_from_jax(_np(tree))


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x))
                           for x in jax.tree_util.tree_leaves(tree)])


def _flat_t(tree):
    return np.concatenate([x.detach().numpy().ravel()
                           for x in tree_leaves(tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# fixtures: the rotated quadratic, the FC net, the transformer smoke config
# ---------------------------------------------------------------------------

D = 16
LAM = np.concatenate([np.linspace(1.0, 10.0, D - 1), [25.0]])
_Q, _ = jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(7), (D, D)))
A = np.asarray(_Q @ jnp.diag(jnp.asarray(LAM, jnp.float32)) @ _Q.T)
A_T = torch.tensor(A)


def jax_quad(params, batch):
    w = params["w"]
    return 0.5 * w @ jnp.asarray(A) @ w + 0.0 * jnp.sum(batch["x"])


def quad(params, batch):
    w = params["w"]
    return 0.5 * w @ A_T @ w + 0.0 * torch.sum(batch["x"])


def _fc(n=2, b=16, seed=0):
    params = jax_fcnet.init_params(jax.random.PRNGKey(seed), in_dim=784,
                                   hidden=50)
    batch = JaxLoader(JaxImages(), n_learners=n, local_batch=b,
                      seed=seed).batch(3)
    return params, batch


def _stacked_fc(n=3, b=16):
    params, batch = _fc(n, b)
    rng = np.random.default_rng(1)
    stacked = jax.tree_util.tree_map(
        lambda x: jnp.stack([x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32) for _ in range(n)]), params)
    return stacked, batch


# ---------------------------------------------------------------------------
# HVPs
# ---------------------------------------------------------------------------

def test_fc_hvp_matches_reference():
    params, batch = _fc()
    v = jax_gauss(jax.random.PRNGKey(11), params, 1.0)
    want = jl.make_hvp_fn(jax_fcnet.loss_fn, params, batch)(v)
    got = pl.make_hvp_fn(fcnet.loss_fn, _torch(params),
                         _torch_batch(batch))(_torch(v))
    assert _rel(_flat_t(got), _flat(want)) < HVP_RTOL
    # hvp on the superbatch loss gives the same product
    loss = pl.superbatch_loss_fn(fcnet.loss_fn, _torch_batch(batch))
    again = pl.hvp(loss, _torch(params), _torch(v))
    assert _rel(_flat_t(again), _flat(want)) < HVP_RTOL


def test_transformer_smoke_hvp_matches_reference():
    n, b, seq = 2, 2, 32
    jcfg = jax_get_config("transformer-100m").smoke_config()
    japi = jax_build_model(jcfg)
    api = build_model(get_config("transformer-100m").smoke_config(),
                      device="cpu")
    jparams = japi.init(jax.random.PRNGKey(0))
    batch = JaxLoader(JaxTokens(vocab=jcfg.vocab), n_learners=n,
                      local_batch=b, extra_args=(seq,)).batch(0)
    v = jax_gauss(jax.random.PRNGKey(5), jparams, 1.0)
    want = jl.make_hvp_fn(japi.loss_fn, jparams, batch)(v)
    got = pl.make_hvp_fn(api.loss_fn, _torch(jparams), _torch_batch(batch),
                         params_from_tree=api.params_from_tree)(_torch(v))
    assert _rel(_flat_t(got), _flat(want)) < HVP_RTOL


# ---------------------------------------------------------------------------
# Lanczos, Hutchinson, Tr(HC), the probe bundle
# ---------------------------------------------------------------------------

def test_lanczos_ritz_values_match_reference_with_injected_q0():
    key = jax.random.PRNGKey(0)
    params = {"w": jnp.ones((D,))}
    batch = {"x": jnp.zeros((1, 2, 1))}
    want = jl.lanczos_pytree(jax_quad, params, batch, m=10, key=key,
                             reorth="ref")
    got = pl.lanczos_pytree(quad, _torch(params), _torch_batch(batch), m=10,
                            q0=_torch(jax_gauss(key, params, 1.0)))
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=RITZ_RTOL)
    assert abs(float(pl.sharpness(got)) - 25.0) / 25.0 < 0.05
    # the flat basis keeps the layout's pad rows zero
    assert got.basis.shape == (11, 8, 128)
    assert float(got.basis.reshape(11, -1)[:, D:].abs().max()) == 0.0

    fparams, fbatch = _fc()
    fwant = jl.lanczos_pytree(jax_fcnet.loss_fn, fparams, fbatch, m=6,
                              key=key, reorth="ref")
    fgot = pl.lanczos_pytree(fcnet.loss_fn, _torch(fparams),
                             _torch_batch(fbatch), m=6,
                             q0=_torch(jax_gauss(key, fparams, 1.0)))
    np.testing.assert_allclose(float(pl.sharpness(fgot)),
                               float(jl.sharpness(fwant)), rtol=RITZ_RTOL)


def _ref_draws(key, params, n_samples):
    """The reference probe's own start vector and Rademacher probes."""
    k_lanczos, k_hutch = jax.random.split(key)
    q0 = jax_gauss(k_lanczos, params, 1.0)
    probes = [jl.tree_rademacher_like(k, params)
              for k in jax.random.split(k_hutch, n_samples)]
    return q0, probes


def test_hutchinson_and_trace_hc_match_reference():
    stacked, batch = _stacked_fc()
    tb = _torch_batch(batch)
    key = jax.random.PRNGKey(2)
    w_a = jax.tree_util.tree_map(lambda x: jnp.mean(x, 0), stacked)
    want = jl.hutchinson_trace(jax_fcnet.loss_fn, w_a, batch, key,
                               n_samples=3)
    probes = [_torch(jl.tree_rademacher_like(k, w_a))
              for k in jax.random.split(key, 3)]
    got = pl.hutchinson_trace(fcnet.loss_fn, _torch(w_a), tb,
                              probes=probes)
    np.testing.assert_allclose(float(got), float(want), rtol=PROBE_RTOL)
    np.testing.assert_allclose(
        float(pl.trace_hc(fcnet.loss_fn, _torch(stacked), tb)),
        float(jl.trace_hc(jax_fcnet.loss_fn, stacked, batch)),
        rtol=PROBE_RTOL)


def test_probe_landscape_matches_reference_with_injected_draws():
    stacked, batch = _stacked_fc()
    key = jax.random.PRNGKey(4)
    want = jl.probe_landscape(jax_fcnet.loss_fn, stacked, batch, key,
                              alpha=0.5, lanczos_iters=6,
                              hutchinson_samples=3, reorth="ref")
    w_a = jax.tree_util.tree_map(lambda x: jnp.mean(x, 0), stacked)
    q0, probes = _ref_draws(key, w_a, 3)
    got = pl.probe_landscape(fcnet.loss_fn, _torch(stacked),
                             _torch_batch(batch), alpha=0.5,
                             lanczos_iters=6, hutchinson_samples=3,
                             q0=_torch(q0),
                             probes=[_torch(p) for p in probes])
    for field in pl.ProbeResult._fields:
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)),
                                   rtol=PROBE_RTOL, err_msg=field)


def test_probe_landscape_on_the_quadratic():
    """tests/test_landscape.py's bundle checks on the port's own draws."""
    n = 4
    rng = np.random.default_rng(3)
    ws = torch.tensor(rng.standard_normal((n, D)).astype(np.float32) * 0.2)
    batch = {"x": torch.zeros((n, 2, 1))}
    gen = torch.Generator().manual_seed(4)
    r = pl.probe_landscape(quad, {"w": ws}, batch, gen, alpha=0.05,
                           lanczos_iters=10, hutchinson_samples=32)
    assert abs(float(r.sharpness) - 25.0) / 25.0 < 0.05
    sig = float(torch.sum(torch.var(ws, dim=0, correction=0)))
    np.testing.assert_allclose(float(r.sigma_w_sq), sig, rtol=1e-5)
    want = 0.05 * (1.0 - 0.025 * float(r.trace_hc) / sig)
    np.testing.assert_allclose(float(r.alpha_e_pred), want, rtol=1e-5)
    same = {"w": ws[0].expand(n, D).clone()}
    r0 = pl.probe_landscape(quad, same, batch, gen, alpha=0.05)
    np.testing.assert_allclose(float(r0.alpha_e_pred), 0.05, rtol=1e-6)
    dev = ws - ws.mean(0, keepdim=True)
    exact = float(torch.mean(torch.einsum("nd,de,ne->n", dev, A_T, dev)))
    np.testing.assert_allclose(float(r.trace_hc), exact, rtol=1e-5)


# ---------------------------------------------------------------------------
# predictor, schedule, controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,thc,sig", [(0.1, 3.0, 0.5), (0.5, 0.2, 2.0),
                                           (0.1, 0.0, 0.0),
                                           (0.3, 1.0, 1e-14)])
def test_predictor_matches_reference(alpha, thc, sig):
    np.testing.assert_allclose(
        float(pl.predict_alpha_e(alpha, thc, sig)),
        float(jl.predict_alpha_e(alpha, thc, sig)), rtol=1e-6)
    np.testing.assert_allclose(
        float(pl.effective_curvature(thc, sig)),
        float(jl.effective_curvature(thc, sig)), rtol=1e-6)


def test_probe_schedule_due():
    s = pl.ProbeSchedule(every=10, start=20)
    assert [i for i in range(45) if s.due(i)] == [20, 30, 40]
    assert not any(pl.ProbeSchedule(every=0).due(i) for i in range(5))
    ref = jl.ProbeSchedule(every=7, start=3)
    port = pl.ProbeSchedule(every=7, start=3)
    assert [port.due(i) for i in range(50)] == [ref.due(i)
                                                for i in range(50)]


def _probe_with(sharp):
    z = torch.zeros(())
    return pl.ProbeResult(torch.tensor(sharp), z, z, z, z, z, z)


def test_autolr_controller_clamps_and_releases():
    ctl = pl.AutoLRController(alpha0=0.1, rho=1.8, min_scale=0.05, ema=0.0)
    assert ctl.update(_probe_with(180.0)) == pytest.approx(0.1)
    assert ctl.update(_probe_with(1e6)) == 0.05                 # min clamp
    assert ctl.update(_probe_with(1.0)) == 1.0                  # max clamp
    assert ctl.update(_probe_with(0.0)) == 1.0                  # flat
    # the same sequence through the reference's controller
    jctl = jl.AutoLRController(alpha0=0.3, ema=0.3, gns_weight=0.5)
    pctl = pl.AutoLRController(alpha0=0.3, ema=0.3, gns_weight=0.5)
    for s in (12.0, 30.0, float("nan"), 4.0, 0.5):
        z = jnp.zeros(())
        want = jctl.update(jl.ProbeResult(jnp.float32(s), z, z, z, z,
                                          jnp.float32(0.7), z))
        zt = torch.zeros(())
        got = pctl.update(pl.ProbeResult(torch.tensor(s), zt, zt, zt, zt,
                                         torch.tensor(0.7), zt))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("kw", [dict(rho=2.0), dict(rho=0.0),
                                dict(min_scale=0.0),
                                dict(min_scale=2.0, max_scale=1.0),
                                dict(ema=1.0)])
def test_autolr_controller_rejects_bad_settings(kw):
    with pytest.raises(ValueError):
        pl.AutoLRController(alpha0=0.1, **kw)


# ---------------------------------------------------------------------------
# the headline scenario on the port's trainer
# ---------------------------------------------------------------------------

ALPHA = 0.096          # alpha * lambda_max = 2.4 > 2: SSGD diverges
N_STEPS = 120


def _mean_loss(state, tr):
    w = torch.mean(tr.params_tree(state)["w"], dim=0)
    return float(0.5 * w @ A_T @ w)


def test_ssgd_autolr_beats_ssgd_on_the_trainer():
    n = 2
    batch = {"x": torch.zeros((n, 2, 1))}
    init = {"w": torch.ones((D,))}
    loss0 = float(0.5 * init["w"] @ A_T @ init["w"])

    tr = MultiLearnerTrainer(quad, sgd(ALPHA),
                             AlgoConfig(algo="ssgd", n_learners=n),
                             device="cpu")
    st = tr.init(0, init)
    for _ in range(60):
        st, _ = tr.train_step(st, batch)
    diverged = _mean_loss(st, tr)
    assert not np.isfinite(diverged) or diverged > 1e4 * loss0

    ctl = pl.AutoLRController(alpha0=ALPHA)
    tr2 = MultiLearnerTrainer(quad, scale_by_controller(sgd(ALPHA)),
                              AlgoConfig(algo="ssgd", n_learners=n),
                              device="cpu")
    probe_fn = pl.make_trainer_probe(quad, alpha=ALPHA, lanczos_iters=10,
                                     hutchinson_samples=4)

    def on_probe(state, r):
        return state._replace(opt_state=set_controller_scale(
            state.opt_state, ctl.update(r)))

    tr2.add_probe("landscape", pl.ProbeSchedule(every=10), probe_fn,
                  on_result=on_probe)
    st2 = tr2.init(0, init)
    for i in range(N_STEPS):
        if tr2.probes_due(i):
            st2, _ = tr2.run_probes(st2, batch, step=i)
        st2, _ = tr2.train_step(st2, batch)
    final = _mean_loss(st2, tr2)
    assert np.isfinite(final) and final < 1e-3 * loss0
    assert ctl.scale < 1.0
    assert 0.5 < ALPHA * ctl.sharpness_ema * ctl.scale < 2.0
