"""The port's paper instruments against the JAX reference: diagnostics
(alpha_e, sigma_w^2, the Delta split of App. B) and Theorem-1 smoothing.

``compute_diagnostics`` and the trainer's ``diagnostics`` get the same
stacked FC-net parameters (the reference's init plus seeded per-learner
noise, passed as numpy) and the reference's batch.  Tolerance: relative
1e-5 on every field (measured at most 3.4e-7, on ``delta_2``: the
squared norm of g_a - g0, a difference of nearly equal gradient means,
where the frameworks' float32 summation orders show most).  The
analytic properties of tests/test_diagnostics.py and
tests/test_smoothing.py are then checked on the port's own functions.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.core.diagnostics import \
    compute_diagnostics as jax_diagnostics  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro.data import TemplateImages as JaxImages  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro_torch.core import (AlgoConfig, DiagStats,  # noqa: E402
                              MultiLearnerTrainer, compute_diagnostics,
                              estimate_smoothness, smoothed_loss)
from repro_torch.landscape import hvp  # noqa: E402
from repro_torch.models import fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

RTOL = 1e-5


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


def _compare(got, want):
    for field in DiagStats._fields:
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL,
                                   atol=1e-12, err_msg=field)


def _stacked_fc(n=4, b=32, spread=0.05):
    params = jax_fcnet.init_params(jax.random.PRNGKey(0), in_dim=784,
                                   hidden=50)
    rng = np.random.default_rng(2)
    stacked = jax.tree_util.tree_map(
        lambda x: jnp.stack([x + spread * rng.standard_normal(
            x.shape).astype(np.float32) for _ in range(n)]), params)
    batch = JaxLoader(JaxImages(), n_learners=n, local_batch=b,
                      seed=1).batch(5)
    return stacked, batch


@pytest.mark.parametrize("alpha,age", [(0.5, None), (0.1, [0, 2, 1, 3])],
                         ids=["sync", "with_age"])
def test_compute_diagnostics_matches_reference(alpha, age):
    stacked, batch = _stacked_fc()
    jage = None if age is None else jnp.asarray(age, jnp.int32)
    want = jax_diagnostics(jax_fcnet.loss_fn, stacked, batch, alpha,
                           age=jage)
    got = compute_diagnostics(
        fcnet.loss_fn, tree_from_jax(_np(stacked)), _torch_batch(batch),
        alpha, age=None if age is None else torch.tensor(age,
                                                         dtype=torch.int32))
    _compare(got, want)


def test_trainer_diagnostics_match_reference():
    """Both trainers after the same two DPSGD steps (the reference's
    matchings injected into the port), then ``diagnostics`` on each."""
    n = 4
    params = jax_fcnet.init_params(jax.random.PRNGKey(0), in_dim=784,
                                   hidden=50)
    loader = JaxLoader(JaxImages(), n_learners=n, local_batch=32, seed=0)
    jtr = JaxTrainer(jax_fcnet.loss_fn, jax_optim.sgd(0.3),
                     JaxAlgoConfig(algo="dpsgd", topology="ring",
                                   n_learners=n),
                     alpha_for_diag=0.3, engine="flat", kernel_backend="ref")
    ptr = MultiLearnerTrainer(fcnet.loss_fn, sgd(0.3),
                              AlgoConfig(algo="dpsgd", topology="ring",
                                         n_learners=n),
                              alpha_for_diag=0.3, device="cpu")
    jst = jtr.init(jax.random.PRNGKey(0), params)
    pst = ptr.init(0, tree_from_jax(_np(params)))
    for step in range(2):
        b = loader.batch(step)
        jst, _ = jtr.train_step(jst, b)
        pst, _ = ptr.train_step(pst, _torch_batch(b))
    probe = loader.batch(100)
    want = jtr.diagnostics(jst, probe)
    got = ptr.diagnostics(pst, _torch_batch(probe))
    _compare(got, want)
    # a probe hook receives the state's tree view: the same numbers
    _compare(ptr.diagnostics(ptr.state_view(pst), _torch_batch(probe)), want)


# ---------------------------------------------------------------------------
# the analytic properties (tests/test_diagnostics.py)
# ---------------------------------------------------------------------------

def quad_loss(params, batch):
    # L(w) = 0.5 ||w - mu_batch||^2 ; grad = w - mu
    return 0.5 * torch.sum((params["w"] - torch.mean(batch["x"], 0)) ** 2)


def test_alpha_e_equals_alpha_for_identical_weights():
    n, d = 4, 16
    w = torch.tensor(np.random.default_rng(0).standard_normal(d),
                     dtype=torch.float32)
    stats = compute_diagnostics(quad_loss, {"w": w.expand(n, d).clone()},
                                {"x": torch.zeros((n, 8, d))}, alpha=0.3)
    np.testing.assert_allclose(float(stats.alpha_e), 0.3, rtol=1e-5)
    assert float(stats.delta_2) < 1e-10
    assert float(stats.sigma_w_sq) < 1e-12


def test_delta2_vanishes_for_a_quadratic_and_not_for_a_quartic():
    n, d = 4, 16
    ws = torch.tensor(np.random.default_rng(2).standard_normal((n, d)),
                      dtype=torch.float32)
    x = {"x": torch.zeros((n, 4, d))}
    assert float(compute_diagnostics(quad_loss, {"w": ws}, x,
                                     alpha=1.0).delta_2) < 1e-10

    def quartic(params, batch):
        return 0.25 * torch.sum(params["w"] ** 4) + 0.0 * torch.sum(
            batch["x"])
    assert float(compute_diagnostics(quartic, {"w": ws}, x,
                                     alpha=1.0).delta_2) > 1e-4


def test_delta_s_and_sigma_w_analytic_on_quadratic():
    """Delta_S = alpha^2 sum_j ||mu_bar - mu_j||^2 / (n (n-1)) (App. B,
    unbiased) and sigma_w^2 = sum of per-coordinate variances."""
    n, d, alpha = 4, 16, 0.3
    rng = np.random.default_rng(3)
    ws = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((n, 8, d)), dtype=torch.float32)
    stats = compute_diagnostics(quad_loss, {"w": ws}, {"x": x}, alpha=alpha)
    mus = torch.mean(x, dim=1)
    dev = mus - torch.mean(mus, dim=0, keepdim=True)
    np.testing.assert_allclose(
        float(stats.delta_s),
        alpha ** 2 * float(torch.sum(dev ** 2)) / (n * (n - 1)), rtol=1e-5)
    np.testing.assert_allclose(
        float(stats.sigma_w_sq),
        float(torch.sum(torch.var(ws, dim=0, correction=0))), rtol=1e-5)
    for f in stats:
        assert f.dim() == 0 and bool(torch.isfinite(f))


# ---------------------------------------------------------------------------
# Theorem-1 smoothing (tests/test_smoothing.py)
# ---------------------------------------------------------------------------

def rough_loss(params, batch):
    return torch.sum(torch.abs(params["w"])) + 0.0 * torch.sum(batch["x"])


def test_smoothed_landscape_is_smoother():
    params = {"w": torch.full((32,), 0.01)}
    batch = {"x": torch.zeros((1,))}
    ls_raw = estimate_smoothness(rough_loss, params, batch,
                                 torch.Generator().manual_seed(0),
                                 sigma=0.0, n_pairs=6, probe_radius=0.02)
    ls_smooth = estimate_smoothness(rough_loss, params, batch,
                                    torch.Generator().manual_seed(0),
                                    sigma=0.3, n_pairs=6, probe_radius=0.02,
                                    n_mc=32)
    assert float(ls_smooth) < float(ls_raw)


def test_smoothness_pins_quadratic_lipschitz_and_hvp():
    lam = 3.7
    params = {"w": torch.ones((24,))}
    batch = {"x": torch.zeros((1,))}

    def quad(p, b):
        return 0.5 * lam * torch.sum(p["w"] ** 2) + 0.0 * torch.sum(b["x"])

    ls = estimate_smoothness(quad, params, batch,
                             torch.Generator().manual_seed(2), sigma=0.0,
                             n_pairs=8, probe_radius=0.1)
    np.testing.assert_allclose(float(ls), lam, rtol=1e-4)
    v = {"w": torch.linspace(-1.0, 1.0, 24)}
    hv = hvp(lambda p: quad(p, batch), params, v)
    np.testing.assert_allclose(hv["w"].numpy(), lam * v["w"].numpy(),
                               rtol=1e-5)


def test_smoothed_loss_above_min_for_convex():
    params = {"w": torch.zeros((16,))}
    batch = {"x": torch.zeros((1,))}
    l0 = rough_loss(params, batch)
    l1 = smoothed_loss(rough_loss, params, batch,
                       torch.Generator().manual_seed(1), sigma=0.1,
                       n_samples=64)
    assert float(l1) > float(l0)
