"""The port's fused gossip + momentum-SGD update against the JAX reference.

The same numpy inputs go through the port's plain version
(``repro_torch.kernels.ref.gossip_mix_update_flat_ref``), the reference's
jnp oracle and the reference's Pallas kernel in interpret mode, on the
grids of tests/test_kernels.py (``test_batched_gossip_kernel_sweep``,
``test_batched_kernel_publish_mode``,
``test_batched_kernel_solo_learner_keeps_self_mix``).  The plain version
equals the reference's jnp oracle bitwise; against interpret mode the
tolerance is 1e-6 absolute on O(1) values (measured: at most 3.6e-7, a few
float32 ulps — XLA compiles the interpreted kernel body on its own and may
contract a product and a sum into one FMA, where the port rounds every
operation).  The CUDA kernel must equal the plain version bitwise on the
card (``cuda`` marker, skipped here).

The single-learner kernel (``gossip_mix_update``, which
``ops.dpsgd_fused_update`` reaches) is held the same way on
``test_gossip_kernel_sweep``'s grid: its plain version bitwise against the
reference's oracle, within 1e-6 of interpret mode, and the tree-level
``dpsgd_fused_update`` within 1e-6 of the reference's (which runs the
kernel in interpret mode on the CPU).
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.gossip_mix import \
    gossip_mix_update_flat as jax_kernel  # noqa: E402
from repro_torch.core.schedule import make_schedule  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.gossip_mix import (  # noqa: E402
    gossip_mix_update, gossip_mix_update_flat)

ATOL = 1e-6
GRID = [(4, 16, 1), (5, 24, 1), (8, 32, 2), (6, 24, 4), (8, 16, 4)]
MODES = [(True, 0.0), (False, 0.0), (True, 0.01)]


def _operands(n, T, K, has_mu, seed=0, nan_inactive=True):
    """Random w/remote/g/mu + a K-neighbour table with a solo learner
    (K = 1) or shifted neighbours, per-learner lr scales and an inactive
    last learner whose rows hold NaN where the select must not look."""
    rng = np.random.default_rng(seed)
    w, remote, g, mu = (rng.standard_normal((n, T, 128), dtype=np.float32)
                        for _ in range(4))
    if K == 1:
        partner = np.roll(np.arange(n), 1)
        partner[0] = 0                                   # learner 0 solo
        partners = partner[None].astype(np.int32)
        self_c = np.where(partner == np.arange(n), 1.0, 0.5)
        mix = np.stack([self_c, 1.0 - self_c], axis=1)
    else:
        idx = np.arange(n)
        partners = np.stack([(idx + s) % n
                             for s in range(1, K + 1)]).astype(np.int32)
        mix = np.full((n, K + 1), 1.0 / (K + 1))
    scale = np.linspace(0.5, 1.5, n)[:, None]
    active = np.ones((n, 1))
    active[n - 1] = 0.0
    if nan_inactive:              # its gradient is never used: poison it
        g[n - 1, 0, :4] = np.nan
    coefs = np.concatenate([mix, scale, active], axis=1).astype(np.float32)
    return w, remote, g, (mu if has_mu else None), partners, coefs


def _port(w, remote, g, mu, partners, coefs, **kw):
    t = [None if a is None else torch.tensor(a)
         for a in (w, remote, g, mu, partners, coefs)]
    return ops.flat_gossip_update(*t, **kw)


def _jax(w, remote, g, mu, partners, coefs, *, pallas, **kw):
    args = [None if a is None else jnp.asarray(a)
            for a in (w, remote, g, mu, partners, coefs)]
    has_mu = mu is not None
    if pallas:
        out = jax_kernel(*args[:3], args[3] if has_mu else args[0],
                         *args[4:], has_momentum=has_mu, interpret=True, **kw)
    else:
        out = jax_ref.gossip_mix_update_flat_ref(
            *args[:3], args[3] if has_mu else args[0], *args[4:],
            has_momentum=has_mu, **kw)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("n,T,K", GRID)
@pytest.mark.parametrize("has_mu,wd", MODES)
def test_plain_version_matches_reference_and_interpret_mode(n, T, K, has_mu,
                                                            wd):
    ops_np = _operands(n, T, K, has_mu, seed=n * T + K)
    kw = dict(lr=0.1, beta=0.9, weight_decay=wd)
    w_new, mu_new = _port(*ops_np, **kw)
    for pallas in (False, True):
        want = _jax(*ops_np, pallas=pallas, **kw)
        atol = ATOL if pallas else 0.0
        np.testing.assert_allclose(w_new.numpy(), want[0], atol=atol,
                                   rtol=0)
        if has_mu:
            np.testing.assert_allclose(mu_new.numpy(), want[1], atol=atol,
                                       rtol=0)
    w, mu = ops_np[0], ops_np[3]
    # the inactive learner streams through bitwise, NaN gradient and all
    np.testing.assert_array_equal(w_new[n - 1].numpy(), w[n - 1])
    assert np.isfinite(w_new.numpy()).all()
    if has_mu:
        np.testing.assert_array_equal(mu_new[n - 1].numpy(), mu[n - 1])


@pytest.mark.parametrize("has_mu", [True, False])
def test_publish_mode_matches_reference(has_mu):
    """AD-PSGD publish mode: stale-remote select + published-buffer rewrite
    in the same pass, against the reference's kernel and oracle and the
    unfused composition."""
    n, T = 6, 24
    rng = np.random.default_rng(7)
    w, buf, g, mu = (rng.standard_normal((n, T, 128), dtype=np.float32)
                     for _ in range(4))
    partner = np.array([1, 0, 3, 2, 5, 4])
    partners = partner[None].astype(np.int32)
    mix = np.tile([0.5, 0.5], (n, 1))
    active = np.ones(n)
    active[0] = 0.0
    fresh = np.zeros(n)
    fresh[[2, 3]] = 1.0
    coefs = np.concatenate(
        [mix, np.ones((n, 1)), active[:, None], fresh[partner][:, None],
         np.maximum(active, fresh)[:, None]], axis=1).astype(np.float32)
    mu = mu if has_mu else None
    kw = dict(lr=0.1, beta=0.9)
    t = [None if a is None else torch.tensor(a)
         for a in (w, w, g, mu, partners, coefs, buf)]
    got = ops.flat_gossip_update(*t[:6], buffer=t[6], **kw)
    for pallas in (False, True):
        jargs = [None if a is None else jnp.asarray(a)
                 for a in (w, w, g, mu, partners, coefs)]
        jmu = jargs[3] if has_mu else jargs[0]
        if pallas:
            want = jax_kernel(*jargs[:3], jmu, *jargs[4:], buffer=jnp.asarray(
                buf), has_momentum=has_mu, interpret=True, **kw)
        else:
            want = jax_ref.gossip_mix_update_flat_ref(
                *jargs[:3], jmu, *jargs[4:], buffer=jnp.asarray(buf),
                has_momentum=has_mu, **kw)
        for a, b in zip(got, want):
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=ATOL, rtol=0)
    # the unfused composition
    remote = np.where(fresh[:, None, None] > 0.5, w, buf)
    mixed = 0.5 * w + 0.5 * remote[partner]
    mu_new = (0.9 * mu + g) if has_mu else g
    w_exp = np.where(active[:, None, None] > 0.5, mixed - 0.1 * mu_new, w)
    buf_exp = np.where(np.maximum(active, fresh)[:, None, None] > 0.5, w_exp,
                       buf)
    np.testing.assert_allclose(got[0].numpy(), w_exp, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), buf_exp, atol=1e-5)
    # inactive learner 0: weights untouched, nothing published
    np.testing.assert_array_equal(got[0][0].numpy(), w[0])
    np.testing.assert_array_equal(got[2][0].numpy(), buf[0])


def test_solo_learner_keeps_self_mix():
    """coefs [1, 0]: the solo learner's mix is exactly its own weights and
    the update still applies."""
    n, T = 4, 16
    rng = np.random.default_rng(3)
    w, g = (torch.tensor(rng.standard_normal((n, T, 128), dtype=np.float32))
            for _ in range(2))
    partners = torch.tensor([[1, 0, 3, 2]], dtype=torch.int32)
    coefs = torch.tensor([[1.0, 0.0, 1.0, 1.0]] * n)
    w1, _ = ops.flat_gossip_update(w, w, g, None, partners, coefs, lr=0.1)
    torch.testing.assert_close(w1, w - 0.1 * g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["ring", "torus", "full", "hierarchical",
                                  "exp", "one_peer_exp", "random_pair",
                                  "random_matching"])
def test_mixing_round_matches_the_step_matrix(name):
    """``flat_gossip_mix`` over one step's rounds realizes the schedule's
    step matrix (the mixing-only rounds of multi-round schedules)."""
    n, T = 8, 8
    s = make_schedule(name, n, rounds=2)
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((n, T, 128), generator=gen, dtype=torch.float64).float()
    cur = w
    gen_r = torch.Generator().manual_seed(11)
    for partners, coefs in s.step_rounds(gen_r, 0):
        cur = ops.flat_gossip_mix(cur, partners, coefs)
    gen_r.manual_seed(11)
    m = torch.eye(n)
    for partners, coefs in s.step_rounds(gen_r, 0):
        r = torch.zeros((n, n))
        r[torch.arange(n), torch.arange(n)] += coefs[:, 0]
        for k in range(partners.shape[0]):
            r[torch.arange(n), partners[k].long()] += coefs[:, 1 + k]
        m = r @ m
    want = torch.einsum("ij,j...->i...", m, w)
    torch.testing.assert_close(cur, want, rtol=0, atol=1e-5)


def test_dispatcher_takes_plain_version_for_cpu_tensors():
    args = [None if a is None else torch.tensor(a)
            for a in _operands(4, 8, 1, True, seed=9)]
    before = gossip_mix_update_flat.launches
    mu = args[3].clone()
    out = torch.empty_like(args[0])
    got = ops.flat_gossip_update(*args[:3], mu, *args[4:], lr=0.1, beta=0.9,
                                 out=out)
    want = ref.gossip_mix_update_flat_ref(*args, lr=0.1, beta=0.9)
    assert got[0] is out and got[1] is mu          # out written, mu in place
    torch.testing.assert_close(out, want[0], rtol=0, atol=0)
    torch.testing.assert_close(mu, want[1], rtol=0, atol=0)
    assert gossip_mix_update_flat.launches == before
    ref_backend = ops.flat_gossip_update(*args, lr=0.1, beta=0.9,
                                         backend="ref")
    torch.testing.assert_close(ref_backend[0], want[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="backend"):
        ops.flat_gossip_update(*args, lr=0.1, backend="pallas")


def test_outputs_must_not_overlap_inputs():
    w, remote, g, mu, partners, coefs = [
        None if a is None else torch.tensor(a)
        for a in _operands(4, 8, 1, True, seed=2)]
    for out in (w, remote, g, mu):
        with pytest.raises(ValueError, match="overlaps"):
            ops.flat_gossip_update(w, remote, g, mu, partners, coefs,
                                   lr=0.1, out=out)
    with pytest.raises(ValueError, match="overlaps"):
        ops.flat_gossip_mix(w, partners, coefs[:, :2], out=w)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [None if a is None else torch.tensor(a)
            for a in _operands(4, 8, 1, True)]
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_update_flat(*args, lr=0.1)


# ---------------------------------------------------------------------------
# the CUDA kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _cuda(arrays, device):
    return [None if a is None else torch.tensor(a, device=device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("n,T,K", GRID + [(16, 8, 16), (3, 1000, 2)])
@pytest.mark.parametrize("has_mu,wd", MODES)
def test_cuda_kernel_equals_plain_version_bitwise(cuda_device, n, T, K,
                                                  has_mu, wd):
    w, remote, g, mu, partners, coefs = _cuda(
        _operands(n, T, K, has_mu, seed=n + T + K), cuda_device)
    kw = dict(lr=0.1, beta=0.9, weight_decay=wd)
    want = ops.flat_gossip_update(w, remote, g,
                                  None if mu is None else mu.clone(),
                                  partners, coefs, backend="ref", **kw)
    before = gossip_mix_update_flat.launches
    got = ops.flat_gossip_update(w, remote, g, mu, partners, coefs, **kw)
    torch.cuda.synchronize()
    assert gossip_mix_update_flat.launches == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    if has_mu:
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("has_mu,fresh_col", list(itertools.product(
    (True, False), ((0, 1, 1, 0, 1, 0), (1,) * 6))))
def test_cuda_publish_mode_equals_plain_version(cuda_device, has_mu,
                                                fresh_col):
    n, T = 6, 40
    rng = np.random.default_rng(1)
    w, buf, g, mu = (torch.tensor(rng.standard_normal(
        (n, T, 128), dtype=np.float32), device=cuda_device)
        for _ in range(4))
    partner = np.array([1, 0, 3, 2, 5, 4])
    active = np.array([0, 1, 1, 1, 0, 1], np.float32)
    fresh = np.asarray(fresh_col, np.float32)
    coefs = torch.tensor(np.concatenate(
        [np.tile([0.5, 0.5], (n, 1)), np.ones((n, 1)), active[:, None],
         fresh[partner][:, None], np.maximum(active, fresh)[:, None]],
        axis=1).astype(np.float32), device=cuda_device)
    partners = torch.tensor(partner[None], dtype=torch.int32,
                            device=cuda_device)
    mu = mu if has_mu else None
    kw = dict(lr=0.05, beta=0.9, buffer=buf)
    want = ops.flat_gossip_update(w, w, g, None if mu is None else mu.clone(),
                                  partners, coefs, backend="ref", **kw)
    got = ops.flat_gossip_update(w, w, g, mu, partners, coefs, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    w, remote, g, mu, partners, coefs = _cuda(
        _operands(4, 8, 1, True), cuda_device)
    with pytest.raises(ValueError, match="int32"):
        gossip_mix_update_flat(w, remote, g, mu, partners.long(), coefs,
                               lr=0.1)
    with pytest.raises(ValueError, match="float32"):
        gossip_mix_update_flat(w.double(), remote, g, mu, partners, coefs,
                               lr=0.1)
    with pytest.raises(ValueError, match="coefs"):
        gossip_mix_update_flat(w, remote, g, mu, partners, coefs[:, :3],
                               lr=0.1)
    with pytest.raises(ValueError, match="overlaps"):
        gossip_mix_update_flat(w, remote, g, mu, partners, coefs, lr=0.1,
                               out=remote)
    big = torch.zeros((17, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="K=17"):
        gossip_mix_update_flat(w, remote, g, mu, big, coefs, lr=0.1)


# ---------------------------------------------------------------------------
# the single-learner kernel (ops.dpsgd_fused_update)
# ---------------------------------------------------------------------------

SINGLE_GRID = [(256, 1), (512, 2), (1024, 3)]   # test_gossip_kernel_sweep's


def _single_operands(T, K, seed):
    rng = np.random.default_rng(seed)
    w, g, mu = (rng.standard_normal((T, 128), dtype=np.float32)
                for _ in range(3))
    nb = rng.standard_normal((K, T, 128), dtype=np.float32)
    coefs = np.concatenate([[0.5], np.full((K,), 0.5 / K)]).astype(
        np.float32)
    return w, nb, g, mu, coefs


@pytest.mark.parametrize("T,K", SINGLE_GRID)
def test_single_learner_plain_version_matches_reference(T, K):
    """Bitwise against the reference's jnp oracle (the same rounded
    operations in the same order); within ``ATOL`` of its Pallas kernel in
    interpret mode, which XLA may contract into FMAs."""
    from repro.kernels.gossip_mix import gossip_mix_update as jax_single
    arrs = _single_operands(T, K, seed=T + K)
    want = jax_ref.gossip_mix_update_ref(*map(jnp.asarray, arrs), lr=0.1,
                                         beta=0.9)
    got = ref.gossip_mix_update_ref(*map(torch.tensor, arrs), lr=0.1,
                                    beta=0.9)
    kern = jax_single(*map(jnp.asarray, arrs), lr=0.1, beta=0.9,
                      interpret=True)
    for g, w, k in zip(got, want, kern):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=ATOL,
                                   rtol=0)


def _trees(seed, K):
    """A small parameter tree (mixed shapes, padding in the flat view), K
    neighbour trees, gradients and momentum, as numpy."""
    rng = np.random.default_rng(seed)

    def tree():
        return {"w": rng.standard_normal((33, 7), dtype=np.float32),
                "b": rng.standard_normal((5,), dtype=np.float32),
                "blk": {"k": rng.standard_normal((3, 64), dtype=np.float32)}}
    return tree(), [tree() for _ in range(K)], tree(), tree()


@pytest.mark.parametrize("K", [1, 2])
def test_dpsgd_fused_update_matches_reference(K):
    from repro.kernels.ops import dpsgd_fused_update as jax_fused
    from repro_torch.tree import tree_map
    params, nbrs, grads, mom = _trees(K, K)
    coefs = [1.0 / (K + 1)] * (K + 1)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    to_t = lambda t: tree_map(torch.tensor, t)                # noqa: E731
    jw, jmu = jax_fused(to_j(params), [to_j(t) for t in nbrs], to_j(grads),
                        to_j(mom), coefs, lr=0.1, beta=0.9)
    before = gossip_mix_update.launches
    pw, pmu = ops.dpsgd_fused_update(to_t(params), [to_t(t) for t in nbrs],
                                     to_t(grads), to_t(mom), coefs, lr=0.1,
                                     beta=0.9)
    assert gossip_mix_update.launches == before        # CPU: plain version
    for name in ("w", "b"):
        assert pw[name].shape == params[name].shape
        np.testing.assert_allclose(pw[name].numpy(), np.asarray(jw[name]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(pmu[name].numpy(), np.asarray(jmu[name]),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(pw["blk"]["k"].numpy(),
                               np.asarray(jw["blk"]["k"]), atol=ATOL, rtol=0)


def test_dpsgd_fused_update_closed_form():
    """The reference's ``test_dpsgd_fused_update_tree``: mixed = (w + (w +
    1)) / 2 = w + 0.5, mu = g = 1, new = mixed - 0.1."""
    rng = np.random.default_rng(10)
    tree = {"w": torch.tensor(rng.standard_normal((33, 7),
                                                  dtype=np.float32)),
            "b": torch.ones(5)}
    nbr = {k: v + 1.0 for k, v in tree.items()}
    g = {k: torch.ones_like(v) for k, v in tree.items()}
    mu = {k: torch.zeros_like(v) for k, v in tree.items()}
    new_w, new_mu = ops.dpsgd_fused_update(tree, [nbr], g, mu, [0.5, 0.5],
                                           lr=0.1, beta=0.9)
    torch.testing.assert_close(new_w["w"], tree["w"] + 0.5 - 0.1,
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(new_mu["b"], torch.ones(5), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="backend"):
        ops.dpsgd_fused_update(tree, [nbr], g, mu, [0.5, 0.5], lr=0.1,
                               backend="pallas")


def test_single_learner_wrapper_refuses_cpu_tensors():
    args = [torch.tensor(a) for a in _single_operands(8, 1, seed=0)]
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_update(*args, lr=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("T,K", SINGLE_GRID + [(1000, 16), (8, 1)])
def test_cuda_single_learner_kernel_equals_plain_version_bitwise(
        cuda_device, T, K):
    arrs = _cuda(_single_operands(T, K, seed=T + K), cuda_device)
    want = ref.gossip_mix_update_ref(*arrs, lr=0.1, beta=0.9)
    before = gossip_mix_update.launches
    got = gossip_mix_update(*arrs, lr=0.1, beta=0.9)
    torch.cuda.synchronize()
    assert gossip_mix_update.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_dpsgd_fused_update_launches_the_kernel(cuda_device):
    from repro_torch.tree import tree_map
    params, nbrs, grads, mom = _trees(3, 2)
    to_c = lambda t: tree_map(                                 # noqa: E731
        lambda a: torch.tensor(a, device=cuda_device), t)
    args = (to_c(params), [to_c(t) for t in nbrs], to_c(grads), to_c(mom),
            [0.5, 0.25, 0.25])
    want = ops.dpsgd_fused_update(*args, lr=0.1, backend="ref")
    before = gossip_mix_update.launches
    got = ops.dpsgd_fused_update(*args, lr=0.1)
    torch.cuda.synchronize()
    assert gossip_mix_update.launches == before + 1
    for a, b in zip(got, want):
        for name in ("w", "b"):
            torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_single_learner_wrapper_rejects_what_it_does_not_take(
        cuda_device):
    w, nb, g, mu, coefs = _cuda(_single_operands(8, 2, seed=0), cuda_device)
    with pytest.raises(ValueError, match="coefs"):
        gossip_mix_update(w, nb, g, mu, coefs[:2], lr=0.1)
    with pytest.raises(ValueError, match="neighbors"):
        gossip_mix_update(w, nb[:, :4], g, mu, coefs, lr=0.1)
    with pytest.raises(ValueError, match="float32"):
        gossip_mix_update(w.double(), nb, g, mu, coefs, lr=0.1)
    big = torch.zeros((17, 8, 128), device=cuda_device)
    with pytest.raises(ValueError, match="K=17"):
        gossip_mix_update(w, big, g, mu, torch.zeros(18, device=cuda_device),
                          lr=0.1)
