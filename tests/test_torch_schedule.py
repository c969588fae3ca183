"""The port's gossip topologies and schedules against the JAX reference.

Deterministic schedules are compiled by the same numpy code in both
packages, so their tables, step matrices and flags must be EQUAL, not
close, for every deterministic topology over a grid of fleet sizes.  The
random matchings come from a ``torch.Generator`` (the reference's law, not
its draws), so they are checked by property: every draw is an involutive
perfect matching, and its tables realize a doubly stochastic matrix.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import dpsgd as jax_dpsgd  # noqa: E402
from repro.core import schedule as jax_sched  # noqa: E402
from repro.core import topology as jax_topo  # noqa: E402
from repro_torch.core import schedule as gsched  # noqa: E402
from repro_torch.core import topology as topo  # noqa: E402
from repro_torch.core.dpsgd import AlgoConfig  # noqa: E402

NS = (2, 3, 4, 5, 6, 7, 8, 9, 12, 16)
DET = gsched.DETERMINISTIC_TOPOLOGIES


def test_topology_lists_match_reference():
    assert gsched.SCHEDULED_TOPOLOGIES == jax_sched.SCHEDULED_TOPOLOGIES
    assert gsched.DETERMINISTIC_TOPOLOGIES == \
        jax_sched.DETERMINISTIC_TOPOLOGIES


@pytest.mark.parametrize("name,n", list(itertools.product(DET, NS)))
def test_deterministic_tables_equal_reference(name, n):
    s, r = gsched.make_schedule(name, n), jax_sched.make_schedule(name, n)
    for f in ("n", "K", "period", "rounds_per_step", "randomized",
              "symmetric", "perm_rounds", "time_varying"):
        assert getattr(s, f) == getattr(r, f), f
    np.testing.assert_array_equal(s.partners, r.partners)
    np.testing.assert_array_equal(s.coefs, r.coefs)
    np.testing.assert_array_equal(s.step_mats, r.step_mats)
    np.testing.assert_array_equal(s.mean_matrix(), r.mean_matrix())
    for step in range(2 * s.period + 1):
        got = s.step_rounds(None, step)
        want = r.step_rounds(None, step)
        assert len(got) == len(want) == s.rounds_per_step
        for (gp, gc), (wp, wc) in zip(got, want):
            assert gp.dtype == torch.int32 and gc.dtype == torch.float32
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(s.step_matrix(None, step).numpy(),
                                      np.asarray(r.step_matrix(None, step)))


def test_solo_and_unknown_topologies():
    assert gsched.make_schedule("solo", 8) is None
    assert gsched.make_schedule("ring", 1) is None
    with pytest.raises(ValueError, match="unknown topology"):
        gsched.make_schedule("moebius", 8)


@pytest.mark.parametrize("n,seed", list(itertools.product(
    (2, 3, 4, 5, 8, 9, 16, 17), (0, 1, 7, 123))))
def test_random_matching_is_a_perfect_matching(n, seed):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(5):
        p = topo.pair_partners(gen, n)
        idx = torch.arange(n)
        assert torch.equal(p[p], idx)                     # involution
        assert int((p == idx).sum()) == n % 2             # solo iff odd n
        m = topo.partner_matrix(p, n)
        assert topo.is_doubly_stochastic(m)
        assert torch.equal(m, m.T)


@pytest.mark.parametrize("name,n", list(itertools.product(
    ("random_pair", "random_matching"), (2, 5, 8))))
def test_randomized_schedule_tables(name, n):
    s = gsched.make_schedule(name, n, rounds=3)
    r = jax_sched.make_schedule(name, n, rounds=3)
    assert (s.K, s.period, s.rounds_per_step, s.randomized, s.symmetric,
            s.time_varying) == (r.K, r.period, r.rounds_per_step,
                                r.randomized, r.symmetric, r.time_varying)
    gen = torch.Generator().manual_seed(n)
    for step in range(4):
        rounds = s.step_rounds(gen, step)
        assert len(rounds) == s.rounds_per_step
        for partners, coefs in rounds:
            p = partners[0].long()
            assert partners.shape == (1, n) and coefs.shape == (n, 2)
            solo = p == torch.arange(n)
            torch.testing.assert_close(
                coefs[:, 0], torch.where(solo, 1.0, 0.5), rtol=0, atol=0)
            torch.testing.assert_close(coefs.sum(1), torch.ones(n),
                                       rtol=0, atol=0)
            assert torch.equal(p[p], torch.arange(n))
        assert topo.is_doubly_stochastic(s.step_matrix(gen, step))


@pytest.mark.parametrize("n", (2, 3, 4, 6, 8, 9))
def test_topology_matrices_equal_reference(n):
    pairs = [(topo.full_matrix(n), jax_topo.full_matrix(n)),
             (topo.ring_matrix(n), jax_topo.ring_matrix(n)),
             (topo.exponential_matrix(n), jax_topo.exponential_matrix(n))]
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    pairs.append((topo.torus_matrix(r, n // r),
                  jax_topo.torus_matrix(r, n // r)))
    if 1 < r < n:
        pairs.append((topo.hierarchical_matrix(n // r, r),
                      jax_topo.hierarchical_matrix(n // r, r)))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert topo.is_doubly_stochastic(got)
        assert topo.spectral_gap(got) == pytest.approx(
            jax_topo.spectral_gap(want), abs=1e-12)
    p = np.arange(n) ^ 1 if n % 2 == 0 else np.arange(n)
    np.testing.assert_array_equal(
        topo.partner_matrix(torch.tensor(p), n).numpy(),
        np.asarray(jax_topo.partner_matrix(p, n)))


BAD_ALGOS = [dict(algo="sgd"), dict(gossip_order="mix_twice"),
             dict(gossip_rounds=0), dict(gossip_rounds=2, topology="ring"),
             dict(max_staleness=-1), dict(slow_factor=0),
             dict(slow_learner=16),
             dict(algo="adpsgd", topology="ring"),
             dict(algo="adpsgd", gossip_order="descend_then_mix")]


@pytest.mark.parametrize("kw", BAD_ALGOS, ids=[str(k) for k in BAD_ALGOS])
def test_algo_config_validates_like_the_reference(kw):
    with pytest.raises(ValueError):
        AlgoConfig(**kw)
    with pytest.raises(AssertionError):
        jax_dpsgd.AlgoConfig(**kw)


def test_algo_config_fields_match_reference():
    import dataclasses
    assert dataclasses.asdict(AlgoConfig()) == dataclasses.asdict(
        jax_dpsgd.AlgoConfig())


def test_straggler_mask_matches_reference():
    from repro_torch.core.dpsgd import straggler_active_mask
    for step, slow, factor in itertools.product(range(6), (-1, 0, 3),
                                                (1, 2, 3)):
        got = straggler_active_mask(step, 5, slow, factor)
        want = jax_dpsgd.straggler_active_mask(step, 5, slow, factor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
