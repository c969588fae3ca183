"""The port's ``spectral_gap_profile`` against the JAX reference's.

Deterministic schedules compile to the same float32 step matrices in both
packages (``tests/test_torch_schedule.py``), so every field of the profile
agrees within 1e-6 (both in float64 from the same tables).  Randomized
schedules draw other matchings (a ``torch.Generator`` against
``jax.random``), so they are held by property: the measured rate never
beats the submultiplicative bound, for several seeds.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.schedule import make_schedule as jax_make_schedule  # noqa: E402
from repro.core.schedule import spectral_gap_profile as jax_profile  # noqa: E402
from repro_torch.core import make_schedule, spectral_gap_profile  # noqa: E402
from repro_torch.core.schedule import DETERMINISTIC_TOPOLOGIES  # noqa: E402

TOL = 1e-6
KEYS = ("window", "measured_rate", "bound_rate", "measured_gap",
        "gap_bound")


def _assert_profiles(got, want):
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got["per_step_gap"], want["per_step_gap"],
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("n", [6, 8])
@pytest.mark.parametrize("topology", DETERMINISTIC_TOPOLOGIES)
def test_deterministic_profiles_match_reference(topology, n, window):
    got = spectral_gap_profile(make_schedule(topology, n), window=window)
    want = jax_profile(jax_make_schedule(topology, n), window=window)
    _assert_profiles(got, want)
    assert got["measured_gap"] >= got["gap_bound"] - 1e-9


@pytest.mark.parametrize("window", [0, 5])
def test_solo_profile_matches_reference(window):
    assert make_schedule("solo", 8) is None
    _assert_profiles(spectral_gap_profile(None, window=window),
                     jax_profile(None, window=window))


def test_floor_keeps_the_inequality_on_a_fully_mixed_window():
    """The hypercube full average mixes exactly in one step: both norms
    sit at float32 noise, and the floor keeps measured <= bound."""
    for floor in (1e-6, 1e-3):
        got = spectral_gap_profile(make_schedule("full", 8), window=8,
                                   floor=floor)
        want = jax_profile(jax_make_schedule("full", 8), window=8,
                           floor=floor)
        _assert_profiles(got, want)
        assert got["measured_rate"] == pytest.approx(floor ** (1 / 8))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("topology,rounds", [("random_pair", 1),
                                             ("random_matching", 2),
                                             ("random_matching", 3)])
def test_randomized_profiles_respect_the_bound(topology, rounds, seed):
    sched = make_schedule(topology, 8, rounds=rounds)
    prof = spectral_gap_profile(sched, window=16, seed=seed)
    assert prof["window"] == 16 and len(prof["per_step_gap"]) == 16
    assert prof["measured_rate"] <= prof["bound_rate"] + 1e-12
    assert prof["measured_gap"] >= prof["gap_bound"] - 1e-12
    assert 0.0 <= prof["measured_gap"] <= 1.0
    # the same seed draws the same matchings; a generator may be passed
    again = spectral_gap_profile(sched, window=16,
                                 gen=torch.Generator().manual_seed(seed))
    assert again == prof
    # the reference's default window for the same schedule
    assert (spectral_gap_profile(sched, seed=seed)["window"]
            == jax_profile(jax_make_schedule(topology, 8, rounds=rounds))[
                "window"])
