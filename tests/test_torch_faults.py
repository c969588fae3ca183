"""The port's fault harness against the JAX reference (DESIGN §15).

  * ``FaultPlan``: sorted, queryable, rejects an unknown kind; ``random``
    gives the reference's plan event for event (both draw from
    ``np.random.default_rng``) and keeps the live floor;
  * ``apply_plan``: event semantics, the rejoin surgery before the mask
    flip, the dropped-round signal;
  * ``Supervisor``: the evict ladder of a sticky hang (DPSGD and AD-PSGD)
    and the recovery of a transient one give the reference's report, step
    for step; supervised crash-rejoin and chaos runs stay finite;
  * ``bench.common.train_fc(fault_plan=...)``: the benchmarks' crash-rejoin
    plus straggler plan trains finite, with the reference's report.

Reports, plans and membership arrays are integers and are held exactly;
the supervisor's decisions depend only on the plan and on AD-PSGD's
per-learner clocks, which follow from the masks, not from the weights.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.core import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.core import Membership as JaxMembership  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.core import Supervisor as JaxSupervisor  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro.data import TemplateImages as JaxImages  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.bench.common import train_fc  # noqa: E402
from repro_torch.core import (AlgoConfig, FaultEvent,  # noqa: E402
                              FaultPlan, Membership, MultiLearnerTrainer,
                              Supervisor, apply_plan)
from repro_torch.core.membership import HUNG  # noqa: E402
from repro_torch.data import ShardedLoader, TemplateImages  # noqa: E402
from repro_torch.models import fcnet  # noqa: E402

N = 5
LOADER = ShardedLoader(TemplateImages(), n_learners=N, local_batch=32,
                       seed=0, device="cpu")
PARAMS = fcnet.init_params(torch.Generator().manual_seed(0), in_dim=784,
                           hidden=50)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trainer(algo="dpsgd", engine="flat", **kw):
    if algo == "adpsgd":
        kw.setdefault("max_staleness", 4)
    return MultiLearnerTrainer(
        fcnet.loss_fn, optim.sgd(0.1, momentum=0.9),
        AlgoConfig(algo=algo, topology="random_pair", n_learners=N,
                   noise_std=0.0, **kw), engine=engine, device="cpu")


def _elastic_state(tr, seed=1):
    mem = Membership(N)
    return tr.set_membership(tr.init(seed, PARAMS), mem), mem


def _report(rep):
    return (rep.crashes, rep.rejoins, rep.retries, rep.evictions,
            rep.dropped_rounds)


def _reference_report(algo, plan_events, steps, **sup_kw):
    """The reference's Supervisor over the same plan: its report and its
    final membership arrays."""
    kw = dict(max_staleness=4) if algo == "adpsgd" else {}
    tr = JaxTrainer(jax_fcnet.loss_fn, jax_optim.sgd(0.1, momentum=0.9),
                    JaxAlgoConfig(algo=algo, topology="random_pair",
                                  n_learners=N, noise_std=0.0, **kw),
                    engine="flat", kernel_backend="ref")
    mem = JaxMembership(N)
    st = tr.set_membership(tr.init(jax.random.PRNGKey(1),
                                   jax_fcnet.init_params(
                                       jax.random.PRNGKey(0), in_dim=784,
                                       hidden=50)), mem)
    plan = JaxFaultPlan(tuple(JaxFaultEvent(*e) for e in plan_events))
    sup = JaxSupervisor(tr, mem, plan, **sup_kw)
    loader = JaxLoader(JaxImages(), n_learners=N, local_batch=32, seed=0)
    sup.run(st, loader.batch, steps=steps)
    return _report(sup.report), mem


# ---------------------------------------------------------------------------
# FaultPlan and apply_plan
# ---------------------------------------------------------------------------

def test_plan_events_sorted_and_queryable():
    plan = FaultPlan((FaultEvent(9, "crash", 1), FaultEvent(2, "slow", 0, 3),
                      FaultEvent(9, "drop_round")))
    assert [e.step for e in plan.events] == [2, 9, 9]
    assert plan.last_step == 9
    assert {e.kind for e in plan.at(9)} == {"crash", "drop_round"}
    assert plan.at(5) == []
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan((FaultEvent(0, "explode", 0),))
    with pytest.raises(ValueError, match="not after"):
        FaultPlan.crash_rejoin(1, 5, 5)


@pytest.mark.parametrize("seed,steps,cap,kw", [
    (0, 120, 8, {}), (7, 200, 8, {}), (3, 500, 4,
                                      dict(p_crash=0.5, p_rejoin=0.05)),
    (11, 300, 13, dict(p_slow=0.1, p_drop=0.1, min_active=3)),
    (0, 15, N, dict(min_active=2))])
def test_random_plan_equals_reference_event_for_event(seed, steps, cap, kw):
    got = FaultPlan.random(seed, steps, cap, **kw)
    want = JaxFaultPlan.random(seed, steps, cap, **kw)
    assert got.events                      # some faults at these rates
    assert [tuple(e) for e in got.events] == [tuple(e) for e in want.events]
    assert got.events != FaultPlan.random(seed + 1, steps, cap, **kw).events


def test_random_plan_respects_min_active_floor():
    plan = FaultPlan.random(3, steps=500, capacity=4, p_crash=0.5,
                            p_rejoin=0.05, min_active=2)
    active = np.ones(4, bool)
    for ev in plan.events:
        if ev.kind == "crash":
            active[ev.learner] = False
        elif ev.kind == "rejoin":
            active[ev.learner] = True
        assert active.sum() >= 2, ev


def test_apply_plan_semantics_and_rejoin_ordering():
    mem = Membership(4)
    seen = []
    plan = FaultPlan((
        FaultEvent(0, "crash", 2), FaultEvent(0, "slow", 1, 3),
        FaultEvent(1, "rejoin", 2), FaultEvent(1, "drop_round"),
        FaultEvent(2, "hang", 0, True), FaultEvent(3, "recover", 0)))
    sticky = set()
    assert apply_plan(mem, plan, 0, sticky=sticky) is False
    assert not mem.active[2] and mem.slow_every[1] == 3
    # on_rejoin observes the PRE-flip mask (admit clones the live mean)
    drop = apply_plan(mem, plan, 1, sticky=sticky,
                      on_rejoin=lambda s: seen.append((s, mem.active.copy())))
    assert drop is True
    assert seen[0][0] == 2 and not seen[0][1][2]
    assert mem.active[2] and mem.incarnation[2] == 1
    apply_plan(mem, plan, 2, sticky=sticky)
    assert mem.slow_every[0] == HUNG and sticky == {0}
    apply_plan(mem, plan, 3, sticky=sticky)
    assert mem.slow_every[0] == 1 and sticky == set()
    assert mem.epoch == 5
    with pytest.raises(ValueError, match="no inactive slot"):
        mem.join()


# ---------------------------------------------------------------------------
# the Supervisor on the port's trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["dpsgd", "adpsgd"])
def test_supervisor_evicts_sticky_hang_as_the_reference(algo):
    events = (FaultEvent(0, "hang", 2, True),)        # recovery-proof
    kw = dict(staleness_bound=1, grace=1, max_retries=2)
    tr = _trainer(algo)
    st, mem = _elastic_state(tr)
    sup = Supervisor(tr, mem, FaultPlan(events), **kw)
    st, losses = sup.run(st, LOADER.batch, steps=20)
    assert all(np.isfinite(losses))
    # retry ladder: thresholds 1, 2, 4 ticks -> two retries, then eviction
    assert len([1 for _, i in sup.report.retries if i == 2]) == 2
    assert [i for _, i in sup.report.evictions] == [2]
    assert not mem.active[2] and mem.n_active == N - 1
    want, jmem = _reference_report(algo, events, 20, **kw)
    assert _report(sup.report) == want
    np.testing.assert_array_equal(mem.active, jmem.active)
    np.testing.assert_array_equal(mem.slow_every, jmem.slow_every)


def test_supervisor_recovers_transient_hang_as_the_reference():
    events = (FaultEvent(0, "hang", 1),)               # a transient wedge
    kw = dict(staleness_bound=1, grace=1, max_retries=3)
    tr = _trainer("dpsgd")
    st, mem = _elastic_state(tr)
    sup = Supervisor(tr, mem, FaultPlan(events), **kw)
    st, losses = sup.run(st, LOADER.batch, steps=12)
    assert all(np.isfinite(losses))
    assert [i for _, i in sup.report.retries][:1] == [1]    # retried...
    assert sup.report.evictions == []                       # ...not evicted
    assert mem.active[1] and mem.slow_every[1] == 1         # healthy again
    assert _report(sup.report) == _reference_report("dpsgd", events, 12,
                                                    **kw)[0]


@pytest.mark.parametrize("algo,engine", [("dpsgd", "flat"),
                                         ("dpsgd", "pytree"),
                                         ("adpsgd", "flat")])
def test_supervised_crash_rejoin_run(algo, engine):
    tr = _trainer(algo, engine)
    st, mem = _elastic_state(tr)
    plan = FaultPlan(FaultPlan.crash_rejoin(1, 3, 7).events
                     + (FaultEvent(5, "drop_round"),
                        FaultEvent(0, "slow", 0, 2)))
    sup = Supervisor(tr, mem, plan)
    st, losses = sup.run(st, LOADER.batch, steps=10)
    assert all(np.isfinite(losses))
    assert sup.report.crashes == [(3, 1)]
    assert sup.report.rejoins == [(7, 1)]
    assert sup.report.dropped_rounds == 1
    assert sup.report.evictions == []
    assert mem.n_active == N and mem.incarnation[1] == 1
    if st.clock is not None:     # the straggler completed every other tick
        assert int(st.clock[0]) < int(st.clock[2])


def test_supervised_chaos_run_stays_finite():
    tr = _trainer("dpsgd")
    st, mem = _elastic_state(tr)
    plan = FaultPlan.random(0, steps=15, capacity=N, min_active=2)
    sup = Supervisor(tr, mem, plan)
    st, losses = sup.run(st, LOADER.batch, steps=15)
    assert all(np.isfinite(losses))
    assert mem.n_active >= 2
    assert plan.events and sup.report.dropped_rounds == sum(
        e.kind == "drop_round" for e in plan.events)


def _bench_plan(steps):
    """``benchmarks/faults.py``'s crash-rejoin scenario: learner 1 dies at
    1/3 and rejoins at 2/3, learner 0 is a 2x straggler throughout."""
    plan = FaultPlan.crash_rejoin(1, steps // 3, 2 * steps // 3)
    return FaultPlan(plan.events + FaultPlan.straggler(0, 2).events)


@pytest.mark.parametrize("algo", ["dpsgd", "adpsgd"])
def test_train_fc_with_fault_plan(algo):
    steps = 12
    out = train_fc(algo, 0.5, n=N, local_batch=32, steps=steps,
                   algo_kwargs=dict(max_staleness=4) if algo == "adpsgd"
                   else None, fault_plan=_bench_plan(steps), device="cpu")
    assert len(out["losses"]) == steps - 1
    assert all(np.isfinite(out["losses"]))
    sup = out["supervisor"]
    assert sup.report.crashes == [(4, 1)] and sup.report.rejoins == [(8, 1)]
    assert sup.membership.n_active == N
    assert out["state"].members is not None
    assert _report(sup.report) == _reference_report(
        algo, _bench_plan(steps).events, steps)[0]
