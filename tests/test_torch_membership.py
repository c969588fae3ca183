"""The port's elastic membership against the JAX reference (DESIGN §15).

  * only-active matching: ``masked_pair_partners`` is an involution that
    never pairs across the liveness boundary, reproduces the port's legacy
    ``pair_partners`` matching bitwise when everyone is live (the same
    generator, consumed alike), and a dropped round is the identity;
  * ``reschedule``: the tables, matrices and shapes equal the reference's
    exactly for every deterministic topology and the reference's active
    sets, and no live row's neighbour slot points at a dead slot;
  * elastic == legacy inside the port: an all-active elastic state trains
    bitwise as the fixed fleet does (DPSGD and AD-PSGD, both engines);
  * quarantine: a crashed learner's rows are bitwise frozen, and
    NaN-poisoning them leaves every live row bitwise unchanged and finite;
  * ``admit`` (consensus and quarantine) equals the reference's ``admit``
    on the same injected state;
  * the bridge's snapshot excludes dead rows;
  * elastic steps equal the reference's, its matchings injected.

Tolerances: tables and matchings are integers and float32 constants copied
from numpy, held exactly.  ``admit``'s consensus row sums five float32 rows
in another order than XLA: 1e-6 relative (an f32-ulp tier).  Training steps
use ``tests/test_torch_trainer.py``'s tier, 1e-5 absolute + 1e-4 relative
on parameters, momentum and buffer (the two frameworks' BLAS sum the
gradients' products in other orders) and 1e-4 relative on metrics; the
reference's own elastic path is 1.9e-9 from its legacy path under jax 0.9
(ROADMAP, "Reference caveats"), far inside it.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import Membership as JaxMembership  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.core import admit as jax_admit  # noqa: E402
from repro.core import reschedule as jax_reschedule  # noqa: E402
from repro.data import ShardedLoader as JaxLoader  # noqa: E402
from repro.data import TemplateImages as JaxImages  # noqa: E402
from repro.models import fcnet as jax_fcnet  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core import (AlgoConfig, Membership,  # noqa: E402
                              MultiLearnerTrainer, admit, reschedule)
from repro_torch.core import schedule as gsched  # noqa: E402
from repro_torch.core import topology as topo  # noqa: E402
from repro_torch.core.dpsgd import (member_active_mask,  # noqa: E402
                                    straggler_active_mask)
from repro_torch.models import fcnet  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.serve.bridge import ConsensusBridge  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

N = 5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_RTOL = 1e-4
ADMIT_RTOL = 1e-6
FIELDS = ("loss", "grad_norm", "sigma_w_sq", "staleness_mean",
          "staleness_max", "n_active", "grad_sq_mean")
JAX_PARAMS = jax_fcnet.init_params(jax.random.PRNGKey(0), in_dim=784,
                                   hidden=50)
PARAMS = tree_from_jax(jax.tree_util.tree_map(np.asarray, JAX_PARAMS))
JAX_LOADER = JaxLoader(JaxImages(), n_learners=N, local_batch=32, seed=0)
_BATCHES = {}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(i):
    """The reference loader's batch ``i``, as torch tensors (cached)."""
    if i not in _BATCHES:
        _BATCHES[i] = {k: torch.tensor(np.asarray(v))
                       for k, v in JAX_LOADER.batch(i).items()}
    return _BATCHES[i]


def _trainer(algo, engine, topology="random_pair", n=N, **kw):
    if algo == "adpsgd":
        kw.setdefault("max_staleness", 4)
    return MultiLearnerTrainer(
        fcnet.loss_fn, optim.sgd(0.1, momentum=0.9),
        AlgoConfig(algo=algo, topology=topology, n_learners=n,
                   noise_std=0.0, **kw), engine=engine, device="cpu")


def _jax_trainer(algo, engine, topology="random_pair", **kw):
    if algo == "adpsgd":
        kw.setdefault("max_staleness", 4)
    return JaxTrainer(
        jax_fcnet.loss_fn, jax_optim.sgd(0.1, momentum=0.9),
        JaxAlgoConfig(algo=algo, topology=topology, n_learners=N,
                      noise_std=0.0, **kw), engine=engine,
        kernel_backend="ref")


def _run(tr, st, steps, start=0):
    m = None
    for i in range(start, start + steps):
        st, m = tr.train_step(st, _batch(i))
    return st, m


def _rows(tr, st):
    """Every stacked parameter leaf (cloned), the momentum and buffer
    too."""
    view = tr.state_view(st)
    out = [x.clone() for x in tree_leaves(view.params)]
    out += [x.clone() for x in tree_leaves(view.opt_state)
            if isinstance(x, torch.Tensor) and x.dim() > 1]
    if view.buffer is not None:
        out += [x.clone() for x in tree_leaves(view.buffer)]
    return out


# ---------------------------------------------------------------------------
# masks and matchings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 5, 8, 13])
def test_masked_matching_all_active_is_legacy_bitwise(n):
    for seed in range(6):
        legacy = topo.pair_partners(torch.Generator().manual_seed(seed), n)
        masked = topo.masked_pair_partners(
            torch.Generator().manual_seed(seed), torch.ones(n, dtype=bool))
        assert torch.equal(masked, legacy)


@pytest.mark.parametrize("n,live", [(2, [1]), (2, [0, 1]),
                                    (5, [0, 2, 3]), (8, [1]), (8, [0, 7]),
                                    (6, [0, 1, 2, 3, 4]), (4, []),
                                    (13, [0, 1, 4, 5, 6, 9, 12])])
def test_masked_matching_only_pairs_active(n, live):
    active = np.zeros(n, bool)
    active[live] = True
    gen = torch.Generator().manual_seed(n)
    for _ in range(8):
        p = topo.masked_pair_partners(gen, active).numpy()
        np.testing.assert_array_equal(p[p], np.arange(n))     # involution
        assert (p[~active] == np.flatnonzero(~active)).all()   # dead: solo
        matched = p != np.arange(n)
        assert active[matched].all() and active[p[matched]].all()
        assert int((~matched & active).sum()) == len(live) % 2


def test_masked_matching_drop_round_is_identity():
    p = topo.masked_pair_partners(torch.Generator().manual_seed(3),
                                  torch.ones(6, dtype=bool),
                                  drop=torch.tensor(True))
    np.testing.assert_array_equal(p.numpy(), np.arange(6))


def test_member_mask_reproduces_the_straggler_law_bitwise():
    n, slow, factor = 6, 2, 3
    se = torch.ones(n, dtype=torch.int32)
    se[slow] = factor
    live = torch.ones(n, dtype=bool)
    for step in range(9):
        assert torch.equal(member_active_mask(step, live, se),
                           straggler_active_mask(step, n, slow, factor))
    live[4] = False                    # a dead learner never steps
    assert not member_active_mask(0, live, se)[4]


# ---------------------------------------------------------------------------
# reschedule: the reference's tables, exactly
# ---------------------------------------------------------------------------

CAP = 8
ACTIVE_SETS = (list(range(8)), [0, 2, 3, 4, 6], [1, 2, 5, 7], [0, 4], [3])


@pytest.mark.parametrize("topology", gsched.DETERMINISTIC_TOPOLOGIES)
@pytest.mark.parametrize("live", ACTIVE_SETS,
                         ids=[f"m{len(a)}" for a in ACTIVE_SETS])
def test_reschedule_tables_equal_reference(topology, live):
    active = np.zeros(CAP, bool)
    active[live] = True
    got, want = reschedule(topology, active), jax_reschedule(topology,
                                                             active)
    for f in ("name", "n", "K", "period", "rounds_per_step", "randomized",
              "symmetric", "perm_rounds"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.partners, np.asarray(want.partners))
    np.testing.assert_array_equal(got.coefs, np.asarray(want.coefs))
    np.testing.assert_array_equal(got.step_mats, np.asarray(want.step_mats))
    np.testing.assert_array_equal(got.active, active)
    # no live row's neighbour slot (padding included) points at a dead slot
    # (the kernel reads every slot: 0 x NaN would poison the live row)
    assert active[got.partners[:, :, live]].all()
    dead = ~active
    assert (got.partners[:, :, dead] == np.flatnonzero(dead)).all()


@pytest.mark.parametrize("topology", ("full", "ring", "one_peer_exp"))
def test_reschedule_active_set_still_contracts(topology):
    active = np.zeros(CAP, bool)
    active[[0, 2, 3, 4, 6]] = True
    prof = gsched.spectral_gap_profile(reschedule(topology, active),
                                       window=8)
    assert prof["measured_rate"] <= prof["bound_rate"] + 1e-9
    assert prof["measured_gap"] > 0.0


def test_reschedule_randomized_draws_from_mask():
    active = np.array([True, False, True, True, False])
    sched = reschedule("random_pair", active)
    assert sched.randomized and sched.n == 5
    np.testing.assert_array_equal(sched.active, active)
    p, c = sched.round_tables(torch.Generator().manual_seed(0), 0)
    assert (p[0].numpy()[~active] == np.flatnonzero(~active)).all()
    m = sched.step_matrix(torch.Generator().manual_seed(0), 0).numpy()
    np.testing.assert_array_equal(m[~active][:, ~active], np.eye(2))


# ---------------------------------------------------------------------------
# the elastic trainer inside the port
# ---------------------------------------------------------------------------

DESCEND_FIRST = dict(gossip_order="descend_then_mix")
PARITY_CASES = [
    ("dpsgd", "flat", "random_pair", {}),
    ("dpsgd", "flat", "ring", {}),
    ("dpsgd", "flat", "one_peer_exp", {}),
    ("dpsgd", "flat", "torus", {}),
    ("dpsgd", "flat", "ring", DESCEND_FIRST),     # unfused flat engine
    ("dpsgd", "pytree", "random_pair", {}),
    ("adpsgd", "flat", "random_pair", {}),
    ("adpsgd", "pytree", "random_pair", {}),
]


@pytest.mark.parametrize("algo,engine,topology,kw", PARITY_CASES)
def test_all_active_elastic_is_bitwise_legacy(algo, engine, topology, kw):
    runs = []
    for elastic in (False, True):
        tr = _trainer(algo, engine, topology, **kw)
        st = tr.init(1, PARAMS)
        if elastic:
            st = tr.set_membership(st, Membership(N))
        st, m = _run(tr, st, 4)
        runs.append((_rows(tr, st), m))
    (legacy, m_l), (elastic, m_e) = runs
    for a, b in zip(legacy, elastic):
        assert torch.equal(a, b)
    # the masked metric reductions (sum / n_active against mean) may round
    # otherwise
    np.testing.assert_allclose(float(m_e.loss), float(m_l.loss), rtol=1e-6)
    assert float(m_e.n_active) == N


def _poisoned_twin(algo, engine, topology, st, tr, dead):
    """A second trainer holding ``st`` with row ``dead`` of its params,
    momentum and buffer set to NaN."""
    twin = _trainer(algo, engine, topology)
    twin.init(1, PARAMS)
    view = tr.state_view(st)

    def poison(x):
        y = x.clone()
        if y.dim() >= 1 and y.shape[0] == N and y.is_floating_point():
            y[dead] = float("nan")
        return y
    pview = view._replace(
        params=tree_map(poison, view.params),
        opt_state=tree_map(poison, view.opt_state),
        buffer=None if view.buffer is None else tree_map(poison,
                                                         view.buffer),
        age=None if st.age is None else st.age.clone(),
        clock=None if st.clock is None else st.clock.clone())
    return twin, twin.state_from_view(pview)


@pytest.mark.parametrize("algo,engine,topology", [
    ("dpsgd", "flat", "random_pair"), ("dpsgd", "pytree", "random_pair"),
    ("adpsgd", "flat", "random_pair"), ("dpsgd", "flat", "ring"),
    ("dpsgd", "flat", "hierarchical")])
def test_crashed_row_frozen_and_nan_invariant(algo, engine, topology):
    tr = _trainer(algo, engine, topology)
    mem = Membership(N)
    st = tr.set_membership(tr.init(2, PARAMS), mem)
    st, _ = _run(tr, st, 2)
    mem.crash(3)
    st = tr.set_membership(st, mem)
    frozen = [x[3].clone() for x in _rows(tr, st)]
    twin, st_p = _poisoned_twin(algo, engine, topology, st, tr, 3)

    st, m = _run(tr, st, 3, start=2)
    st_p, m_p = _run(twin, st_p, 3, start=2)
    rows, rows_p = _rows(tr, st), _rows(twin, st_p)
    for x, want in zip(rows, frozen):
        assert torch.equal(x[3], want)              # bitwise frozen
    live = [0, 1, 2, 4]
    for a, b in zip(rows, rows_p):
        assert torch.equal(a[live], b[live])
        assert torch.isfinite(a[live]).all()
    for f in FIELDS:
        assert float(getattr(m, f)) == float(getattr(m_p, f)), f
    assert np.isfinite(float(m.loss)) and float(m.n_active) == N - 1


def test_set_membership_rejects_what_the_reference_rejects():
    tr = _trainer("ssgd", "pytree")
    with pytest.raises(ValueError, match="decentralized"):
        tr.set_membership(tr.init(6, PARAMS), Membership(N))
    tr = MultiLearnerTrainer(
        fcnet.loss_fn, optim.decentlam(0.1, momentum=0.9),
        AlgoConfig(algo="dpsgd", topology="ring", n_learners=N),
        device="cpu")
    with pytest.raises(ValueError, match="decentlam"):
        tr.set_membership(tr.init(6, PARAMS), Membership(N))
    tr = _trainer("dpsgd", "flat")
    with pytest.raises(ValueError, match="capacity"):
        tr.set_membership(tr.init(6, PARAMS), Membership(N + 1))


def test_bridge_snapshot_excludes_dead_rows():
    tr = _trainer("dpsgd", "flat")
    mem = Membership(N)
    st = tr.set_membership(tr.init(5, PARAMS), mem)
    st, _ = _run(tr, st, 2)
    mem.crash(2)
    st = tr.set_membership(st, mem)
    view = tr.state_view(st)
    st = tr.state_from_view(view._replace(params=tree_map(
        lambda x: torch.cat([x[:2], torch.full_like(x[2:3], 1e30), x[3:]]),
        view.params)))
    bridge = ConsensusBridge(tr)
    snap = bridge.snapshot(st)
    assert snap.n_active == N - 1
    live = [0, 1, 3, 4]
    for got, leaf in zip(tree_leaves(snap.params),
                         tree_leaves(tr.params_tree(st))):
        want = leaf[live].double().mean(0)
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert np.isfinite(bridge.staleness(st, snap)["consensus_dist_now"])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _mu(opt_state):
    while isinstance(opt_state, dict) and "mu" not in opt_state:
        opt_state = opt_state.get("inner")
    return None if not opt_state else opt_state["mu"]


def _port_from_reference(tr, jtr, jst, mem):
    """The port trainer's state holding the reference state ``jst``'s
    values (through ``state_from_view``), with ``mem`` set."""
    jview = jtr.state_view(jst)

    def to_torch(x):
        return tree_from_jax(jax.tree_util.tree_map(np.asarray, x))
    st = tr.init(0, PARAMS)
    view = tr.state_view(st)
    opt = view.opt_state
    if _mu(jview.opt_state) is not None:
        opt = {"mu": to_torch(_mu(jview.opt_state))}
    st = tr.state_from_view(view._replace(
        params=to_torch(jview.params), opt_state=opt,
        buffer=None if jview.buffer is None else to_torch(jview.buffer),
        age=None if jst.age is None else torch.tensor(np.asarray(jst.age)),
        clock=(None if jst.clock is None
               else torch.tensor(np.asarray(jst.clock)))))
    return tr.set_membership(st, mem)


def _assert_states_close(tr, st, jtr, jst, tol, what=""):
    view, jview = tr.state_view(st), jtr.state_view(jst)
    pairs = [(view.params, jview.params)]
    if _mu(jview.opt_state) is not None:
        pairs.append((_mu(view.opt_state), _mu(jview.opt_state)))
    if jview.buffer is not None:
        pairs.append((view.buffer, jview.buffer))
    for p, j in pairs:
        for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol,
                                       err_msg=what)
    for f in ("age", "clock"):
        if getattr(jst, f) is not None:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(jst, f)))


@pytest.mark.parametrize("algo,engine,mode", [
    ("dpsgd", "flat", "consensus"), ("dpsgd", "pytree", "consensus"),
    ("adpsgd", "flat", "consensus"), ("adpsgd", "flat", "quarantine")])
def test_admit_matches_reference(algo, engine, mode):
    jtr = _jax_trainer(algo, engine)
    jmem = JaxMembership(N)
    jst = jtr.set_membership(jtr.init(jax.random.PRNGKey(4), JAX_PARAMS),
                             jmem)
    for i in range(2):
        jst, _ = jtr.train_step(jst, JAX_LOADER.batch(i))
    jmem.crash(1)
    jst = jtr.set_membership(jst, jmem)
    for i in range(2, 4):
        jst, _ = jtr.train_step(jst, JAX_LOADER.batch(i))
    mem = Membership(N)
    mem.crash(1)
    tr = _trainer(algo, engine)
    st = _port_from_reference(tr, jtr, jst, mem)
    _assert_states_close(tr, st, jtr, jst, dict(rtol=0, atol=0),
                         "injected state")

    st = admit(tr, st, 1, mode=mode)
    jst = jax_admit(jtr, jst, 1, mode=mode)
    _assert_states_close(tr, st, jtr, jst,
                         dict(rtol=ADMIT_RTOL, atol=1e-8), f"admit {mode}")
    if mode == "consensus":
        act = np.array([True, False, True, True, True])
        for leaf in tree_leaves(tr.state_view(st).params):
            x = leaf.numpy()
            np.testing.assert_allclose(x[1], x[act].mean(0), rtol=1e-5,
                                       atol=1e-7)
    mem.rejoin(1)
    assert mem.incarnation[1] == 1
    st, m = _run(tr, tr.set_membership(st, mem), 2, start=4)
    assert np.isfinite(float(m.loss)) and float(m.n_active) == N


def _jax_member_rounds(jtr, jst):
    key = jax.random.fold_in(jst.rng, jst.step)
    k_mix, _ = jax.random.split(key)
    return [(np.array(p), np.array(c)) for p, c in
            jtr._member_rounds(jst.members, k_mix, jst.step)]


@pytest.mark.parametrize("algo,engine,topology,kw", [
    ("dpsgd", "flat", "random_pair", {}), ("dpsgd", "flat", "ring", {}),
    ("dpsgd", "flat", "ring", DESCEND_FIRST),
    ("dpsgd", "pytree", "random_pair", {}),
    ("adpsgd", "flat", "random_pair", {})])
def test_elastic_steps_match_reference(algo, engine, topology, kw):
    """A crash at step 1, a slow learner (AD-PSGD) and a dropped round at
    step 3: every step's state and metrics against the reference's.  A
    randomized matching is the reference's draw, injected; deterministic
    tables are the port's own ``reschedule``."""
    jtr = _jax_trainer(algo, engine, topology, **kw)
    tr = _trainer(algo, engine, topology, **kw)
    jmem, mem = JaxMembership(N), Membership(N)
    jst = jtr.set_membership(jtr.init(jax.random.PRNGKey(0), JAX_PARAMS),
                             jmem)
    st = tr.set_membership(tr.init(0, PARAMS), mem)
    for step in range(5):
        if step in (1, 3):
            for m in (jmem, mem):
                if step == 1:
                    m.crash(2)
                    if algo == "adpsgd":
                        m.set_slow(0, 2)
            jst = jtr.set_membership(jst, jmem, drop_round=step == 3)
            st = tr.set_membership(st, mem, drop_round=step == 3)
        rounds = (_jax_member_rounds(jtr, jst)
                  if jtr._schedule.randomized else None)
        st, m = tr.train_step(st, _batch(step), rounds)
        jst, jm = jtr.train_step(jst, JAX_LOADER.batch(step))
        what = f"{algo}/{engine}/{topology} step {step}"
        _assert_states_close(tr, st, jtr, jst, PARAM_TOL, what)
        for f in FIELDS:
            np.testing.assert_allclose(float(getattr(m, f)),
                                       float(getattr(jm, f)),
                                       rtol=METRIC_RTOL, atol=1e-12,
                                       err_msg=f"{what} {f}")
