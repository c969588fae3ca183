"""``repro_torch.obs``: spans and counters switched by the torch profiler.

Off (no profiler): one shared null context, nothing recorded.  On: each
span is a host event in the profiler's timeline (not a user annotation,
which the profiler would copy onto the device's timeline), nested under
its enclosing span, with its calls and host seconds tallied; counters add
up.  A DPSGD step on the flat engine and a ``ServeEngine`` step compute
the same bits with the profiler on as off, and record the spans the
benchmark reads; the step's backward ops carry the ``sequence_nr`` of a
forward op inside the span whose backward they are.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import n_periods, period_spec  # noqa
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N, B, S = 2, 2, 16


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _span_events(prof):
    return [e for e in prof.events() if e.name in obs.SPANS]


def test_off_path_is_one_shared_null_context_and_records_nothing():
    a, b = obs.span("train.step"), obs.span("model.attn")
    assert a is b
    with a:
        obs.count("serve.tokens", 5)
    assert obs.counts() == {} and obs.span_times() == {}
    with obs.span("no.such.span"):      # unchecked while off
        pass


def test_on_path_nests_span_events_and_counts_cumulatively():
    with _recording() as prof:
        with obs.span("serve.step"):
            with obs.span("serve.admit"):
                obs.count("serve.tokens", 2)
            with obs.span("serve.finish"):
                obs.count("serve.tokens", 3)
                obs.count("serve.slot_steps")
        with pytest.raises(ValueError):
            obs.span("no.such.span")
        with pytest.raises(ValueError):
            obs.count("no.such.counter")
    got = {e.name: e for e in _span_events(prof)}
    assert set(got) == {"serve.step", "serve.admit", "serve.finish"}
    assert not any(e.is_user_annotation for e in got.values())
    assert got["serve.admit"].cpu_parent.name == "serve.step"
    assert got["serve.finish"].cpu_parent.name == "serve.step"
    assert obs.counts() == {"serve.tokens": 5, "serve.slot_steps": 1}
    with _recording():
        obs.count("serve.tokens", 4)
        with obs.span("serve.admit"):
            pass
    assert obs.counts()["serve.tokens"] == 9
    t = obs.span_times()
    assert {k: v["calls"] for k, v in t.items()} == {
        "serve.step": 1, "serve.admit": 2, "serve.finish": 1}
    assert t["serve.step"]["host_s"] >= t["serve.finish"]["host_s"] > 0


def test_every_span_is_a_plain_host_event_with_its_ops_inside():
    x = torch.randn(4, 4)
    with _recording() as prof:
        for name in obs.SPANS:
            with obs.span(name):
                torch.mm(x, x)
    ev = {e.name: e for e in _span_events(prof)}
    assert set(ev) == set(obs.SPANS)
    assert not any(e.is_user_annotation for e in ev.values())
    mm = [e.cpu_parent.name for e in prof.events() if e.name == "aten::mm"]
    assert mm == list(obs.SPANS)
    assert {v["calls"] for v in obs.span_times().values()} == {1}


def test_a_span_closes_on_an_exception_and_lets_it_through():
    with _recording() as prof:
        with pytest.raises(RuntimeError, match="inside"):
            with obs.span("serve.finish"):
                raise RuntimeError("inside")
        with obs.span("serve.step"):
            pass
    got = {e.name: e for e in _span_events(prof)}
    assert got["serve.step"].cpu_parent is None
    assert obs.span_times()["serve.finish"]["calls"] == 1


def _dpsgd():
    cfg = get_config("transformer-100m").smoke_config()
    api = build_model(cfg, device="cpu")
    opt = optim.sgd(0.5, momentum=0.9)
    tr = MultiLearnerTrainer(api.loss_fn, opt,
                             AlgoConfig(algo="dpsgd", topology="random_pair",
                                        n_learners=N),
                             params_from_tree=api.params_from_tree,
                             engine="flat", device="cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (N, B, S + 1), generator=gen)
    batch = {"tokens": toks[..., :-1].contiguous(),
             "labels": toks[..., 1:].contiguous(),
             "mask": torch.ones(N, B, S)}
    partners = torch.tensor([[1, 0]], dtype=torch.int32)
    coefs = torch.full((N, 2), 0.5)
    return cfg, api, tr, batch, [(partners, coefs)]


def test_flat_dpsgd_step_is_bitwise_the_same_under_the_profiler():
    cfg, api, tr, batch, rounds = _dpsgd()
    tree = api.param_tree(api.init(0))
    runs = []
    for on in (False, True):
        state = tr.init(0, tree)
        if on:
            with _recording() as prof:
                state, m = tr.train_step(state, batch, rounds=rounds)
        else:
            state, m = tr.train_step(state, batch, rounds=rounds)
        runs.append((m.loss.clone(), state.params.clone(),
                     tr.state_view(state).opt_state["mu"]))
    (l0, w0, mu0), (l1, w1, mu1) = runs
    assert torch.equal(l0, l1) and torch.equal(w0, w1)
    for a, b in zip(tree_leaves(mu0), tree_leaves(mu1), strict=True):
        assert torch.equal(a, b)
    calls = {}
    for e in _span_events(prof):
        calls[e.name] = calls.get(e.name, 0) + 1
    layers = cfg.n_layers
    assert calls["model.attn"] == calls["model.mlp"] == N * layers
    assert calls["train.update"] == calls["train.stats"] == 1
    assert calls["train.step"] == calls["train.grads"] == 1
    assert calls["train.backward"] == calls["model.head"] == N
    assert calls["model.embed"] == N
    times = obs.span_times()
    assert {k: v["calls"] for k, v in times.items()} == calls


def _under(e, name):
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


@pytest.mark.parametrize("name", ("model.attn", "model.mlp", "model.head"))
def test_backward_ops_link_by_sequence_nr_to_their_spans_forward(name):
    """The profiler trace's own link from a backward node to its forward
    op, which a reader of the trace follows to ``<span>.bwd``: every
    span's forward ops have backward nodes, which run inside the learner's
    ``train.backward`` and outside the span."""
    cfg, api, tr, batch, rounds = _dpsgd()
    state = tr.init(0, api.param_tree(api.init(0)))
    with _recording() as prof:
        tr.train_step(state, batch, rounds=rounds)
    ev = prof.events()
    evaluate = "autograd::engine::evaluate_function"
    fwd = {(e.thread, e.sequence_nr) for e in ev
           if e.sequence_nr >= 0 and not e.name.startswith(evaluate)
           and _under(e, name)}
    bwd = [e for e in ev if e.name.startswith(evaluate)
           and (e.fwd_thread, e.sequence_nr) in fwd]
    assert fwd and bwd
    calls = sum(e.name == name for e in ev)
    assert calls == (N * cfg.n_layers if name != "model.head" else N)
    assert not any(_under(e, name) for e in bwd)
    assert all(_under(e, "train.backward") for e in bwd)


def test_serve_step_records_each_engine_span_once_and_counts_tokens():
    cfg = get_config("jamba-v0.1-52b").smoke_config()
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    eng = ServeEngine(api, params, n_slots=2, page_size=8, max_len=32)
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(0, cfg.vocab, 3).tolist(), 4)
    eng.submit(rng.integers(0, cfg.vocab, 1).tolist(), 4)
    eng.step()
    eng.step()                               # the second request decodes
    before = eng.generated_total
    with _recording() as prof:
        eng.step()
    names = [e.name for e in _span_events(prof)]
    for s in ("serve.step", "serve.admit", "serve.prepare", "serve.model",
              "serve.readback", "serve.finish", "model.embed",
              "model.head"):
        assert names.count(s) == 1, s
    kinds, periods = period_spec(cfg), n_periods(cfg)
    for name, n in (("model.moe", sum(m == "moe" for _, m in kinds)),
                    ("model.mamba", sum(m == "mamba" for m, _ in kinds)),
                    ("model.attn", sum(m == "attn" for m, _ in kinds))):
        assert n and names.count(name) == n * periods, name
    c = obs.counts()
    assert c["serve.tokens"] == eng.generated_total - before > 0
    assert c["serve.slot_steps"] == 2
