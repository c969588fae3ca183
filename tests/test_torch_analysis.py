"""The port's static invariant auditor (``repro_torch.analysis``, DESIGN
§16) against the reference's (``repro.analysis``).

  * held against the reference: the rule catalog (the same names), the AST
    lint's findings on the seeded fixture tree and on the repo tree
    (finding for finding), ``max_concat_elems`` on the same seeded
    concatenate, ``live_slots`` of every compiled topology at n = 4 and 8;
  * each traced rule: one seeded violation that fires and one clean case
    that passes;
  * the trace sentinel: the reference's clean, strict, collect,
    no-masking and rejection cases, plus a kernel launch and a library
    load inside a window;
  * the audit targets on the CPU: the trainer and the serve engine give no
    finding; the launch step in one spawn of 4 gloo ranks on a (2, 2)
    mesh gives none, and in the same spawn a seeded extra send fires
    ``collective-count`` on every rank;
  * the CLI's exit codes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import load_all_rules as jax_load_all_rules  # noqa: E402
from repro.analysis.jaxpr_audit import \
    max_concat_elems as jax_max_concat_elems  # noqa: E402
from repro.analysis.lint import lint_root as jax_lint_root  # noqa: E402
from repro.analysis.targets import live_slots as jax_live_slots  # noqa: E402
from repro.core.schedule import make_schedule as jax_make_schedule  # noqa: E402
from repro_torch import cuda_build  # noqa: E402
from repro_torch.analysis import (RULES, Finding, format_findings,  # noqa: E402
                                  lint_root, load_all_rules)
from repro_torch.analysis import run as cli  # noqa: E402
from repro_torch.analysis.retrace import (RetraceError,  # noqa: E402
                                          TraceSentinel, no_retrace,
                                          trace_count, watch)
from repro_torch.analysis.targets import (audit_launch,  # noqa: E402
                                          audit_serve, audit_trainer,
                                          live_slots, rank_sends)
from repro_torch.analysis.trace_audit import (StepTrace,  # noqa: E402
                                              aliased_param_bytes,
                                              collective_count, count_op,
                                              donation_honored,
                                              fresh_outputs,
                                              max_concat_elems,
                                              no_host_callback,
                                              no_param_concat, storage_ptrs,
                                              wire_dtype)
from repro_torch.core.schedule import (SCHEDULED_TOPOLOGIES,  # noqa: E402
                                       make_schedule)
from repro_torch.kernels import gossip_mix  # noqa: E402

FIXTURE = cli.REPO_ROOT / "tests" / "fixtures" / "lint_violations"


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

def test_rule_catalog_has_the_reference_rule_names():
    port, ref = load_all_rules(), jax_load_all_rules()
    assert sorted(port) == sorted(ref)
    assert all(port.values())        # every rule carries a contract line


def test_duplicate_rule_name_raises():
    from repro_torch.analysis.report import rule

    @rule("dup-test-rule", "contract A")
    def a():
        return []

    with pytest.raises(ValueError):
        @rule("dup-test-rule", "contract B")
        def b():
            return []

    @rule("dup-test-rule", "contract A")      # same contract: fine
    def c():
        return []
    RULES.pop("dup-test-rule")


def test_format_findings():
    f = Finding("some-rule", "file.py:3", "boom")
    assert str(f) == "file.py:3: [some-rule] boom"
    assert format_findings([f, f]).endswith("2 finding(s)")


@pytest.mark.parametrize("root", ["fixture", "repo"])
def test_lint_gives_the_reference_findings(root):
    path = FIXTURE if root == "fixture" else cli.REPO_ROOT
    port = [(f.rule, f.where, f.message) for f in lint_root(path)]
    ref = [(f.rule, f.where, f.message) for f in jax_lint_root(path)]
    assert port == ref
    if root == "fixture":
        assert {r for r, _, _ in port} == set(cli.AST_RULES)
    else:
        assert port == [], format_findings(lint_root(path))


def test_max_concat_elems_matches_the_reference():
    with StepTrace() as t:
        torch.cat([torch.ones(600), torch.ones(600)])
    j = jax.make_jaxpr(lambda a, b: jnp.concatenate([a, b]))(
        jnp.ones(600), jnp.ones(600))
    assert max_concat_elems(t) == jax_max_concat_elems(j) == 1200
    with StepTrace() as empty:
        pass
    assert empty.ops == [] and max_concat_elems(empty) == 0


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("topo", SCHEDULED_TOPOLOGIES)
def test_live_slots_match_the_reference(topo, n):
    port, ref = make_schedule(topo, n), jax_make_schedule(topo, n)
    assert live_slots(port) == jax_live_slots(ref)
    # every live slot of a round costs its ranks one send each, once
    tables = [(port.partners[r], port.coefs[r]) for r in range(port.period)]
    assert sum(rank_sends(tables, r) for r in range(n)) >= live_slots(port)


# ---------------------------------------------------------------------------
# each traced rule: a seeded violation fires, a clean case passes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def send_traces():
    """Two ranks that exchange one row (one live slot) and then send once
    more, on two threads: the traces of both."""
    return cli._extra_send_traces()


def _concat(n):
    with StepTrace() as t:
        torch.cat([torch.ones(n // 2), torch.ones(n - n // 2)])
    return no_param_concat(t, bound=1000, target="t")


def _host(read):
    x = torch.ones(4)
    with StepTrace() as t:
        y = torch.sin(x) + 1
        if read:
            y.sum().item()
    return no_host_callback(t, target="t")


def _donation(kind):
    store = torch.zeros(1000)
    owned = storage_ptrs([store])
    kept = []
    with StepTrace(watch_bytes=4000) as t:
        if kind == "clone":
            new = store.clone().add_(1.0)
        else:
            new = store.add_(1.0)
            if kind == "kept":         # writes in place, keeps a copy
                kept.append(store * 2)
    return donation_honored(t, [new], owned, min_bytes=4000, target="t")


CASES = {
    "no-param-concat": (lambda tr: _concat(1200), lambda tr: _concat(7)),
    "no-host-callback": (lambda tr: _host(True), lambda tr: _host(False)),
    "collective-count": (
        lambda tr: collective_count(tr[0], expected=1, target="t"),
        lambda tr: collective_count(tr[0], expected=2, target="t")),
    "wire-dtype": (
        lambda tr: wire_dtype(tr[1], expected=torch.bfloat16, target="t"),
        lambda tr: wire_dtype(tr[1], expected=torch.float32, target="t")),
    "donation-honored": (lambda tr: _donation("clone"),
                         lambda tr: _donation("in_place")),
}


@pytest.mark.parametrize("case", ["violation", "clean"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_traced_rule(name, case, send_traces):
    violation, clean = CASES[name]
    got = (violation if case == "violation" else clean)(send_traces)
    if case == "clean":
        assert got == []
    else:
        assert got and {f.rule for f in got} == {name}


def test_collective_count_reads_the_dispatched_sends(send_traces):
    for t in send_traces:
        assert count_op(t, "c10d.send") == 2
        assert count_op(t, "c10d.recv_") == 2
        sends = [o for o in t.ops if o.packet == "c10d.send"]
        assert all(o.wire == (("float32", 256),) for o in sends)


def test_donation_flags_a_kept_fresh_buffer_and_counts_aliased_bytes():
    fs = _donation("kept")
    assert len(fs) == 1 and "outlives the step" in fs[0].message
    a, b = torch.zeros(10), torch.zeros(5)
    assert aliased_param_bytes([a, b[1:]], storage_ptrs([b])) == 16


def test_fresh_outputs_count_temporaries_and_a_kept_view_keeps_a_finding():
    """Every fresh state-sized output is counted, temporaries included;
    the finding is by storage: a kept view of a fresh buffer keeps it."""
    store = torch.zeros(1000)
    owned = storage_ptrs([store])
    kept = []
    with StepTrace(watch_bytes=4000) as t:
        tmp = store * 2                 # a temporary the step frees
        store.add_(tmp)
        del tmp
        kept.append((store + 1)[::2])   # a view of a fresh buffer outlives
    assert fresh_outputs(t) == {"count": 2, "bytes": 8000,
                                "by_op": {"aten.mul.Tensor": 1,
                                          "aten.add.Tensor": 1}}
    fs = donation_honored(t, [store], owned, min_bytes=4000, target="t")
    assert len(fs) == 1 and "aten.add.Tensor" in fs[0].message
    kept.clear()
    assert donation_honored(t, [store], owned, min_bytes=4000,
                            target="t") == []


def test_host_read_counts_only_the_step_device():
    """On the card a read of a host tensor is no device sync: a trace for
    a CUDA step flags only reads of CUDA tensors (none here)."""
    with StepTrace("cuda") as t:
        torch.ones(3).sum().item()
    assert no_host_callback(t, target="t") == []
    with StepTrace("cpu") as t:
        torch.ones(3).sum().item()
    assert no_host_callback(t, target="t")


# ---------------------------------------------------------------------------
# the trace sentinel (tests/test_analysis.py's cases)
# ---------------------------------------------------------------------------

def _doubler():
    f = watch(lambda x: x * 2)
    f(torch.ones(3))
    return f


def test_sentinel_clean_window():
    f = _doubler()
    with TraceSentinel(f, strict=True) as s:
        f(torch.ones(3) + 5)                # same shape: operand change only
    assert s.findings == [] and trace_count(f) == 1


def test_sentinel_catches_retrace_strict():
    f = _doubler()
    with pytest.raises(RetraceError):
        with TraceSentinel(f):
            f(torch.ones(4))                # new shape: a retrace


def test_sentinel_collect_mode_and_labels():
    f = _doubler()
    with TraceSentinel(f, strict=False, labels=["hot-step"]) as s:
        f(torch.ones((2, 2)))
    assert len(s.findings) == 1
    assert s.findings[0].rule == "no-retrace"
    assert s.findings[0].where == "hot-step"
    assert trace_count(f) == 2


def test_sentinel_does_not_mask_exceptions():
    f = _doubler()
    with pytest.raises(RuntimeError, match="real failure"):
        with TraceSentinel(f):
            f(torch.ones(4))                # changes the trace, AND ...
            raise RuntimeError("real failure")


def test_sentinel_rejects_unwatched_and_bad_labels():
    with pytest.raises(TypeError):
        trace_count(lambda x: x)
    with pytest.raises(TypeError):
        TraceSentinel(lambda x: x)
    f = watch(lambda x: x)
    with pytest.raises(ValueError):
        TraceSentinel(f, labels=["a", "b"])
    with pytest.raises(ValueError):
        TraceSentinel()


def test_no_retrace_rule_wrapper():
    f = _doubler()
    assert no_retrace(lambda: f(torch.ones(3)), f) == []
    fs = no_retrace(lambda: f(torch.ones(5)), f)
    assert fs and fs[0].rule == "no-retrace"


def test_sentinel_sees_kernel_launches_and_library_loads(monkeypatch):
    """A call that launches a hand kernel the warm call did not, or a
    kernel library loaded inside the window, is a retrace."""
    kernel = gossip_mix.gossip_mix_update_flat
    launch = {"on": False}

    def step(x):
        if launch["on"]:
            kernel.launches += 1
        return x + 1

    f = watch(step)
    f(torch.ones(2))
    launch["on"] = True
    fs = no_retrace(lambda: f(torch.ones(2)), f)
    assert fs and "kernel launches" in fs[0].message
    launch["on"] = False
    f(torch.ones(2))
    monkeypatch.setitem(cuda_build._loaded, "stand-in.cu", object())
    g = watch(lambda x: x + 1)
    g(torch.ones(2))
    loaded = dict(cuda_build._loaded)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with TraceSentinel(g, strict=False) as s:
        g(torch.ones(2))
        cuda_build._loaded.update(loaded)    # a library loaded inside it
    assert len(s.findings) == 1 and "library" in s.findings[0].message


def test_a_first_call_inside_the_window_is_a_trace():
    f = watch(lambda x: x - 1)
    with TraceSentinel(f, strict=False) as s:
        f(torch.ones(2))
    assert s.findings and "first traced" in s.findings[0].message


# ---------------------------------------------------------------------------
# the audit targets on the CPU
# ---------------------------------------------------------------------------

def test_audit_trainer_is_clean():
    assert audit_trainer(device="cpu") == []


def test_audit_serve_is_clean():
    assert audit_serve(device="cpu") == []


@pytest.fixture(scope="module")
def launch_findings():
    return audit_launch(shape=(2, 2), device="cpu", seeded=True)


def test_audit_launch_is_clean(launch_findings):
    clean = [f for f in launch_findings if "seeded" not in f.where]
    assert clean == [], format_findings(clean)


def test_audit_launch_flags_a_seeded_extra_send(launch_findings):
    seeded = [f for f in launch_findings if "seeded" in f.where]
    assert {f.where.split("@")[1].split("[")[0] for f in seeded} == {
        f"rank{r}" for r in range(4)}
    assert {f.rule for f in seeded} == {"collective-count"}
    assert all("2 'c10d.send' ops" in f.message for f in seeded)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_fixture_root_exits_nonzero(capsys):
    assert cli.main(["--root", str(FIXTURE)]) == 1
    assert "finding(s)" in capsys.readouterr().out


def test_cli_ast_only_clean(capsys):
    assert cli.main(["--ast-only"]) == 0
    assert "AST pass clean" in capsys.readouterr().out


def test_cli_selftest(capsys):
    assert cli.main(["--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rules bite" in out and str(len(load_all_rules())) in out


def test_cli_default_device_is_the_card(capsys):
    """With no card the default device raises: the auditor is broken (2),
    never clean."""
    want = 0 if torch.cuda.is_available() else 2
    assert cli.main(["--selftest"]) == want
