"""The per-layer metrics that read the program's own spans and counters
(``portbench/spans.py``, ``repro_torch.obs``): each reads its spans a
step of the record's profiled stretch, and reads None from a program that
keeps none or whose tallies are not the stretch's alone; and the trace's
split of device time by span (``spans.reduce``)."""
from __future__ import annotations

import sys
import types

import pytest

READERS = ("host_serial_ms.serve", "decode_share.serve")


def _t(calls, host_s):
    return {"calls": calls, "host_s": host_s}


TIMES = {"serve.step": _t(4, 0.12), "serve.admit": _t(4, 0.001),
         "serve.prepare": _t(4, 0.002), "serve.finish": _t(4, 0.005),
         "serve.model": _t(4, 0.1)}
COUNTS = {"serve.slot_steps": 1000, "serve.tokens": 640}
WANT = {"host_serial_ms.serve": (2.0, "ms"),
        "decode_share.serve": (64.0, "%")}
REC = {"kind": "serve", "prof_steps": 4}


def _obs(times, counts):
    return types.SimpleNamespace(span_times=lambda: times,
                                 counts=lambda: dict(counts))


@pytest.fixture
def fake_obs(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs", _obs(TIMES, COUNTS))


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_spans_a_step(name, fake_obs):
    from portbench import spec
    value, unit = spec.metric(name).read(dict(REC))
    assert value == pytest.approx(WANT[name][0], rel=1e-12)
    assert unit == WANT[name][1]
    assert spec.metric(name).read(dict(REC, kind="train")) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_from_a_program_without_spans(name, monkeypatch):
    from portbench import spec
    monkeypatch.delitem(sys.modules, "repro_torch.obs", raising=False)
    assert spec.metric(name).read(dict(REC)) is None
    old = types.SimpleNamespace(counts=lambda: dict(COUNTS))
    monkeypatch.setitem(sys.modules, "repro_torch.obs", old)
    assert spec.metric(name).read(dict(REC)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_where_the_tallies_are_not_the_stretchs(
        name, fake_obs):
    """Steps tallied outside the record's stretch (a profiler on during
    set-up too) leave the program's step count off ``prof_steps``."""
    from portbench import spec
    assert spec.metric(name).read(dict(REC, prof_steps=3)) is None
    assert spec.metric(name).read({"kind": "serve"}) is None


def test_reader_reads_none_where_no_span_of_its_was_tallied(monkeypatch):
    from portbench import spec
    bare = _obs({"serve.step": _t(4, 0.1)}, {})
    monkeypatch.setitem(sys.modules, "repro_torch.obs", bare)
    for name in READERS:
        assert spec.metric(name).read(dict(REC)) is None


def test_readers_read_the_programs_own_tallies():
    """The real ``repro_torch.obs`` on the CPU: spans opened under the
    profiler, counters; a step is a ``serve.step`` call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import spec
    from repro_torch import obs
    obs.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                with obs.span("serve.step"):
                    with obs.span("serve.finish"):
                        torch.randn(64, 64).sum()
            obs.count("serve.slot_steps", 4)
            obs.count("serve.tokens", 3)
        t = obs.span_times()
        rec = {"kind": "serve", "prof_steps": 2}
        value, unit = spec.metric("host_serial_ms.serve").read(rec)
        assert unit == "ms"
        assert value == pytest.approx(t["serve.finish"]["host_s"] * 1e3 / 2)
        assert spec.metric("decode_share.serve").read(rec) == (75.0, "%")
    finally:
        obs.reset()


class _Ev:
    """A stand-in for the profiler's ``FunctionEvent``."""

    def __init__(self, name, start, end, *, dev=False, id=0, thread=1,
                 parent=None, seq=-1, fwd_thread=0, annotation=False):
        from torch.autograd import DeviceType
        self.name, self.id, self.thread = name, id, thread
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.cpu_parent, self.sequence_nr = parent, seq
        self.fwd_thread, self.is_user_annotation = fwd_thread, annotation


def _trace():
    step = _Ev("train.step", 0, 100)
    attn = _Ev("model.attn", 0, 30, parent=step)
    mm1 = _Ev("aten::mm", 1, 10, parent=attn, seq=5)
    mlp = _Ev("model.mlp", 30, 60, parent=step)
    mm2 = _Ev("aten::mm", 31, 40, parent=mlp, seq=6)
    back = _Ev("train.backward", 60, 100, parent=step)
    ev1 = _Ev("autograd::engine::evaluate_function: MmBackward0", 61, 70,
              thread=2, seq=5, fwd_thread=1)
    mm3 = _Ev("aten::mm", 62, 69, thread=2, parent=ev1)
    ev2 = _Ev("autograd::engine::evaluate_function: "
              "torch::autograd::AccumulateGrad", 71, 75, thread=2)
    host = [step, attn, mm1, mlp, mm2, back, ev1, mm3, ev2,
            _Ev("cudaLaunchKernel", 2, 3, id=101, parent=mm1),
            _Ev("cudaLaunchKernel", 32, 33, id=102, parent=mm2),
            _Ev("cudaLaunchKernel", 63, 64, id=103, thread=2, parent=mm3),
            _Ev("cudaLaunchKernel", 72, 73, id=104, thread=2, parent=ev2)]
    dev = [_Ev("gemm", 5, 15, dev=True, id=101),
           _Ev("gemm", 35, 45, dev=True, id=102),
           _Ev("gemm", 65, 80, dev=True, id=103),
           _Ev("accumulate", 81, 83, dev=True, id=104),
           _Ev("orphan", 90, 92, dev=True, id=105),
           _Ev("model.attn", 5, 15, dev=True, id=1, annotation=True)]
    return host + dev


def test_trace_split_by_span_backward_fallback_and_none():
    from portbench import spans
    from repro_torch.obs import SPANS
    got = spans.reduce(_trace(), SPANS)
    us = 1e-6

    def self_(k):
        return got[k]["self_device_s"] / us
    assert self_("model.attn") == pytest.approx(10)        # innermost
    assert self_("model.attn.bwd") == pytest.approx(15)    # sequence_nr
    assert self_("model.mlp") == pytest.approx(10)
    assert self_("train.backward") == pytest.approx(2)     # main thread
    assert self_("(none)") == pytest.approx(2)             # no launch
    assert "model.mlp.bwd" not in got
    assert got["train.step"]["device_s"] / us == pytest.approx(22)
    assert got["train.step"]["self_device_s"] == 0.0
    assert got["train.step.bwd"]["device_s"] / us == pytest.approx(15)
    busy = sum(v["self_device_s"] for v in got.values()) / us
    assert busy == pytest.approx(10 + 10 + 15 + 2 + 2)     # each once
    idle = {k: v["idle_s"] / us for k, v in got.items() if v["idle_s"]}
    assert idle == pytest.approx({"model.attn": 20, "model.mlp": 20,
                                  "train.backward": 8})
    assert got["model.attn"]["calls"] == 1
    assert got["model.attn.bwd"]["kernels"] == pytest.approx({"gemm": 15e-6})
    assert got["(none)"]["kernels"] == pytest.approx({"orphan": 2e-6})
    assert got["train.step"]["host_s"] / us == pytest.approx(100)
