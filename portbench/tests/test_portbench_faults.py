"""The rest of a run, the look for a card skipped, on tiny cells on the
CPU: a sound run comes out correct, and with the timed path broken
underneath (``faults.py``) ``correct`` comes out false, once for each
fault the cell can have."""
from __future__ import annotations

import pytest

SEED = 2 ** 31 + 977


def _run(name, seconds=0.5, trace=False):
    from portbench import run
    return run.execute(name, SEED, seconds, trace, device="cpu")


def test_sound_training_run_is_correct(tiny_root):
    out = _run("tiny.train")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(out["checks"]) == ["loss_gap", "grad_gap", "delta_gap"]


def test_sound_serving_run_is_correct(tiny_root):
    out = _run("tiny.serve")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_tokens_per_s", "itl_ms_p95",
                                   "ttft_ms_p95", "setup_s"}
    assert out["_readings"]["served_gap_max"] == 0.0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "no_exchange"])
def test_training_fault_is_caught(tiny_root, fault):
    from portbench import faults
    with faults.TRAIN[fault]():
        out = _run("tiny.train")
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", ["token", "frozen"])
def test_serving_fault_is_caught(tiny_root, fault):
    from portbench import faults
    with faults.SERVE[fault]():
        out = _run("tiny.serve")
    assert not out["correct"], (fault, out["checks"])


def test_traced_run_reports_per_layer_metrics_only(tiny_root):
    out = _run("tiny.train", trace=True)
    assert out["correct"]
    assert {"step_mfu.train", "launches_per_step.train",
            "device_idle.train"} <= set(out["metrics"])
    assert "train_tokens_per_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
