"""The port's twins of ``examples/serve_batched.py``,
``examples/train_100m.py`` and ``examples/paper_mnist_repro.py``
(``repro_torch.serve_batched``, ``repro_torch.train_100m``,
``repro_torch.paper_mnist_repro``), run on the CPU.

  * ``serve_batched`` at its defaults: the reference example's requests
    (the same seeded prompt lengths), every token counted;
  * ``train_100m --preset smoke``: a run that checkpoints, a second run
    that resumes from the newest checkpoint and ends, to rounding, where
    an uninterrupted run ends, a finite held-out loss, and a checkpoint that
    the reference's ``repro.checkpoint.restore_checkpoint`` reads back
    with the reference example's own template;
  * ``paper_mnist_repro`` cut to 20 steps: the reference example's CSV
    header, a row every 10 steps for each of SSGD, SSGD* and DPSGD, finite
    fields and a test accuracy in [0, 1].
"""
import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro_torch import paper_mnist_repro, serve_batched, \
    train_100m  # noqa: E402


def test_serve_batched_at_its_defaults(capsys):
    out = serve_batched.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "slots=4" in text and "requests=8" in text
    assert "256 tokens" in text and "tok/s aggregate" in text
    # 8 requests x 32 new tokens, every one counted (the first included)
    assert out["requests"] == 8 and out["tokens"] == 256
    assert [len(g) for g in out["generated"]] == [32] * 8
    # the reference example's requests: prompt lengths from the same rng
    rng = np.random.default_rng(0)
    lengths = []
    for _ in range(8):
        n = int(rng.integers(1, 64 - 32 + 1))
        rng.integers(1, 512, n)
        lengths.append(n)
    # two waves of 4 slots: each request takes prompt + 32 - 1 steps
    # after the one that admits it, so the run is bounded by its longest
    assert out["steps"] >= max(lengths) + 31
    assert np.isfinite(out["ms_per_step"]) and out["tokens_per_s"] > 0


def _run(d, steps, every=2):
    return train_100m.main(["--device", "cpu", "--preset", "smoke",
                            "--steps", str(steps), "--ckpt-dir", str(d),
                            "--ckpt-every", str(every)])


def _reference_template():
    """The reference example's checkpoint tree for the smoke preset."""
    from repro.configs import get_config
    from repro.core import AlgoConfig, MultiLearnerTrainer
    from repro.models import build_model
    from repro.optim import scale_by_schedule, sgd, warmup_linear_scale
    api = build_model(get_config("transformer-100m").smoke_config())
    opt = scale_by_schedule(sgd(0.5, momentum=0.9),
                            warmup_linear_scale(10, 1.0))
    tr = MultiLearnerTrainer(api.loss_fn, opt, AlgoConfig(
        algo="dpsgd", topology="random_pair", n_learners=4))
    key = jax.random.PRNGKey(0)
    view = tr.state_view(tr.init(key, api.init(key)))
    return {"params": view.params, "opt": view.opt_state}


def test_train_100m_checkpoints_resumes_and_evaluates(tmp_path, capsys):
    first = _run(tmp_path / "a", 3)
    assert first["resumed_from"] is None and first["steps"] == 3
    assert all(np.isfinite(first["losses"]))
    resumed = _run(tmp_path / "a", 4)
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed["resumed_from"] == 3 and resumed["steps"] == 1
    assert np.isfinite(resumed["heldout"])
    straight = _run(tmp_path / "b", 4, every=0)
    assert straight["losses"][:3] == first["losses"]
    assert straight["losses"][3:] == resumed["losses"]
    # the resumed run ends where the uninterrupted one does, to rounding:
    # the resumed step's sums do not run bitwise as the straight run's
    # (~4e-7 relative, the tier below holds 25x that)
    a, b = np.load(resumed["checkpoint"]), np.load(straight["checkpoint"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if not k.startswith("__"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # the reference reads the twin's file with its own example's template
    tree, step = jax_ckpt.restore_checkpoint(str(tmp_path / "a"),
                                             _reference_template())
    assert step == 4
    leaves = jax.tree_util.tree_leaves(tree)
    assert leaves and all(np.isfinite(np.asarray(x)).all() for x in leaves)


def _reference_header():
    """The header row the reference example writes (read from its
    source: running it imports nothing needed here)."""
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "examples"
           / "paper_mnist_repro.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "writerow"):
            return ast.literal_eval(node.args[0])
    raise AssertionError("no header row in the reference example")


def test_paper_mnist_repro_at_20_steps(tmp_path, capsys):
    out_csv = tmp_path / "fig2.csv"
    out = paper_mnist_repro.main(["--device", "cpu", "--steps", "20",
                                  "--out", str(out_csv)])
    assert "wrote" in capsys.readouterr().out
    with open(out_csv, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == _reference_header() == paper_mnist_repro.HEADER
    assert [r[:2] for r in rows[1:]] == [
        [a, s] for a in ("ssgd", "ssgd_star", "dpsgd") for s in ("0", "10")]
    for r in rows[1:]:
        vals = [float(x) for x in r[2:]]
        assert all(np.isfinite(vals)), r
        assert 0.0 <= vals[-1] <= 1.0
    assert set(out) == {"ssgd", "ssgd_star", "dpsgd"}
    # SSGD has one model: no weight variance; DPSGD's learners spread
    assert all(r[4] == 0.0 for r in out["ssgd"])
    assert out["dpsgd"][0][4] > 0.0
