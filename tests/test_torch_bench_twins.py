"""A smoke run of each of the port's paper-experiment twins on the CPU
(``python -m repro_torch.bench.<name> --device cpu --smoke``): each prints
its CSV rows and its summary row ``name,us_per_call,derived``, and the
qualitative result its reference script reports holds at the smoke size.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, capsys):
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    out = mod.main(["--device", "cpu", "--smoke"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = lines[-1].split(",", 2)
    assert summary[0] == name and int(summary[1]) >= 0 and summary[2]
    return out, lines


def test_fig2_twin(capsys):
    from repro_torch.bench.common import final_loss
    out, lines = _run("fig2_effective_lr", capsys)
    assert lines[0].startswith("algo,step,loss,alpha_e,sigma_w_sq")
    final = {a: final_loss(r["losses"]) for a, r in out["runs"].items()}
    # Fig. 2a at lr 0.5: SSGD fails, DPSGD converges
    assert final["dpsgd"] < 0.05 < 1.0 < final["ssgd"]
    assert all(math.isfinite(v) for v in out["sweep"].values())
    # the diagnostics and the probes ran every 10 steps on all three
    for r in out["runs"].values():
        assert [s for s, _ in r["diags"]] == [10, 20, 30]
        assert [s for s, _ in r["probes"]] == [0, 10, 20, 30]
    assert math.isfinite(out["eq4"])


def test_ablation_twin(capsys):
    rows, lines = _run("ablation_topology", capsys)
    assert lines[0] == ("topology,K,period,rounds_per_step,fused,gap_bound,"
                        "measured_gap,final_loss,consensus_dist")
    assert [r["topology"] for r in rows] == [
        "full", "ring", "torus", "random_pair", "solo", "hierarchical",
        "exp", "one_peer_exp", "random_matching"]
    d = {r["topology"]: r for r in rows}
    assert d["solo"]["fused"] == 0 and d["solo"]["rounds_per_step"] == 0
    assert d["random_matching"]["rounds_per_step"] == 2
    # partial averaging beats no averaging
    assert d["ring"]["final_loss"] < d["solo"]["final_loss"]


def test_table4_twin(capsys):
    out, lines = _run("table4_lr_tuning", capsys)
    assert lines[0] == "algo,lr,final_loss"
    assert [(a, lr) for a, lr, _ in out["rows"]] == [
        ("ssgd", 0.125), ("dpsgd", 0.125), ("ssgd", 0.5), ("dpsgd", 0.5)]
    assert all(math.isfinite(x) for _, _, x in out["rows"])


def test_fig4_twin(capsys):
    out, lines = _run("fig4_noise_decomp", capsys)
    rows = out["rows"]
    assert [r[0] for r in rows] == [10, 20]
    # Delta2 dominates Delta_S early and decays
    assert rows[0][2] > 10 * rows[0][1] and rows[-1][2] < rows[0][2]


def test_theorem1_twin(capsys):
    out, lines = _run("theorem1_smoothing", capsys)
    sm = [r for r in out["rows"] if r[0] == "l1_analytic" and r[1] > 0]
    assert [r[1] for r in sm] == [0.1, 0.8]
    assert sm[0][2] > sm[1][2] and out["ls_raw"] > sm[0][2]
    assert "monotone=True" in lines[-1]


def test_table5_twin(capsys):
    from repro_torch.bench import table5_asr_proxy as t5
    out, lines = _run("table5_asr_proxy", capsys)
    assert lines[0] == "algo,lr,train_loss,heldout"
    assert [(r[0], r[1]) for r in out["rows"]] == [("ssgd", 0.5),
                                                   ("dpsgd", 0.5)]
    assert all(math.isfinite(x) for r in out["rows"] for x in r[2:])
    assert "critical-lr heldout ssgd=" in lines[-1]
    # the zipf classes: class 1 the most frequent, rank r ~ r^-1.2
    gen = torch.Generator().manual_seed(0)
    lab = t5.ZipfTemplates().sample(gen, 20000)["label"].long()
    counts = torch.bincount(lab, minlength=100).float()
    assert counts[0] == counts.max()
    assert 0.8 < float(counts[0] / counts[1]) / 2 ** 1.2 < 1.25
    # the check holds the reference's result: both converge at the safe lr
    t5.check([["ssgd", 0.25, 0.5, 0.53], ["dpsgd", 0.25, 0.4, 0.44]])
    with pytest.raises(RuntimeError, match="safe lr"):
        t5.check([["ssgd", 0.25, 3.2, 3.3], ["dpsgd", 0.25, 0.4, 0.44]])
    with pytest.raises(RuntimeError, match="non-finite"):
        t5.check([["ssgd", 0.5, float("nan"), 3.3]])


def test_fig3_twin(capsys):
    from repro_torch.bench import fig3_straggler as f3
    out, lines = _run("fig3_straggler", capsys)
    assert lines[0] == ("algo,straggle_x,us_per_step_measured,"
                        "us_per_tick_with_straggler,final_loss,"
                        "staleness_max_seen")
    rows = out["rows"]
    assert [(r[0], r[1]) for r in rows] == [("dpsgd_sync", 5), ("adpsgd", 5)]
    assert all(math.isfinite(r[4]) for r in rows)
    # the straggler rides the elastic fleet: slow every 5th tick, never
    # evicted, its staleness capped by tau
    sup = out["runs"][("adpsgd", 5)]["supervisor"]
    assert sup.report.interventions == 0
    assert int(sup.membership.slow_every[0]) == 5
    assert rows[1][5] == f3.TAU - 1
    assert "5x-straggler tick ms: sync=" in lines[-1]
    # the check holds the reference's full-settings result
    good = [["dpsgd_sync", 1, 20.0, 20.0, 6e-4, 0.0],
            ["adpsgd", 1, 21.0, 21.0, 6e-4, 0.0],
            ["dpsgd_sync", 5, 20.0, 100.0, 6e-4, 0.0],
            ["adpsgd", 5, 21.0, 21.0, 9e-4, 3.0]]
    f3.check(good)
    for row, col, bad, match in ((3, 4, 0.5, "not below"),
                                 (3, 5, 4.0, "staleness"),
                                 (1, 4, 7e-4, "without a straggler"),
                                 (3, 3, 200.0, "not shorter")):
        rows = [list(r) for r in good]
        rows[row][col] = bad
        with pytest.raises(RuntimeError, match=match):
            f3.check(rows)
