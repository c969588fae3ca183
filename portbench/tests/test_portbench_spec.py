"""Cells, configurations, mixes and metrics are found by name; a new one
is files alone; BENCHMARK.json and the files agree; nothing under
portbench/ imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from conftest import CHECKOUT

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_file_matches_benchmark_json(name):
    from portbench import spec
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = spec.cell(name)
    assert cell["config"]["name"] == entry["config"]
    assert cell["traffic"]["name"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (CHECKOUT / conf["file"]).resolve() == \
        (spec.ROOT / "configs" / f"{entry['config']}.json").resolve()
    assert conf["source"] == cell["config"]["source"]
    assert conf["reduced"] == cell["config"]["reduced"]
    spec.kind(cell["traffic"]["kind"])          # the kind's module exists
    assert set(cell["limits"]) == {"served_gap_mean"} or \
        set(cell["limits"]) >= {"loss_gap", "grad_gap", "delta_gap"}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(name):
    e2e = [m for m in BENCH["end_to_end"]
           if name in m.get("workloads", CELLS)]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layers = [m for m in BENCH["per_layer"]
              if name in m.get("workloads", CELLS)]
    assert layers
    for m in layers:                        # its partner is reported here
        assert m["moves"] in names, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader(metric):
    from portbench import spec
    mod = spec.metric(metric)
    assert callable(mod.read)
    assert mod.read({"kind": "none"}) is None


def test_benchmark_json_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        bound_max = 0.25
        assert 0.01 <= m["bound"] <= bound_max
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_a_cell_added_as_files_alone_is_found(tiny_root):
    from portbench import spec
    assert "tiny.train" in spec.names("workloads", ".json")
    cell = spec.cell("tiny.train")
    assert cell["config"]["d_model"] == 64
    assert cell["traffic"]["kind"] == "train"
    with pytest.raises(KeyError):
        spec.cell("no.such.cell")


def test_a_metric_added_as_a_file_alone_is_read(tiny_root):
    from portbench import run
    (tiny_root / "metrics" / "dummy_count.train.py").write_text(
        "def read(rec):\n"
        "    if rec.get('kind') != 'train':\n"
        "        return None\n"
        "    return rec['window_steps'] * 1.0, 'count'\n")
    rec = {"kind": "train", "window_steps": 7, "window_s": 1.0,
           "shape": None, "traffic": None, "prof": None}
    got = {}
    from portbench import spec
    for name in spec.names("metrics", ".py"):
        if name == "dummy_count.train":
            got[name] = spec.metric(name).read(rec)
    assert got == {"dummy_count.train": (7.0, "count")}
    assert "dummy_count.train" in spec.names("metrics", ".py")
    assert run.per_layer({"kind": "serve-not"}) == {}


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(CHECKOUT).as_posix()
    for p in (CHECKOUT / "portbench").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_top_imports(CHECKOUT / path))
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_top_level_names_are_compared_whole():
    from portbench.run import loaded_forbidden
    before = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_fake_probe"] = object()
        assert "repro" not in loaded_forbidden()
        sys.modules["repro.fake_probe"] = object()
        assert "repro" in loaded_forbidden()
    finally:
        for k in ("repro_torch_fake_probe", "repro.fake_probe"):
            sys.modules.pop(k, None)
        for k, v in before.items():
            sys.modules.setdefault(k, v)


def test_reference_imports_torch_and_numpy_only():
    for p in (CHECKOUT / "portbench" / "reference").glob("*.py"):
        names = set(_top_imports(p)) - {"__future__", "contextlib", "math"}
        assert names <= {"torch", "numpy"}, (p.name, names)


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: no
    result, another exit code than 0."""
    import shutil
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_without_a_card_exits_nonzero(tmp_path):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=CHECKOUT, capture_output=True, text=True,
                       timeout=120, env={"CUDA_VISIBLE_DEVICES": "",
                                         "PATH": "/usr/bin:/bin",
                                         "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
