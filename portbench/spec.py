"""Find a cell and everything it names, by name, as files under portbench/.

- a cell:          ``workloads/<cell>.json``  (config, traffic, chips, why,
                   the limits that decide ``correct``)
- a configuration: ``configs/<config>.json``
- a traffic mix:   ``traffic/<mix>.json``     (its ``kind`` and parameters)
- a traffic kind:  ``traffic/<kind>.py``      (drives the program: ``run``)
- a metric:        ``metrics/<metric>.py``    (``read(record)``)

A later cell, configuration, mix or metric is added as files alone.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} (looked for {path})")
    return json.loads(path.read_text())


def _module(kind: str, name: str):
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module named {name!r} (looked for {path})")
    mod_name = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, suffix: str) -> list:
    """Every name of ``kind`` (a folder) with files ending in ``suffix``."""
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


def cell(name: str) -> dict:
    """The cell with its configuration and traffic mix resolved:
    {"name", "config": {...}, "traffic": {...}, "chips", "why", "limits",
    "metrics": [per-layer metric names]}."""
    c = _json("workloads", name)
    out = dict(c, name=name)
    out["config"] = dict(_json("configs", c["config"]), name=c["config"])
    out["traffic"] = dict(_json("traffic", c["traffic"]), name=c["traffic"])
    return out


def kind(name: str):
    """The traffic kind's module (``traffic/<kind>.py``)."""
    return _module("traffic", name)


def metric(name: str):
    """The per-layer metric's module (``metrics/<metric>.py``)."""
    return _module("metrics", name)
