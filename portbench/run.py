"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number with its limit.  The same numbers are the last lines of standard
error.  Exits 2 without a result when the card, or as many cards as the
cell asks for, is missing, and 3 when a JAX module is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    one host thread for the CPU's math libraries (the host's work is the
    program's Python dispatch; idle pool threads only contend for the
    shared host's cores)."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def per_layer(record: dict) -> dict:
    """Every metric under ``metrics/`` whose reader finds something in
    this record."""
    from portbench import spec
    out = {}
    for name in spec.names("metrics", ".py"):
        got = spec.metric(name).read(record)
        if got is not None:
            value, unit = got
            out[name] = {"value": value, "unit": unit}
    return out


def execute(name: str, seed: int, seconds: float, trace: bool,
            device="cuda") -> dict:
    """The whole run but the look for a card: set-up, window, profiled
    stretch, check.  Returns the result object."""
    from portbench import spec
    cell = spec.cell(name)
    res = spec.kind(cell["traffic"]["kind"]).run(
        cell, seed, seconds, trace, device, T_START)
    out = {"correct": None, "attempted": res["attempted"],
           "failed": res["failed"]}
    if trace:
        rec = res["record"]
        out["metrics"] = per_layer(rec)
        out["breakdown"] = {"device_ops": rec["prof"]["device_ops"],
                            "idle_gaps": rec["prof"]["idle_gaps"]}
    else:
        out["metrics"] = {k: {"value": v, "unit": u}
                          for k, (v, u) in res["e2e"].items()}
    import torch
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if trace:
        dev["busy_s"] = rec["prof"]["busy_s"]
        dev["window_s"] = rec["prof"]["window_s"]
    out["device"] = dev
    from portbench.common import verdict
    out["correct"] = verdict(res["numbers"])
    out["checks"] = {x["name"]: {"value": x["value"], "limit": x["limit"]}
                     for x in res["numbers"]}
    out["_readings"] = res.get("readings")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = CHECKOUT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"the program is not here: no {src / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    caches()
    from portbench import spec
    chips = spec.cell(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"JAX modules loaded in the benchmark's process: {bad}",
              file=sys.stderr)
        return 3
    out.pop("_readings", None)
    checks = out.pop("checks")
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    out["checks"] = checks
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
