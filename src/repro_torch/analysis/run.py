"""CLI for the port's static invariant auditor (DESIGN §16), the twin of
``repro.analysis.run`` (``make lint`` runs the reference's).

    python -m repro_torch.analysis.run                # AST + traced audits, the card
    python -m repro_torch.analysis.run --device cpu   # the same on the CPU
    python -m repro_torch.analysis.run --ast-only     # the AST rules only (fast)
    python -m repro_torch.analysis.run --root DIR     # AST pass over a fixture tree
    python -m repro_torch.analysis.run --selftest     # prove the auditor still bites

Exit 0: clean.  Exit 1: findings (or, under ``--selftest``, a rule that
failed to fire on its seeded violation).  Exit 2: the auditor itself broke
(a missing fixture tree, an audit that raised).

The traced audits run in this process: the trainer and the serve engine
on ``--device``, the launch step in 8 gloo ranks that
``torch.multiprocessing`` spawns (a (4, 2) mesh; on the card they share
it).  Nothing falls back: with no card, the default device raises.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path
from typing import List

from .lint import lint_root
from .report import RULES, Finding, format_findings

REPO_ROOT = Path(__file__).resolve().parents[3]
AST_RULES = ("no-host-sync", "no-id-cache", "kernel-oracle", "design-refs")


def _traced_audits(device) -> int:
    """Run the traced audits over all three hot paths."""
    from .targets import audit_launch, audit_serve, audit_trainer
    findings: List[Finding] = []
    for name, audit in [("trainer", audit_trainer),
                        ("launch", audit_launch),
                        ("serve", audit_serve)]:
        print(f"analysis: auditing {name} ...", flush=True)
        findings += audit(device=device)
    if findings:
        print(format_findings(findings))
        return 1
    return 0


def _two_rank_groups():
    """Two gloo process groups of one world, rank 0 and rank 1, in this
    process (each made on its own thread): the selftest's wire."""
    import datetime
    import threading

    import torch
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup, ProcessGroupGloo

    store = dist.HashStore()
    groups = [None, None]

    def make(rank):
        pg = ProcessGroup(store, rank, 2)
        backend = ProcessGroupGloo(store, rank, 2,
                                   datetime.timedelta(seconds=60))
        pg._register_backend(torch.device("cpu"),
                             ProcessGroup.BackendType.GLOO, backend)
        pg._set_default_backend(ProcessGroup.BackendType.GLOO)
        groups[rank] = pg

    threads = [threading.Thread(target=make, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return groups


def _extra_send_traces():
    """Each of two ranks runs a 'step' that exchanges its row with the
    other (one live slot: one send) and then sends once more: the traces
    of both, recorded on their own threads."""
    import threading

    import torch

    from .trace_audit import StepTrace

    groups = _two_rank_groups()
    traces = [None, None]

    def step(rank):
        pg, peer = groups[rank], 1 - rank
        row = torch.full((256,), float(rank))
        got = torch.empty_like(row)
        with StepTrace("cpu") as trace:
            for _ in range(2):              # the slot's send, then one more
                works = [pg.send([row], peer, 0), pg.recv([got], peer, 0)]
                for w in works:
                    w.wait()
        traces[rank] = trace

    threads = [threading.Thread(target=step, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return traces


def _selftest(device) -> int:
    """Negative control: the seeded violation fixture must light up every
    AST rule, and a seeded step must trip each traced rule.  A pass that
    has gone blind passes everything — this is the tripwire."""
    failures = []

    fixture = REPO_ROOT / "tests" / "fixtures" / "lint_violations"
    if not fixture.is_dir():
        print(f"selftest: fixture tree missing: {fixture}", file=sys.stderr)
        return 2
    fired = {f.rule for f in lint_root(fixture)}
    for want in AST_RULES:
        if want not in fired:
            failures.append(f"AST rule {want!r} did not fire on the "
                            "seeded fixture")

    import torch

    from ..device import resolve_device
    from .retrace import TraceSentinel, watch
    from .trace_audit import (StepTrace, collective_count, donation_honored,
                              max_concat_elems, no_host_callback,
                              no_param_concat, storage_ptrs, wire_dtype)

    dev = resolve_device(device)
    a = torch.ones(600, device=dev)
    with StepTrace(dev) as big:
        torch.cat([a, a])
    if not no_param_concat(big, bound=1000, target="selftest"):
        failures.append("no-param-concat missed a seeded 1200-elem concat")
    if max_concat_elems(big) != 1200:
        failures.append("max_concat_elems miscounted the seeded concat")

    with StepTrace(dev) as sync:
        (a * 2).sum().item()
    if not no_host_callback(sync, target="selftest"):
        failures.append("no-host-callback missed a seeded .item()")

    f = watch(lambda x: x + 1, dev)
    f(torch.ones(3, device=dev))
    with TraceSentinel(f, strict=False) as s:
        f(torch.ones(4, device=dev))         # new shape: a real retrace
    if not s.findings:
        failures.append("no-retrace missed a seeded shape change")

    traces = _extra_send_traces()
    if not all(collective_count(t, expected=1, target="selftest")
               for t in traces):
        failures.append("collective-count missed a seeded extra send")
    if not all(wire_dtype(t, expected=torch.bfloat16, target="selftest")
               for t in traces):
        failures.append("wire-dtype missed float32 sent for bfloat16")

    store = torch.zeros(1000, device=dev)
    owned = storage_ptrs([store])
    with StepTrace(dev, watch_bytes=4000) as fresh:
        new = store.clone().add_(1.0)        # a step that clones its store
    if not donation_honored(fresh, [new], owned, min_bytes=4000,
                            target="selftest"):
        failures.append("donation-honored missed a step returning a "
                        "fresh clone of its store")

    if failures:
        print("selftest FAILED:\n  " + "\n  ".join(failures))
        return 1
    from . import load_all_rules
    print(f"selftest: all {len(load_all_rules())} registered rules bite "
          f"({', '.join(sorted(RULES))})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.run",
        description="the port's static invariant auditor (DESIGN §16)")
    ap.add_argument("--root", type=Path, default=None,
                    help="run the AST pass over this tree instead of the "
                         "repo (fixture trees; implies --ast-only)")
    ap.add_argument("--ast-only", action="store_true",
                    help="skip the traced audits and the sentinel")
    ap.add_argument("--selftest", action="store_true",
                    help="verify every rule fires on a seeded violation")
    ap.add_argument("--device", default="cuda",
                    help="where the traced audits run: cuda (default) or "
                         "cpu")
    args = ap.parse_args(argv)

    try:
        if args.selftest:
            return _selftest(args.device)
        root = args.root or REPO_ROOT
        findings = lint_root(root)
        if findings:
            print(format_findings(findings))
            return 1
        print(f"analysis: AST pass clean over {root}")
        if args.ast_only or args.root is not None:
            return 0
        rc = _traced_audits(args.device)
    except Exception:                  # the auditor itself broke: say how
        traceback.print_exc()
        return 2
    if rc == 0:
        from . import load_all_rules
        print(f"analysis: clean — {len(load_all_rules())} rules, 0 findings")
    return rc


if __name__ == "__main__":
    sys.exit(main())
