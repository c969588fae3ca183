"""The GossipSchedule sweep at the critical lr on the port — the twin of
``benchmarks/ablation_topology.py``: every compiled topology (static:
full / ring / torus / hierarchical / exp; time-varying: one-peer
exponential, random matchings with two mixing rounds) plus solo, DPSGD on
the flat engine, each scheduled one through the fused gossip kernel.

Two stories in one table: partial averaging beats full averaging and none
(the paper's noise trade-off), and the schedule analyzer's measured
consensus contraction never falls below its spectral-gap bound
(``measured_gap >= gap_bound``).

    PYTHONPATH=src python -m repro_torch.bench.ablation_topology
    PYTHONPATH=src python -m repro_torch.bench.ablation_topology --device cpu --smoke

Prints one CSV row per topology (the columns below) and the summary row
``name,us_per_call,derived``; asserts that every scheduled topology ran
fused and met its bound.
"""
from __future__ import annotations

import argparse
import math

from ..core import make_schedule, spectral_gap_profile
from ..core.util import learner_var
from .common import final_loss, train_fc

LR = 0.5
TOPOLOGIES = ("full", "ring", "torus", "random_pair", "solo",
              "hierarchical", "exp", "one_peer_exp", "random_matching")
N = 8
COLUMNS = ("topology", "K", "period", "rounds_per_step", "fused",
           "gap_bound", "measured_gap", "final_loss", "consensus_dist")


def run_topology(name: str, *, steps: int = 130, n: int = N,
                 device=None) -> dict:
    """Train DPSGD on ``name`` and profile its schedule (16 steps)."""
    kw = {"gossip_rounds": 2} if name == "random_matching" else {}
    r = train_fc("dpsgd", LR, n=n, steps=steps, topology=name,
                 algo_kwargs=kw, device=device)
    tr = r["trainer"]
    sched = make_schedule(name, n, rounds=kw.get("gossip_rounds", 1))
    prof = spectral_gap_profile(sched, window=16)
    consensus = math.sqrt(float(learner_var(tr.params_tree(r["state"]))))
    return {
        "topology": name,
        "K": sched.K if sched else 0,
        "period": sched.period if sched else 0,
        "rounds_per_step": tr.rounds_per_step,
        "fused": int(tr.is_fused),
        "gap_bound": round(prof["gap_bound"], 6),
        "measured_gap": round(prof["measured_gap"], 6),
        "final_loss": final_loss(r["losses"]),
        "consensus_dist": consensus,
        "us_per_step": r["us_per_step"],
        "steps": steps,
    }


def check(rows) -> None:
    """Every scheduled topology ran the fused kernel, and the analyzer
    never reports contraction faster than measured."""
    for r in rows:
        if r["topology"] != "solo" and r["fused"] != 1:
            raise AssertionError(f"{r['topology']} did not run fused: {r}")
        if not r["measured_gap"] >= r["gap_bound"] - 1e-9:
            raise AssertionError(f"{r['topology']}: measured_gap "
                                 f"{r['measured_gap']} < gap_bound "
                                 f"{r['gap_bound']}")


def derived(rows) -> str:
    d = {r["topology"]: r for r in rows}
    return (f"full={d['full']['final_loss']:.3f} "
            f"ring={d['ring']['final_loss']:.3f} "
            f"pair={d['random_pair']['final_loss']:.3f} "
            f"solo={d['solo']['final_loss']:.3f} "
            "(partial averaging beats full & none); one_peer_exp "
            f"measured_gap={d['one_peer_exp']['measured_gap']:.2f} vs "
            f"per-step bound {d['one_peer_exp']['gap_bound']:.2f} at 1 "
            "collective/step; all schedules fused")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="40 steps each")
    args = ap.parse_args(argv)
    steps = 40 if args.smoke else 130
    print(",".join(COLUMNS))
    rows = []
    for name in TOPOLOGIES:
        r = run_topology(name, steps=steps, device=args.device)
        rows.append(r)
        print(",".join(f"{r[c]:.6g}" if isinstance(r[c], float)
                       else str(r[c]) for c in COLUMNS), flush=True)
    check(rows)
    us = sum(r["us_per_step"] for r in rows) / len(rows)
    print(f"ablation_topology,{us:.0f},{derived(rows)}")
    return rows


if __name__ == "__main__":
    main()
