"""Paper Fig. 3 + App. F on the port: straggler immunity — the twin of
``benchmarks/fig3_straggler.py``.

Trains synchronous pairwise DPSGD against asynchronous AD-PSGD with an
injected straggler (learner 0 takes ``slow`` ticks per local step, injected
through ``FaultPlan.straggler``: the elastic fleet's seeded fault path)
through ``MultiLearnerTrainer`` and reports, per algorithm and straggle
factor:

  * the measured us per step of the train step;
  * the wall time per tick under the straggler: synchronous gossip waits
    on the slowest learner every tick (x slow), AD-PSGD proceeds against
    the straggler's stale published buffer (x 1) — the one modeled number;
  * the final training loss and the largest buffer staleness seen.

    PYTHONPATH=src python -m repro_torch.bench.fig3_straggler
    PYTHONPATH=src python -m repro_torch.bench.fig3_straggler --device cpu --smoke

Prints one CSV row per cell and the summary row ``name,us_per_call,derived``.
``--smoke``: 24 steps at straggle factor 5 only.

What the reference's own CPU run gives at the full settings (N 8, lr 0.5,
120 steps, tau 4): final losses 6.27e-4 (sync), 6.27e-4 / 6.37e-4 /
8.68e-4 (AD-PSGD at straggle 1 / 2 / 5), the largest staleness seen 0 / 1
/ 3, and AD-PSGD at straggle 1 equal to the sync run within 1e-8
relative.  ``check`` holds the twin to that: every loss finite; the
staleness seen min(slow, tau) - 1 exactly; AD-PSGD without a straggler
equal to the sync run within 1e-6 relative; at the full settings every
final loss below 1e-2; and at the largest factor the asynchronous tick
shorter than the synchronous one (the paper's claim).
"""
from __future__ import annotations

import argparse
import math
import time

from ..core import FaultPlan
from .common import final_loss, train_fc

SLOW_FACTORS = (1, 2, 5)
N, LR, STEPS, TAU = 8, 0.5, 120, 4
SMOKE_STEPS = 24
IMMUNE_LOSS = 1e-2          # the reference's final losses: 6.3e-4-8.7e-4
SAME_RUN_RTOL = 1e-6        # AD-PSGD without a straggler == sync DPSGD
COLUMNS = ["algo", "straggle_x", "us_per_step_measured",
           "us_per_tick_with_straggler", "final_loss", "staleness_max_seen"]


def run(*, steps: int = STEPS, slow_factors=SLOW_FACTORS,
        device=None) -> dict:
    """The sync run once (it does not depend on the straggle factor, only
    its tick does), then AD-PSGD at each factor.  Returns dict(rows,
    wall_us, steps, runs): ``wall_us`` the whole sweep's (the summary row's
    number, as in the reference), ``runs`` maps (algo, slow) to
    train_fc's result."""
    t0 = time.perf_counter()
    kw = dict(n=N, steps=steps, device=device)
    sync = train_fc("dpsgd", LR, **kw)
    rows, runs = [], {("dpsgd_sync", 0): sync}
    for slow in slow_factors:
        adp = train_fc("adpsgd", LR, algo_kwargs=dict(max_staleness=TAU),
                       fault_plan=FaultPlan.straggler(0, slow), **kw)
        runs[("adpsgd", slow)] = adp
        for name, r, tick_scale in (("dpsgd_sync", sync, slow),
                                    ("adpsgd", adp, 1)):
            us = r["us_per_step"]
            rows.append([name, slow, us, us * tick_scale,
                         final_loss(r["losses"]), r["staleness_max"]])
    return {"rows": rows, "steps": steps, "runs": runs,
            "wall_us": (time.perf_counter() - t0) * 1e6}


def derived(rows) -> str:
    slow = max(r[1] for r in rows)
    d = {r[0]: r for r in rows if r[1] == slow}
    return (f"{slow}x-straggler tick ms: sync={d['dpsgd_sync'][3] / 1e3:.1f} "
            f"async={d['adpsgd'][3] / 1e3:.1f}; final loss "
            f"sync={d['dpsgd_sync'][4]:.3f} async={d['adpsgd'][4]:.3f} "
            "(paper Fig3: DPSGD immune)")


def check(rows, steps: int = STEPS) -> None:
    """Raise unless the rows show what the reference's run shows (module
    docstring)."""
    bad = [r for r in rows if not math.isfinite(r[4])]
    if bad:
        raise RuntimeError(f"fig3: non-finite losses {bad}")
    for name, slow, _, _, loss, stale in rows:
        want = min(slow, TAU) - 1 if name == "adpsgd" else 0
        if stale != want:
            raise RuntimeError(f"fig3: {name} at straggle {slow} saw "
                               f"staleness {stale}, want {want}")
        if steps >= STEPS and not loss < IMMUNE_LOSS:
            raise RuntimeError(f"fig3: {name} at straggle {slow} ended at "
                               f"{loss}, not below {IMMUNE_LOSS}")
    one = {r[0]: r[4] for r in rows if r[1] == 1}
    if one and abs(one["adpsgd"] - one["dpsgd_sync"]) > \
            SAME_RUN_RTOL * abs(one["dpsgd_sync"]):
        raise RuntimeError(f"fig3: AD-PSGD without a straggler ended at "
                           f"{one['adpsgd']}, the sync run at "
                           f"{one['dpsgd_sync']}")
    slow = max(r[1] for r in rows)
    tick = {r[0]: r[3] for r in rows if r[1] == slow}
    if slow > 1 and not tick["adpsgd"] < tick["dpsgd_sync"]:
        raise RuntimeError(f"fig3: at straggle {slow} the async tick "
                           f"({tick['adpsgd']} us) is not shorter than the "
                           f"sync one ({tick['dpsgd_sync']} us)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_STEPS} steps at straggle factor "
                         f"{SLOW_FACTORS[-1]} only")
    args = ap.parse_args(argv)
    out = run(steps=SMOKE_STEPS if args.smoke else STEPS,
              slow_factors=SLOW_FACTORS[-1:] if args.smoke else SLOW_FACTORS,
              device=args.device)
    print(",".join(COLUMNS))
    for row in out["rows"]:
        print(",".join(f"{x:.6g}" if isinstance(x, float) else str(x)
                       for x in row))
    print(f"fig3_straggler,{out['wall_us']:.0f},{derived(out['rows'])}")
    check(out["rows"], out["steps"])
    return out


if __name__ == "__main__":
    main()
