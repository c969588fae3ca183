"""Paper Table 4/8 on the port (lr tuning at the largest batch) — the twin
of ``benchmarks/table4_lr_tuning.py``: tuning SSGD's lr down lets it
escape early traps, but DPSGD at the full linear-scaled lr still wins.

    PYTHONPATH=src python -m repro_torch.bench.table4_lr_tuning
    PYTHONPATH=src python -m repro_torch.bench.table4_lr_tuning --device cpu --smoke

Prints one CSV row per cell (algo, lr, final_loss) and the summary row
``name,us_per_call,derived``.
"""
from __future__ import annotations

import argparse

from .common import final_loss, train_fc

LRS = (0.0625, 0.125, 0.25, 0.5)


def run(*, steps: int = 120, lrs=LRS, device=None) -> dict:
    rows, us = [], 0.0
    for lr in lrs:
        for algo in ("ssgd", "dpsgd"):
            r = train_fc(algo, lr, local_batch=400, steps=steps,
                         device=device)
            us = r["us_per_step"]
            rows.append([algo, lr, final_loss(r["losses"])])
    return {"rows": rows, "us_per_step": us}


def derived(rows) -> str:
    best_ssgd = min(r[2] for r in rows if r[0] == "ssgd")
    best_dpsgd = min(r[2] for r in rows if r[0] == "dpsgd")
    return (f"best ssgd={best_ssgd:.3f} (needs tuning) best dpsgd="
            f"{best_dpsgd:.3f} (paper T4: DPSGD best across lrs)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="24 steps at two of the four lrs")
    args = ap.parse_args(argv)
    out = run(steps=24 if args.smoke else 120,
              lrs=(LRS[1], LRS[3]) if args.smoke else LRS,
              device=args.device)
    print("algo,lr,final_loss")
    for algo, lr, loss in out["rows"]:
        print(f"{algo},{lr},{loss:.6g}")
    print(f"table4_lr_tuning,{out['us_per_step']:.0f},"
          f"{derived(out['rows'])}")
    return out


if __name__ == "__main__":
    main()
