"""Paper Table 1 (large-batch scaling at CPU scale) on the port — the twin
of ``benchmarks/table1_large_batch.py``: the linear-scaling-rule lr for a
growing total batch; SSGD against DPSGD, plus the closed-loop
``ssgd_autolr`` column (DESIGN §10): plain SSGD whose LR multiplier is
clamped online from probed sharpness.  SSGD+AutoLR survives the
large-batch LRs where SSGD diverges.

    PYTHONPATH=src python -m repro_torch.bench.table1_large_batch
    PYTHONPATH=src python -m repro_torch.bench.table1_large_batch --device cpu

Prints one CSV row per cell (algo, nB, lr, final_loss, autolr_scale,
us_per_step) and the summary row ``name,us_per_call,derived``.
"""
from __future__ import annotations

import argparse

from .common import final_loss, train_fc

BASE_LOCAL, BASE_LR = 100, 0.125   # nB=500 baseline
SCALES = (1, 2, 4)                  # nB = 500, 1000, 2000
N = 5
ALGOS = ("ssgd", "dpsgd", "ssgd_autolr")


def run_cell(algo: str, scale: int, *, steps: int = 120, device=None,
             kernel_backend: str = "auto", probe_kwargs=None) -> dict:
    """One (algo, batch-scale) cell under the linear LR scaling rule.
    ``probe_kwargs`` go to the landscape probe (e.g. ``reorth="ref"``)."""
    r = train_fc(algo, BASE_LR * scale, n=N, local_batch=BASE_LOCAL * scale,
                 steps=steps, device=device, kernel_backend=kernel_backend,
                 probe_kwargs=probe_kwargs)
    ctl = r["controller"]
    return {"algo": algo, "nB": N * BASE_LOCAL * scale,
            "lr": BASE_LR * scale, "final_loss": final_loss(r["losses"]),
            "autolr_scale": float(ctl.scale) if ctl is not None else 1.0,
            "us_per_step": r["us_per_step"], "losses": r["losses"],
            "probes": r["probes"], "scales": r["scales"],
            "controller": ctl}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="24 steps at the smallest and largest batch")
    args = ap.parse_args(argv)
    steps = 24 if args.smoke else 120
    scales = SCALES[::2] if args.smoke else SCALES
    print("algo,nB,lr,final_loss,autolr_scale,us_per_step")
    rows, us = [], 0.0
    for s in scales:
        for algo in ALGOS:
            r = run_cell(algo, s, steps=steps, device=args.device)
            us = r["us_per_step"]
            rows.append(r)
            print(f"{algo},{r['nB']},{r['lr']},{r['final_loss']:.6g},"
                  f"{r['autolr_scale']:.6g},{us:.0f}", flush=True)
    big = {r["algo"]: r["final_loss"] for r in rows
           if r["nB"] == N * BASE_LOCAL * scales[-1]}
    derived = (f"largest-batch loss ssgd={big['ssgd']:.3f} "
               f"dpsgd={big['dpsgd']:.3f} "
               f"ssgd_autolr={big['ssgd_autolr']:.3f} (paper T1: DPSGD wins "
               "at large batch; AutoLR keeps SSGD alive)")
    print(f"table1_large_batch,{us:.0f},{derived}")
    return rows


if __name__ == "__main__":
    main()
