"""Paper Fig. 2(a)+(b) on the port — the twin of
``benchmarks/fig2_effective_lr.py``: DPSGD against SSGD and SSGD* at a
large learning rate in the large-batch setting, with the diagnostics'
alpha_e(t) and sigma_w^2(t) and the landscape probe's Eq. 4 prediction of
alpha_e beside the measured one; then SSGD*'s noise sweep.

    PYTHONPATH=src python -m repro_torch.bench.fig2_effective_lr
    PYTHONPATH=src python -m repro_torch.bench.fig2_effective_lr --device cpu --smoke

Prints one CSV row per diagnostic step (algo, step, loss, alpha_e,
sigma_w_sq, delta_s, delta_2, alpha_e_pred, sharpness, trace_hc) and per
sweep cell, then the summary row ``name,us_per_call,derived``.
"""
from __future__ import annotations

import argparse

from .common import final_loss, train_fc

LR = 0.5
STEPS = 140
ALGOS = ("ssgd", "dpsgd", "ssgd_star")
SWEEP = (0.1, 0.01, 0.001)
COLUMNS = ("algo", "step", "loss", "alpha_e", "sigma_w_sq", "delta_s",
           "delta_2", "alpha_e_pred", "sharpness", "trace_hc")


def run(*, steps: int = STEPS, every: int = 20, sweep=SWEEP,
        device=None) -> dict:
    """The three runs with diagnostics and probes every ``every`` steps,
    then SSGD* at each noise level of ``sweep``.  Returns dict(rows, runs,
    sweep, eq4, us_per_step)."""
    nan = float("nan")
    rows, runs = [], {}
    for algo in ALGOS:
        r = train_fc(algo, LR, steps=steps, diag_every=every,
                     landscape_every=every, device=device)
        runs[algo] = r
        pred = {step: p for step, p in r["probes"]}
        for step, d in r["diags"]:
            p = pred.get(step)
            rows.append([algo, step, r["losses"][step - 1],
                         float(d.alpha_e), float(d.sigma_w_sq),
                         float(d.delta_s), float(d.delta_2),
                         float(p.alpha_e_pred) if p else nan,
                         float(p.sharpness) if p else nan,
                         float(p.trace_hc) if p else nan])
    # SSGD*'s noise sensitivity: at this 42k-parameter scale every sigma
    # converges (the reference's honest negative)
    star = {}
    for std in sweep:
        rs = train_fc("ssgd_star", LR, steps=steps, noise_std=std,
                      device=device)
        star[std] = final_loss(rs["losses"])
        rows.append([f"ssgd_star(std={std})", steps, star[std]]
                    + [nan] * 7)
    dp = runs["dpsgd"]
    pred = {s: p for s, p in dp["probes"]}
    errs = [abs(float(pred[s].alpha_e_pred) - float(d.alpha_e)) / LR
            for s, d in dp["diags"] if s in pred]
    return {"rows": rows, "runs": runs, "sweep": star,
            "eq4": sum(errs) / len(errs) if errs else nan,
            "us_per_step": sum(r["us_per_step"] for r in runs.values())
            / len(runs)}


def derived(out: dict) -> str:
    res = {a: final_loss(r["losses"]) for a, r in out["runs"].items()}
    return (f"final_loss ssgd={res['ssgd']:.3f} dpsgd={res['dpsgd']:.3f} "
            f"ssgd*={res['ssgd_star']:.3f}; eq4 |pred-meas|/alpha="
            f"{out['eq4']:.3f}; ssgd* sweep "
            + " ".join(f"s{k}={v:.2f}" for k, v in out["sweep"].items())
            + " (paper: DPSGD converges, SSGD fails; SSGD*-inferiority "
            "does not reproduce at 42k params — honest negative)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="40 steps, probes every 10, one sweep level")
    args = ap.parse_args(argv)
    steps, every = (40, 10) if args.smoke else (STEPS, 20)
    out = run(steps=steps, every=every,
              sweep=SWEEP[:1] if args.smoke else SWEEP, device=args.device)
    print(",".join(COLUMNS))
    for row in out["rows"]:
        print(",".join(f"{x:.6g}" if isinstance(x, float) else str(x)
                       for x in row))
    print(f"fig2_effective_lr,{out['us_per_step']:.0f},{derived(out)}")
    return out


if __name__ == "__main__":
    main()
