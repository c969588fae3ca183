"""Paper Fig. 4 on the port — the twin of
``benchmarks/fig4_noise_decomp.py``: the DPSGD noise split into the
minibatch part Delta_S and the landscape-dependent part Delta2; Delta2 >>
Delta_S early and decays as training smooths the landscape.

    PYTHONPATH=src python -m repro_torch.bench.fig4_noise_decomp
    PYTHONPATH=src python -m repro_torch.bench.fig4_noise_decomp --device cpu --smoke

Prints one CSV row per diagnostic step (step, delta_s, delta_2,
sigma_w_sq, alpha_e) and the summary row ``name,us_per_call,derived``.
"""
from __future__ import annotations

import argparse

from .common import train_fc


def run(*, steps: int = 120, device=None) -> dict:
    r = train_fc("dpsgd", 0.5, steps=steps, diag_every=10, device=device)
    rows = [[step, float(d.delta_s), float(d.delta_2),
             float(d.sigma_w_sq), float(d.alpha_e)]
            for step, d in r["diags"]]
    return {"rows": rows, "us_per_step": r["us_per_step"]}


def derived(rows) -> str:
    early, late = rows[0], rows[-1]
    ratio_early = early[2] / max(early[1], 1e-20)
    return (f"delta2/deltaS early={ratio_early:.1f} "
            f"delta2 early={early[2]:.2e} late={late[2]:.2e} "
            "(paper: Delta2>>DeltaS early, decays)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="30 steps")
    args = ap.parse_args(argv)
    out = run(steps=30 if args.smoke else 120, device=args.device)
    print("step,delta_s,delta_2,sigma_w_sq,alpha_e")
    for row in out["rows"]:
        print(",".join(f"{x:.6g}" for x in row))
    print(f"fig4_noise_decomp,{out['us_per_step']:.0f},"
          f"{derived(out['rows'])}")
    return out


if __name__ == "__main__":
    main()
