"""Theorem 1 on the port — the twin of
``benchmarks/theorem1_smoothing.py``.

(a) The analytic non-smooth case L(w) = G ||w||_1: G-Lipschitz with an
    unbounded gradient-Lipschitz constant at the kinks.  Nesterov-Spokoiny
    Lemma 2 bounds the smoothed landscape at 2G/sigma; the empirical l_s of
    L~ over a sweep of sigma must decay (asserted).
(b) The paper's FC net at init (reported, not asserted: at generic points
    the raw landscape is locally smooth and the Monte-Carlo estimator's
    variance dominates).

    PYTHONPATH=src python -m repro_torch.bench.theorem1_smoothing
    PYTHONPATH=src python -m repro_torch.bench.theorem1_smoothing --device cpu --smoke

Prints one CSV row per point (landscape, sigma_w, empirical_l_s,
bound_2G_over_s) and the summary row ``name,us_per_call,derived``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.smoothing import estimate_smoothness
from ..data import TemplateImages
from ..device import resolve_device
from ..models import fcnet

G = 1.0


def rough_loss(params, batch):
    return G * torch.sum(torch.abs(params["w"])) + 0.0 * torch.sum(
        batch["x"])


def run(*, smoke: bool = False, device=None) -> dict:
    dev = resolve_device(device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    t0 = time.perf_counter()
    params = {"w": torch.full((64,), 0.01, device=dev)}
    batch = {"x": torch.zeros((1,), device=dev)}
    nan = float("nan")
    ls_raw = float(estimate_smoothness(rough_loss, params, batch, gen(0),
                                       sigma=0.0, n_pairs=6,
                                       probe_radius=0.02))
    rows = [["l1_analytic", 0.0, ls_raw, nan]]
    for sigma in (0.1, 0.8) if smoke else (0.1, 0.2, 0.4, 0.8):
        ls = float(estimate_smoothness(rough_loss, params, batch, gen(0),
                                       sigma=sigma, n_pairs=6, n_mc=64,
                                       probe_radius=0.02))
        rows.append(["l1_analytic", sigma, ls, 2 * G / sigma])

    fb = TemplateImages().sample(gen(1), 256)
    fp = fcnet.init_params(gen(2), in_dim=784, hidden=50)
    for sigma in (0.2,) if smoke else (0.0, 0.2):
        ls = float(estimate_smoothness(fcnet.loss_fn, fp, fb, gen(3),
                                       sigma=sigma, n_pairs=4, n_mc=32,
                                       probe_radius=0.02))
        rows.append(["fcnet_init", sigma, ls, nan])
    us = (time.perf_counter() - t0) * 1e6 / len(rows)
    return {"rows": rows, "ls_raw": ls_raw, "us_per_call": us}


def derived(out: dict):
    """(summary text, whether l_s decays over sigma)."""
    sm = [r for r in out["rows"] if r[0] == "l1_analytic" and r[1] > 0]
    decays = all(sm[i][2] > sm[i + 1][2] for i in range(len(sm) - 1))
    within = all(r[2] <= r[3] * 1.5 for r in sm)
    return (f"raw l_s={out['ls_raw']:.1f}; smoothed l_s "
            f"{sm[0][2]:.2f}@s=0.1 -> {sm[-1][2]:.2f}@s=0.8 "
            f"monotone={decays} within 1.5x of 2G/sigma={within}"), decays


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="two sigmas of the sweep, one FC-net point")
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke, device=args.device)
    print("landscape,sigma_w,empirical_l_s,bound_2G_over_s")
    for name, sigma, ls, bound in out["rows"]:
        print(f"{name},{sigma},{ls:.6g},{bound:.6g}")
    text, decays = derived(out)
    print(f"theorem1_smoothing,{out['us_per_call']:.0f},{text}")
    if not decays:
        raise AssertionError(f"smoothed l_s does not decay: {out['rows']}")
    return out


if __name__ == "__main__":
    main()
