"""Paper Fig. 2 reproduction on the MNIST stand-in — the port's twin of
``examples/paper_mnist_repro.py``: n = 5 learners, the 784-50-50-10 FC net,
nB = 2000, lr 0.5, 150 steps of SSGD, SSGD* and DPSGD.

Every 10 steps it records the step's loss, the paper's instruments
(alpha_e, sigma_w^2, Delta_S, Delta_2 over a fresh superbatch) and the
mean model's accuracy on a held-out batch of 512, and writes them as one
CSV row (the reference's columns) to ``--out``.  DPSGD trains on the flat
engine (one gossip kernel launch a step on the card); SSGD and SSGD* on
the pytree engine.

    PYTHONPATH=src python -m repro_torch.paper_mnist_repro        # card
    PYTHONPATH=src python -m repro_torch.paper_mnist_repro --device cpu
"""
from __future__ import annotations

import argparse
import csv
import os

import torch

from .core import AlgoConfig, MultiLearnerTrainer
from .core.util import learner_mean
from .data import ShardedLoader, TemplateImages
from .device import resolve_device
from .models import fcnet
from .optim import sgd

LR, STEPS, N_LEARNERS, LOCAL_BATCH = 0.5, 150, 5, 400
ALGOS = ("ssgd", "ssgd_star", "dpsgd")
EVERY, EVAL_BATCH, DIAG_OFFSET = 10, 512, 10_000
HEADER = ["algo", "step", "loss", "alpha_e", "sigma_w_sq", "delta_s",
          "delta_2", "test_acc"]
OUT = os.path.join("results", "bench", "paper_fig2_repro_torch.csv")


def run(algo: str, *, steps: int = STEPS, device=None):
    """Train ``algo`` for ``steps`` steps; returns one row (``HEADER``'s
    columns) every ``EVERY`` steps, from step 0."""
    dev = resolve_device(device)
    loader = ShardedLoader(TemplateImages(), n_learners=N_LEARNERS,
                           local_batch=LOCAL_BATCH, seed=0, device=dev)
    tr = MultiLearnerTrainer(
        fcnet.loss_fn, sgd(LR),
        AlgoConfig(algo=algo, topology="random_pair", n_learners=N_LEARNERS,
                   noise_std=0.01),
        alpha_for_diag=LR, device=dev)
    st = tr.init(0, fcnet.init_params(
        torch.Generator(device=dev).manual_seed(0), in_dim=784, hidden=50))
    rows = []
    for i in range(steps):
        st, m = tr.train_step(st, loader.batch(i))
        if i % EVERY:
            continue
        d = tr.diagnostics(st, loader.batch(DIAG_OFFSET + i))
        w_a = learner_mean(tr.params_tree(st))
        with torch.no_grad():
            acc = fcnet.accuracy(w_a, loader.eval_batch(EVAL_BATCH))
        row = [algo, i] + [float(x) for x in (
            m.loss, d.alpha_e, d.sigma_w_sq, d.delta_s, d.delta_2, acc)]
        rows.append(row)
        print(f"[{algo}] step {i:4d} loss {row[2]:7.4f} alpha_e "
              f"{row[3]:6.3f} sigma_w2 {row[4]:8.2e} test_acc {row[7]:.3f}",
              flush=True)
    return rows


def write_csv(path: str, rows) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows(rows)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the three algorithms and write the CSV; returns {algo: rows}."""
    args = parse_args(argv)
    out = {}
    for algo in ALGOS:
        print(f"=== {algo} (lr={LR}, nB={N_LEARNERS * LOCAL_BATCH}) ===",
              flush=True)
        out[algo] = run(algo, steps=args.steps, device=args.device)
    write_csv(args.out, [r for rows in out.values() for r in rows])
    print(f"\nwrote {args.out}")
    return out


if __name__ == "__main__":
    main()
