"""Quickstart: train the paper's FC net with DPSGD vs SSGD at a large
learning rate in the large-batch setting (the paper's headline experiment,
Fig. 2a) — the port's twin of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart               # the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu  # the CPU
"""
from __future__ import annotations

import argparse

import torch

from .core import AlgoConfig, MultiLearnerTrainer
from .data import ShardedLoader, TemplateImages
from .device import resolve_device
from .models import fcnet
from .optim import sgd

LR, N_LEARNERS, LOCAL_BATCH, STEPS = 0.5, 5, 400, 120


def train(algo: str, *, lr: float = LR, n_learners: int = N_LEARNERS,
          local_batch: int = LOCAL_BATCH, steps: int = STEPS,
          log_every: int = 20, device=None, init_params=None,
          batch_fn=None, rounds_fn=None):
    """Train ``algo`` for ``steps`` steps; returns the per-step mean losses
    (host floats, read once at the end).  ``init_params``, ``batch_fn(step)``
    and ``rounds_fn(step)`` replace the seeded init, the loader and the
    trainer's own matchings (the parity test feeds the reference's)."""
    dev = resolve_device(device)
    loader = ShardedLoader(TemplateImages(), n_learners=n_learners,
                           local_batch=local_batch, seed=0, device=dev)
    trainer = MultiLearnerTrainer(
        fcnet.loss_fn, sgd(lr),
        AlgoConfig(algo=algo, topology="random_pair", n_learners=n_learners),
        device=dev)
    if init_params is None:
        init_params = fcnet.init_params(
            torch.Generator(device=dev).manual_seed(0), in_dim=784, hidden=50)
    state = trainer.init(0, init_params)
    losses, sigmas = [], []
    for step in range(steps):
        batch = loader.batch(step) if batch_fn is None else batch_fn(step)
        state, metrics = trainer.train_step(
            state, batch, None if rounds_fn is None else rounds_fn(step))
        losses.append(metrics.loss)
        sigmas.append(metrics.sigma_w_sq)
    losses = torch.stack(losses).tolist()
    sigmas = torch.stack(sigmas).tolist()
    for step in range(0, steps, log_every or steps):
        print(f"  [{algo}] step {step:4d} loss {losses[step]:.4f} "
              f"sigma_w^2 {sigmas[step]:.2e}")
    return losses


def main(*, steps: int = STEPS, local_batch: int = LOCAL_BATCH, device=None):
    print(f"large batch (nB={N_LEARNERS * local_batch}), lr={LR}")
    ssgd = train("ssgd", steps=steps, local_batch=local_batch,
                 device=device)[-1]
    dpsgd = train("dpsgd", steps=steps, local_batch=local_batch,
                  device=device)[-1]
    verdict = ("DPSGD converges where SSGD fails (paper Fig. 2a)"
               if dpsgd < ssgd else "unexpected")
    print(f"\nfinal loss: SSGD={ssgd:.4f}  DPSGD={dpsgd:.4f} -> {verdict}")
    return ssgd, dpsgd


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    main(steps=args.steps, device=args.device)
