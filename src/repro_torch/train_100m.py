"""End-to-end training run: the ~100M-parameter dense LM trained with
DPSGD on the synthetic token pipeline, with crash-safe checkpoints, a
resume and a held-out evaluation — the port's twin of
``examples/train_100m.py``, same flags and recipe.

    PYTHONPATH=src python -m repro_torch.train_100m --steps 300 --seq 512
    PYTHONPATH=src python -m repro_torch.train_100m --device cpu --preset smoke

A run resumes from the newest undamaged checkpoint in ``--ckpt-dir``
(written every ``--ckpt-every`` steps and at the end, named by the steps
its state has trained).  A checkpoint holds the tree view of the state
(``trainer.state_view``: the reference's layout), so its files read back
in ``repro.checkpoint`` with the reference's own template, and across
trainer engines.
"""
from __future__ import annotations

import argparse
import time

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .configs import get_config
from .core import AlgoConfig, MultiLearnerTrainer
from .data import ShardedLoader, SyntheticTokenStream
from .device import resolve_device
from .models import build_model
from .optim import scale_by_schedule, sgd, warmup_linear_scale
from .tree import tree_leaves


def recipe(lr: float):
    """The paper's recipe: momentum SGD under warm-up + linear scaling."""
    return scale_by_schedule(sgd(lr, momentum=0.9),
                             warmup_linear_scale(10, 1.0))


def make_trainer(api, opt, *, learners: int, algo: str = "dpsgd",
                 **kw) -> MultiLearnerTrainer:
    """The recipe's trainer over ``api``'s model: ``opt`` (``recipe(lr)``,
    or that wrapped) and ``algo`` on random-pair gossip (DPSGD's
    random-neighbour matchings; SSGD*'s sigma_0 is ``AlgoConfig``'s 0.01);
    ``kw`` goes to ``MultiLearnerTrainer`` (``device``, ``kernel_backend``,
    ``engine``, ``alpha_for_diag``)."""
    return MultiLearnerTrainer(
        api.loss_fn, opt,
        AlgoConfig(algo=algo, topology="random_pair", n_learners=learners),
        params_from_tree=api.params_from_tree, **kw)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-batch", type=int, default=2)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--preset", choices=["full", "smoke"], default="full")
    ap.add_argument("--ckpt-dir", default="results/ckpt_100m_torch")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, checkpoint, evaluate; returns the run's summary: the steps
    trained in this run, the step resumed from (None for a fresh start),
    the losses (host floats, read once at the end), the held-out loss and
    the last checkpoint's path."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("transformer-100m")
    if args.preset == "smoke":
        cfg = cfg.smoke_config()
    api = build_model(cfg, device=dev)
    tree = api.param_tree(api.init(0))
    n_params = sum(x.numel() for x in tree_leaves(tree))
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  "
          f"learners={args.learners}  nB={args.learners * args.local_batch}")

    loader = ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                           n_learners=args.learners,
                           local_batch=args.local_batch,
                           extra_args=(args.seq,), device=dev)
    trainer = make_trainer(api, recipe(args.lr), learners=args.learners,
                           device=dev)
    state = trainer.init(0, tree)
    del tree

    def ckpt_tree(st):
        # checkpoint the tree VIEW so checkpoints stay layout-stable
        # across trainer engines (the flat engine stores (n, T, 128))
        v = trainer.state_view(st)
        return {"params": v.params, "opt": v.opt_state}

    resumed = latest_step(args.ckpt_dir)
    if resumed is not None:
        saved, resumed = restore_checkpoint(args.ckpt_dir, ckpt_tree(state))
        state = trainer.state_from_view(state._replace(
            params=saved["params"], opt_state=saved["opt"]))
        state = state._replace(step=resumed)
        del saved
        print(f"resumed from step {resumed}")

    start = state.step
    losses, path = [], None
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        state, m = trainer.train_step(state, loader.batch(i))
        losses.append(m.loss)
        if i % 5 == 0 or i == args.steps - 1:
            dt = (time.perf_counter() - t0) / (i - start + 1)
            print(f"step {i:4d}  loss {float(m.loss):.4f}  "
                  f"sigma_w^2 {float(m.sigma_w_sq):.2e}  {dt:.1f}s/step")
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, state.step,
                                   ckpt_tree(state))
    heldout = float(trainer.eval_loss(state, loader.eval_batch(8)))
    print(f"heldout loss: {heldout:.4f}")
    path = save_checkpoint(args.ckpt_dir, args.steps, ckpt_tree(state))
    print(f"checkpoint saved to {args.ckpt_dir}")
    return {"steps": args.steps - start, "resumed_from": resumed,
            "losses": [float(x) for x in losses], "heldout": heldout,
            "checkpoint": path, "n_params": n_params}


if __name__ == "__main__":
    main()
