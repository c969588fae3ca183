"""Traffic kind ``train``: DPSGD training of n learners simulated on one
card through ``MultiLearnerTrainer.train_step`` on the flat engine.

The mix's parameters: ``learners``, ``local_batch``, ``seq``,
``topology`` (``random_pair``), ``lr``, ``momentum``, ``warmup_steps``,
``lr_scale`` (the paper's recipe: momentum SGD under warm-up and linear
scaling), ``attention`` (``chunked`` or ``flash``: the port's
``use_pallas`` route), ``check_steps`` (the steps the reference follows),
``pool`` (distinct batches and round tables, cycled through the window),
``trace_steps`` (the profiled stretch).

From the seed: the weights (``weights.make_tree``), a pool of batches of
uniform token ids (every row distinct) and a pool of random perfect
matchings, handed to ``train_step(rounds=)`` and to the reference alike.

Set-up builds one trainer, drives it through the first ``check_steps``
steps (which also warm up every shape), reads what the check compares
(each step's loss; each learner's per-leaf norm of the first gradient,
from the momentum after step 1, which starts at 0; the per-leaf norm of
the weights' change after the last check step), and hands the same
trainer and state to the window.  The window runs steps until
``seconds`` have passed, the host at most two steps ahead of the device,
and ends in a synchronize.  After it, with the program's state freed,
the plain reference follows the same first steps.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import common, weights
from portbench.model import port_config, shape
from portbench.reference import dpsgd as ref_dpsgd
from portbench.reference.model import strict_fp32


def matchings(seed: int, n: int, count: int):
    """``count`` random perfect matchings of n learners (one left solo
    when n is odd): [(partners (1, n) int32, coefs (n, 2) float32)]."""
    rng = np.random.default_rng([int(seed), 0x7A11])
    out = []
    for _ in range(count):
        perm = rng.permutation(n)
        partner = np.arange(n, dtype=np.int32)
        for a, b in zip(perm[0::2], perm[1::2]):
            partner[a], partner[b] = b, a
        solo = partner == np.arange(n)
        c0 = np.where(solo, 1.0, 0.5).astype(np.float32)
        out.append((partner[None], np.stack([c0, 1.0 - c0], 1)))
    return out


def batches(seed: int, tr: dict, vocab: int, device):
    """A pool of ``tr["pool"]`` stacked batches {"tokens", "labels",
    "mask"}: leaves (n, B, S), uniform token ids drawn on the device."""
    n, B, S = tr["learners"], tr["local_batch"], tr["seq"]
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 2654435761 + 17) % 2 ** 63)
    toks = torch.randint(0, vocab, (tr["pool"], n, B, S + 1), generator=gen,
                         device=device, dtype=torch.int32)
    ones = torch.ones((n, B, S), device=device)
    return [{"tokens": t[..., :-1].contiguous(),
             "labels": t[..., 1:].contiguous(), "mask": ones} for t in toks]


def _find(node, key):
    if isinstance(node, dict):
        if key in node:
            return node[key]
        for v in node.values():
            got = _find(v, key)
            if got is not None:
                return got
    return None


def build(cell: dict, seed: int, device):
    """The program's trainer over the benchmark's weights and inputs."""
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.models import build_model
    from repro_torch.optim import scale_by_schedule, sgd
    from repro_torch.optim.schedules import warmup_linear_scale

    s, tr = shape(cell["config"]), cell["traffic"]
    cfg = port_config(s, cell["config"]["name"])
    if tr["attention"] == "flash":
        import dataclasses
        cfg = dataclasses.replace(cfg, use_pallas=True)
    tree = weights.make_tree(s, seed, device)
    api = build_model(cfg, device=device)
    opt = scale_by_schedule(sgd(tr["lr"], momentum=tr["momentum"]),
                            warmup_linear_scale(tr["warmup_steps"],
                                                tr["lr_scale"]))
    trainer = MultiLearnerTrainer(
        api.loss_fn, opt,
        AlgoConfig(algo="dpsgd", topology=tr["topology"],
                   n_learners=tr["learners"]),
        params_from_tree=api.params_from_tree, engine="flat", device=device)
    state = trainer.init(int(seed) % 2 ** 63, tree)
    return s, tree, trainer, state


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from portbench import trace as tracing

    tr = cell["traffic"]
    n, B, S = tr["learners"], tr["local_batch"], tr["seq"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, tree, trainer, state = build(cell, seed, device)
    pool = batches(seed, tr, s["vocab"], device)
    tables = [tuple(torch.as_tensor(x, device=device) for x in r)
              for r in matchings(seed, n, tr["pool"])]

    def step(st, k):
        return trainer.train_step(st, pool[k % len(pool)],
                                  rounds=[tables[k % len(tables)]])

    # -- set-up: the check steps, through the window's own call -----------
    K = tr["check_steps"]
    prog = {"losses": []}
    for k in range(K):
        state, m = step(state, k)
        prog["losses"].append(float(m.loss))
        if k == 0:
            mu = _find(trainer.state_view(state).opt_state, "mu")
            prog["grad_norms"] = common.leaf_norms(mu, n)
    w = trainer.params_tree(state)
    w0 = common.flat(tree)
    prog["delta_norms"] = {
        p: [common.norm(v[i] - w0[p]) for i in range(n)]
        for p, v in common.flat(w).items()}
    rows = state.params.shape[1]

    # -- the window ---------------------------------------------------------
    common.open_window(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    fence, losses, k = common.Fence(device), [], K
    while True:
        state, m = step(state, k)
        losses.append(m.loss)
        k += 1
        fence.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    common.close_window(device)
    window_s = time.perf_counter() - t0
    steps = k - K
    finite = torch.isfinite(torch.stack(losses)).tolist()

    record = None
    if trace:
        def stretch():
            nonlocal state, k
            for _ in range(tr["trace_steps"]):
                state, _ = step(state, k)
                k += 1
        prof = tracing.profile(stretch, lambda: common.sync(device))
        record = {"kind": "train", "shape": s, "traffic": tr,
                  "window_steps": steps, "window_s": window_s,
                  "prof": prof, "prof_steps": tr["trace_steps"],
                  "store_rows": rows}
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    # -- the reference, with the program's state freed -----------------------
    del trainer, state, m, losses, w
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    recipe = {k2: tr[k2] for k2 in ("lr", "momentum", "warmup_steps",
                                     "lr_scale")}
    with strict_fp32():
        ref = ref_dpsgd.run(tree, s, pool[:K], tables[:K], recipe, steps=K)
    numbers = compare(prog, ref, cell["limits"])
    return {
        "attempted": steps, "failed": steps - sum(finite),
        "e2e": {"train_tokens_per_s": (n * B * S * steps / window_s,
                                       "tokens/s"),
                "setup_s": (setup_s, "s")},
        "record": record, "memory_peak_bytes": peak, "numbers": numbers,
        "readings": {"program": prog, "reference": ref},
    }


def compare(prog: dict, ref: dict, limits: dict) -> list:
    """The numbers ``correct`` is decided on, each beside its limit."""
    kept = common.kept_leaves(ref["grad_norms"])
    loss_gap = max(common.rel_gap(a, b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, _ = common.worst_leaf_gap(prog["grad_norms"],
                                        ref["grad_norms"], kept)
    delta_gap, _ = common.worst_leaf_gap(prog["delta_norms"],
                                         ref["delta_norms"], kept)
    return [{"name": "loss_gap", "value": loss_gap,
             "limit": limits["loss_gap"]},
            {"name": "grad_gap", "value": grad_gap,
             "limit": limits["grad_gap"]},
            {"name": "delta_gap", "value": delta_gap,
             "limit": limits["delta_gap"]}]
