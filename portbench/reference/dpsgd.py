"""Plain DPSGD (Lian et al. 2017, the paper's Algorithm 1 with momentum)
over n learners held as separate float32 copies of the weight tree.

A step, for every learner i at once (the previous step's weights on the
right-hand side):

    g_i   = grad of learner i's mean token loss on its own rows
    mixed = c_i0 w_i + c_i1 w_partner(i)          (the step's round table)
    mu_i  = beta mu_i + g_i                       (mu starts at 0)
    w_i   = mixed - lr * scale(t) * mu_i
    scale(t) = 1 + (s - 1) min(t / warmup, 1)     (warm-up + linear scaling)

``run`` follows the first ``steps`` steps and returns what the benchmark
compares: each step's mean loss, each learner's per-leaf norm of the
first gradient, and of the weights' change after the last step.
"""
from __future__ import annotations

import torch

from . import model as ref


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


def _unflat(flat):
    tree = {}
    for p, v in flat.items():
        node = tree
        *head, last = p.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def run(tree0, s, batches, rounds, recipe, steps: int = 3, ops=None):
    """tree0: the starting weights (every learner starts from them);
    batches[t]: {"tokens", "labels"} with leaves (n, B, S); rounds[t]:
    (partners (1, n), coefs (n, 2)); recipe: {"lr", "momentum",
    "warmup_steps", "lr_scale"}.  Returns {"losses": [steps],
    "grad_norms": {leaf: [n]}, "delta_norms": {leaf: [n]}}."""
    w0 = {p: v.detach().to(torch.float32) for p, v in _flat(tree0).items()}
    n = batches[0]["tokens"].shape[0]
    w = [{p: v.clone() for p, v in w0.items()} for _ in range(n)]
    mu = [{p: torch.zeros_like(v) for p, v in w0.items()} for _ in range(n)]
    lr, beta = recipe["lr"], recipe["momentum"]
    warm, big = recipe["warmup_steps"], recipe["lr_scale"]
    losses, grad_norms = [], None
    for t in range(steps):
        grads, ls = [], []
        for i in range(n):
            leaves = {p: v.detach().requires_grad_() for p, v in w[i].items()}
            b = {k: batches[t][k][i] for k in ("tokens", "labels")}
            with torch.enable_grad():
                loss = ref.loss(_unflat(leaves), s, b, ops)
                g = torch.autograd.grad(loss, list(leaves.values()))
            grads.append(dict(zip(leaves, g)))
            ls.append(float(loss.detach()))
        losses.append(sum(ls) / n)
        if t == 0:
            grad_norms = {p: [norm(grads[i][p]) for i in range(n)]
                          for p in w0}
        partners, coefs = (torch.as_tensor(x).cpu() for x in rounds[t])
        partners, coefs = partners[0].tolist(), coefs.tolist()
        scale = 1.0 + (big - 1.0) * min(t / max(warm, 1), 1.0)
        new = []
        for i in range(n):
            j = partners[i]
            row = {}
            for p in w0:
                mu[i][p] = beta * mu[i][p] + grads[i][p]
                mixed = coefs[i][0] * w[i][p] + coefs[i][1] * w[j][p]
                row[p] = mixed - lr * scale * mu[i][p]
            new.append(row)
        w = new
        del grads
    delta = {p: [norm(w[i][p] - w0[p]) for i in range(n)] for p in w0}
    return {"losses": losses, "grad_norms": grad_norms,
            "delta_norms": delta}
