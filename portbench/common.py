"""Small pieces the traffic kinds share: device synchronisation, leaf
paths, the comparisons that decide ``correct``."""
from __future__ import annotations

import gc
import statistics

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def open_window(device) -> None:
    """Just before a window: the device idle, and everything set-up made
    moved out of the collector's way (``gc.freeze``), so that a full
    collection inside the window scans only what the window makes;
    ``close_window`` hands it back."""
    gc.collect()
    gc.freeze()
    sync(device)


def close_window(device) -> None:
    sync(device)
    gc.unfreeze()


class Fence:
    """Keeps the host at most ``depth`` steps ahead of the device: each
    ``mark`` records an event and waits for the one ``depth`` marks
    back."""

    def __init__(self, device, depth: int = 2):
        self.cuda = torch.device(device).type == "cuda"
        self.depth, self.events = depth, []

    def mark(self) -> None:
        if not self.cuda:
            return
        e = torch.cuda.Event()
        e.record()
        self.events.append(e)
        if len(self.events) > self.depth:
            self.events.pop(0).synchronize()


def flat(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict, keys sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, p))
        else:
            out[p] = v
    return out


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.detach().to(torch.float64)))


def leaf_norms(stacked: dict, n: int) -> dict:
    """{leaf: [norm of learner i's slice]} of a stacked tree's leaves."""
    return {p: [norm(v[i]) for i in range(n)] for p, v in flat(stacked).items()}


def kept_leaves(ref_grads: dict):
    """(leaf, learner) pairs whose reference gradient is not nought to
    rounding: at least a thousandth of the median (leaf, learner)'s."""
    med = statistics.median(v for vs in ref_grads.values() for v in vs)
    return {(p, i) for p, vs in ref_grads.items() for i, v in enumerate(vs)
            if v >= 1e-3 * med}


def worst_leaf_gap(prog: dict, ref: dict, kept) -> tuple:
    """max over kept (leaf, learner) of |prog - ref| / max(ref, median of
    ref); returns (gap, "leaf[i]")."""
    med = statistics.median(ref[p][i] for p, i in kept)
    worst, where = 0.0, None
    for p, i in sorted(kept):
        g = abs(prog[p][i] - ref[p][i]) / max(ref[p][i], med)
        if g > worst or where is None:
            worst, where = g, f"{p}[{i}]"
    return worst, where


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def verdict(numbers: list) -> bool:
    """Every compared number within its limit (a NaN is not)."""
    return all(x["value"] <= x["limit"] for x in numbers)
