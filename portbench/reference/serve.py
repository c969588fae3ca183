"""The plain forward over served requests, a layer at a time.

Each request is its prompt followed by its served tokens (the last one
not fed back).  Every request runs through layer l before any runs
through layer l + 1, so one layer's float32 weights are held at a time;
the per-token halves of a layer (its MLP or experts) run over the tokens
of all requests together.  Returns, for each request, the float32 logits
of the positions at which its served tokens were chosen.
"""
from __future__ import annotations

import torch

from . import model as ref

F32 = torch.float32


def _convert(node, ops, skip=("w1", "w2", "w3")):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out[k] = _convert(v, ops, skip)
        elif v.dim() >= 2 and k not in skip and k not in ("conv_w", "a_log",
                                                          "router"):
            out[k] = ops.w(v)
        else:
            out[k] = v
    return out


@torch.no_grad()
def served_logits(tree, s, requests, ops=None):
    """requests: [(prompt ids, served ids)] -> [logits (len(served),
    vocab)]."""
    ops = ops or ref.Ops()
    dev = tree["embed"].device
    seqs = [torch.tensor(list(p) + list(g[:-1]), device=dev)
            for p, g in requests]
    xs = [ref.embed(tree, s, t[None]) for t in seqs]
    lens = [x.shape[1] for x in xs]
    for p, i, mixer, mlp in ref.layers(s):
        lp = ref.layer_params(tree, p, i)
        mix = _convert(lp["mixer"], ops)
        fn = ref.attention if mixer == "attn" else ref.mamba
        xs = [x + fn(ref.rms_norm(x, lp["norm1"], s["norm_eps"]), mix, s,
                     ops) for x in xs]
        del mix
        x = torch.cat(xs, 1)
        h = ref.rms_norm(x, lp["norm2"], s["norm_eps"])
        if mlp == "moe":
            x = x + ref.moe(h, lp["mlp"], s, ops)
        else:
            f = _convert(lp["mlp"], ops, skip=())
            x = x + ref.swiglu(h, f["w1"], f["w3"], f["w2"], ops)
            del f
        xs = list(torch.split(x, lens, 1))
    head = ops.w(tree["embed"].T if s["tie_embeddings"] else tree["lm_head"])
    out = []
    for x, (prompt, served) in zip(xs, requests):
        rows = x[0, len(prompt) - 1:len(prompt) - 1 + len(served)]
        h = ref.rms_norm(rows, tree["final_norm"], s["norm_eps"])
        out.append(ops.mm(h, head)[:, :s["vocab"]])
    return out


def gaps(logits, tokens):
    """By how much each chosen token's logit lies below the best one."""
    t = torch.as_tensor(list(tokens), device=logits.device).long()
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]
