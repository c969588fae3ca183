"""Random weights of a transformer-family configuration, made from the
seed on the device in a few large calls, in the dtype they are served in.

The tree is the port's reference layout (``repro_torch.models.convert``):
{"embed", "periods": {"l<i>": {"norm1", "mixer": {...}, "norm2", "mlp":
{...}}}, "final_norm", "lm_head"}, period leaves stacked on axis 0.  Every
leaf of the configuration's dtype is a view of one buffer drawn by one
``randn``, then scaled in place (1/sqrt(d_in) for a product's weight,
0.02 for the embedding, 1/sqrt(conv) for the depthwise conv); the float32
leaves (norms, the router, mamba's a_log, d and dt_bias) come from a second
buffer.  The laws are those of the port's own ``init_params``; the draws
are this file's.
"""
from __future__ import annotations

import math

import torch

from .model import n_periods

F32 = torch.float32


def _dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _layout(s: dict):
    """[(path, shape, dtype kind ("w" | "f32"), init)] in a fixed order.
    init: ("randn", scale) | ("zeros",) | ("ones",) | ("a_log",) |
    ("dt_bias",)."""
    P, d, V = n_periods(s), s["d_model"], s["vocab"]
    H, KV, hd, ff = s["n_heads"], s["n_kv_heads"], s["head_dim"], s["d_ff"]
    out = [(("embed",), (V, d), "w", ("randn", 0.02))]
    for i, (mixer, mlp) in enumerate(s["period"]):
        base = ("periods", f"l{i}")
        out.append((base + ("norm1",), (P, d), "f32", ("zeros",)))
        m = base + ("mixer",)
        if mixer == "attn":
            for name, a, b in (("wq", d, H * hd), ("wk", d, KV * hd),
                               ("wv", d, KV * hd), ("wo", H * hd, d)):
                out.append((m + (name,), (P, a, b), "w",
                            ("randn", 1 / math.sqrt(a))))
        else:
            di, N, r, cv = (s["ssm_expand"] * d, s["ssm_state"],
                            s["dt_rank"], s["ssm_conv"])
            out += [
                (m + ("a_log",), (P, di, N), "f32", ("a_log",)),
                (m + ("conv_b",), (P, di), "w", ("zeros",)),
                (m + ("conv_w",), (P, cv, di), "w",
                 ("randn", 1 / math.sqrt(cv))),
                (m + ("d",), (P, di), "f32", ("ones",)),
                (m + ("dt_bias",), (P, di), "f32", ("dt_bias",)),
                (m + ("dt_proj",), (P, r, di), "w",
                 ("randn", 1 / math.sqrt(r))),
                (m + ("in_proj",), (P, d, 2 * di), "w",
                 ("randn", 1 / math.sqrt(d))),
                (m + ("out_proj",), (P, di, d), "w",
                 ("randn", 1 / math.sqrt(di))),
                (m + ("x_proj",), (P, di, r + 2 * N), "w",
                 ("randn", 1 / math.sqrt(di))),
            ]
        out.append((base + ("norm2",), (P, d), "f32", ("zeros",)))
        f = base + ("mlp",)
        if mlp == "moe":
            E = s["n_experts"]
            out += [
                (f + ("router",), (P, d, E), "f32",
                 ("randn", 1 / math.sqrt(d))),
                (f + ("w1",), (P, E, d, ff), "w",
                 ("randn", 1 / math.sqrt(d))),
                (f + ("w3",), (P, E, d, ff), "w",
                 ("randn", 1 / math.sqrt(d))),
                (f + ("w2",), (P, E, ff, d), "w",
                 ("randn", 1 / math.sqrt(ff))),
            ]
        else:
            out += [(f + (name,), (P, a, b), "w",
                     ("randn", 1 / math.sqrt(a)))
                    for name, a, b in (("w1", d, ff), ("w3", d, ff),
                                       ("w2", ff, d))]
    out.append((("final_norm",), (d,), "f32", ("zeros",)))
    if not s["tie_embeddings"]:
        out.append((("lm_head",), (d, V), "w", ("randn", 1 / math.sqrt(d))))
    return out


def _numel(shape):
    return math.prod(shape)


def make_tree(s: dict, seed: int, device) -> dict:
    """The weights of ``s`` from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    layout = _layout(s)
    wdt = _dtype(s["dtype"])
    sizes = {"w": 0, "f32": 0}
    for _, shape, k, _ in layout:
        sizes[k] += _numel(shape)
    bufs = {"w": torch.randn(sizes["w"], generator=gen, device=device,
                             dtype=wdt),
            "f32": torch.randn(sizes["f32"], generator=gen, device=device,
                               dtype=F32)}
    offs = {"w": 0, "f32": 0}
    tree: dict = {}
    for path, shape, k, init in layout:
        n = _numel(shape)
        x = bufs[k][offs[k]:offs[k] + n].view(shape)
        offs[k] += n
        kind = init[0]
        if kind == "randn":
            x.mul_(init[1])
        elif kind == "zeros":
            x.zero_()
        elif kind == "ones":
            x.fill_(1.0)
        elif kind == "a_log":
            x.copy_(torch.log(torch.arange(1, shape[-1] + 1, dtype=F32,
                                           device=device)).expand(shape))
        elif kind == "dt_bias":
            # dt log-uniform in [1e-3, 1e-1], the softplus inverted
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.clamp(torch.exp(u * (math.log(0.1) - math.log(1e-3))
                                       + math.log(1e-3)), min=1e-4)
            x.copy_(torch.log(torch.expm1(dt)))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = x
    return tree

