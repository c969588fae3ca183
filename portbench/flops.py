"""Closed-form model FLOPs of a step, counted from shapes.  Frozen copies
of the arithmetic of the port's ``launch/analytic.py`` (the 6ND weight
term plus the attention term) over the plain shape of ``model.shape``.

Two choices are this file's own, so that an mfu cannot pass its peak:
the input embedding is a lookup and counts no FLOPs (the output head is a
product and counts), and attention counts the live causal pairs exactly,
q.k and P.V once each (2 FLOPs a multiply-add), three times over for a
forward and a backward.  Nothing recomputed is counted.
"""
from __future__ import annotations

from .model import layer_counts


def n_params(s: dict) -> int:
    """Every parameter (``ModelConfig.n_params``'s formula)."""
    d, h, kv, hd, ff = (s["d_model"], s["n_heads"], s["n_kv_heads"],
                        s["head_dim"], s["d_ff"])
    v = s["vocab"]
    c = layer_counts(s)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    di = s.get("ssm_expand", 2) * d
    r = s.get("dt_rank", 0)
    # in_proj, the depthwise conv, x_proj, dt_proj, out_proj (the scan's
    # own elementwise work, ~6 di N a token, is not counted)
    mamba = (2 * d * di + di * s.get("ssm_conv", 4)
             + di * (2 * s.get("ssm_state", 16) + r) + r * di + di * d)
    moe = s["n_experts"] * 3 * d * ff + d * s["n_experts"]
    total = (c["attn"] * attn + c["mamba"] * mamba + c["moe"] * moe
             + c["dense"] * 3 * d * ff + 2 * d * s["n_layers"])
    return int(total + v * d * (1 if s["tie_embeddings"] else 2))


def n_matmul_params(s: dict, active: bool = True) -> int:
    """Parameters a token multiplies through: all but the input
    embedding's lookup; with ``active`` a MoE layer counts its top-k
    experts only."""
    n = n_params(s)
    if not s["tie_embeddings"]:
        n -= s["vocab"] * s["d_model"]
    if active and s["n_experts"]:
        c = layer_counts(s)
        n -= c["moe"] * (s["n_experts"] - s["top_k"]) * 3 * s["d_model"] \
            * s["d_ff"]
    return n


def causal_pairs(seq: int, window: int = 0) -> int:
    """(q, k) pairs a causal mask (and a trailing window) leave live over
    positions 0..seq-1."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attention_flops(s: dict, batch: int, seq: int) -> float:
    """q.k and P.V over the live pairs of every attention layer, forward
    only (2 FLOPs a multiply-add, each of the two products)."""
    pairs = causal_pairs(seq, s["window"])
    return layer_counts(s)["attn"] * 4.0 * batch * pairs * s["n_heads"] \
        * s["head_dim"]


def train_flops(s: dict, sequences: int, seq: int) -> float:
    """One training step over ``sequences`` rows of ``seq`` tokens: the
    forward and backward (3x the forward) of every product."""
    return 6.0 * n_matmul_params(s) * sequences * seq \
        + 3.0 * attention_flops(s, sequences, seq)


def decode_flops(s: dict, contexts) -> float:
    """One serve step that feeds one token for each of ``contexts`` (the
    number of positions each slot attends over, its own included)."""
    w = 2.0 * n_matmul_params(s) * len(contexts)
    per_ctx = layer_counts(s)["attn"] * 4.0 * s["n_heads"] * s["head_dim"]
    win = s["window"]
    return w + per_ctx * sum(min(c, win) if win else c for c in contexts)
