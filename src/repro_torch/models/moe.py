"""Mixture-of-Experts FFN: top-k router and capacity-bucketed expert
products — the port of ``repro/models/moe.py``.

Tokens are scattered into an (E, C, d) buffer by (expert id, rank within
the expert), the rank a cumsum over the token-major (T·k) assignments;
three batched products run every expert on its bucket; a gather brings the
results back and the gate values sum the top-k contributions.  An
assignment past the capacity C = max(1, int(cf · k · T / E)) lands in a
trash column and is zeroed on the gather.  The combine weights are the
renormalized top-k gates times the keep mask; they are not renormalized
again over the kept set (the reference's code, whatever its docstring
says).

Capacity makes a token's output depend on the other tokens of its batch:
at decode, T is the number of serve slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init

__all__ = ["MoEParams", "dispatch", "init_moe_params", "moe_forward",
           "route"]


class MoEParams(nn.Module):
    """router (d, E) float32; w1, w3 (E, d, d_ff); w2 (E, d_ff, d)."""

    def __init__(self, router, w1, w3, w2):
        super().__init__()
        self.router = nn.Parameter(router)
        self.w1 = nn.Parameter(w1)
        self.w3 = nn.Parameter(w3)
        self.w2 = nn.Parameter(w2)


def _experts(gen, n_experts, d_in, d_out, dtype):
    return torch.stack([dense_init(gen, d_in, d_out, dtype)
                        for _ in range(n_experts)])


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype) -> MoEParams:
    """The router in float32 whatever ``dtype`` is (the reference's)."""
    return MoEParams(dense_init(gen, d_model, n_experts, torch.float32),
                     _experts(gen, n_experts, d_model, d_ff, dtype),
                     _experts(gen, n_experts, d_model, d_ff, dtype),
                     _experts(gen, n_experts, d_ff, d_model, dtype))


def route(logits, top_k: int):
    """Float32 router logits (T, E) -> (probs (T, E), gate values (T, k)
    renormalized by max(sum, 1e-9), expert ids (T, k) int64)."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_ids


def dispatch(expert_ids, n_experts: int, capacity: int):
    """(T, k) expert ids -> (expert, column, keep) per token-major (T·k)
    assignment: the column is the assignment's rank within its expert (a
    cumsum in token order) when that rank is below ``capacity``, else the
    trash column ``capacity`` with expert 0 and keep False."""
    flat_expert = expert_ids.reshape(-1)                       # (T*k,)
    ranks = torch.cumsum(F.one_hot(flat_expert, n_experts), dim=0) - 1
    rank_in_expert = ranks.gather(1, flat_expert[:, None])[:, 0]
    keep = rank_in_expert < capacity
    return (torch.where(keep, flat_expert, 0),
            torch.where(keep, rank_in_expert, capacity), keep)


def moe_forward(params: MoEParams, x, *, n_experts: int, top_k: int,
                capacity_factor: float = 1.25, return_aux: bool = False):
    """x: (B, S, d) -> (B, S, d) [, aux losses {"load_balance",
    "dropped_frac"}]."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)

    probs, gate_vals, expert_ids = route(xt.float() @ params.router, top_k)
    C = max(1, int(capacity_factor * top_k * T / n_experts))

    # scatter into (E, C, d); dropped assignments land in the trash column
    slot_e, slot_c, keep = dispatch(expert_ids, n_experts, C)
    src = torch.repeat_interleave(xt, top_k, dim=0)            # (T*k, d)
    buf = torch.zeros((n_experts, C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot_e, slot_c), src)[:, :C]          # (E, C, d)

    # every expert's SwiGLU on its bucket
    h = F.silu(torch.bmm(buf, params.w1)) * torch.bmm(buf, params.w3)
    out_buf = torch.bmm(h, params.w2)                          # (E, C, d)

    # gather back and combine
    gathered = out_buf[slot_e, torch.clamp(slot_c, max=C - 1)]  # (T*k, d)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    w = (gate_vals.reshape(-1) * keep.to(gate_vals.dtype))[:, None]
    yt = torch.sum((gathered * w.to(gathered.dtype)).reshape(T, top_k, d),
                   dim=1)
    y = yt.reshape(B, S, d)
    if not return_aux:
        return y
    # Switch-style load-balance loss from the top-1 expert
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert_ids[:, 0], n_experts).float(), dim=0)
    aux = {"load_balance": n_experts * torch.sum(me * ce),
           "dropped_frac": 1.0 - torch.mean(keep.float())}
    return y, aux
