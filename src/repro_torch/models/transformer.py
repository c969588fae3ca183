"""Decoder-only LM, dense family — the port of
``repro/models/transformer.py``: training/prefill forward (``apply``,
through chunked attention or, with ``cfg.use_pallas``, the flash kernel)
and paged decode for serving.

Depth is n_periods x period as in the reference; a dense model's period is
one (attn, dense) layer.  Parameters are ``nn.Module``s holding
``nn.Parameter``s in the reference's layout (``periods[p]["l0"].mixer.wq``
is the reference's ``periods/l0/mixer/wq[p]``); the functions below take
them as arguments, mirroring the reference's pure functions.  Mixers other
than attention and MLPs other than the dense SwiGLU arrive with the model
zoo (ROADMAP slice 5) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .attention import (AttnParams, attn_decode_paged, attn_forward,
                        init_attn_params, init_paged_attn_cache)
from .layers import apply_rope, dense_init, dtype_of, embed_init, rms_norm, \
    softcap, swiglu


# ---------------------------------------------------------------------------
# period spec
# ---------------------------------------------------------------------------

def period_spec(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    if cfg.block_period or cfg.n_experts or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense family (attention + dense MLP) is "
            "ported; other mixers and MLPs arrive with ROADMAP slice 5")
    if cfg.mrope_sections:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is not ported yet")
    if cfg.attn_pattern == "local_global":
        return (("attn_local", "dense"), ("attn", "dense"))
    if cfg.attn_pattern == "sliding":
        return (("attn_local", "dense"),)
    return (("attn", "dense"),)


def n_periods(cfg: ModelConfig) -> int:
    p = len(period_spec(cfg))
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"whole number of {p}-layer periods")
    return cfg.n_layers // p


def make_rope_fn(cfg: ModelConfig):
    if not cfg.use_rope:
        return None
    return lambda x, pos: apply_rope(x, pos, cfg.rope_theta)


def _window(cfg: ModelConfig, mixer: str) -> int:
    return cfg.window if (mixer == "attn_local"
                          or cfg.attn_pattern == "sliding") else 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class MLPParams(nn.Module):
    """SwiGLU: w1, w3 (d, d_ff), w2 (d_ff, d)."""

    def __init__(self, w1, w3, w2):
        super().__init__()
        self.w1 = nn.Parameter(w1)
        self.w3 = nn.Parameter(w3)
        self.w2 = nn.Parameter(w2)


class LayerParams(nn.Module):
    def __init__(self, norm1, mixer: AttnParams, norm2, mlp: MLPParams):
        super().__init__()
        self.norm1 = nn.Parameter(norm1)
        self.mixer = mixer
        self.norm2 = nn.Parameter(norm2)
        self.mlp = mlp


class TransformerParams(nn.Module):
    """embed (V, d); periods[p][f"l{i}"]: LayerParams; final_norm (d,);
    lm_head (d, V) unless the embeddings are tied."""

    def __init__(self, embed, periods, final_norm, lm_head=None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.periods = nn.ModuleList(nn.ModuleDict(p) for p in periods)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> TransformerParams:
    """Random weights drawn from ``gen`` on ``gen.device`` (the reference's
    distributions; not its draws, which come from ``jax.random``)."""
    dt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    spec = period_spec(cfg)

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=dev)

    def layer():
        return LayerParams(
            zeros(),
            init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim_, dt),
            zeros(),
            MLPParams(dense_init(gen, d, cfg.d_ff, dt),
                      dense_init(gen, d, cfg.d_ff, dt),
                      dense_init(gen, cfg.d_ff, d, dt)))

    embed = embed_init(gen, cfg.padded_vocab, d, dt)
    periods = [{f"l{i}": layer() for i in range(len(spec))}
               for _ in range(n_periods(cfg))]
    head = (None if cfg.tie_embeddings
            else dense_init(gen, d, cfg.padded_vocab, dt))
    return TransformerParams(embed, periods, zeros(), head)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: TransformerParams, cfg: ModelConfig, tokens):
    # the reference's Python-float scale takes the table's dtype (JAX's
    # weak typing): sqrt(4608) is 68.0 in bfloat16, not 67.88
    dt = params.embed.dtype
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    return params.embed[tokens.long()] * scale


def logits_from_hidden(params: TransformerParams, cfg: ModelConfig, x):
    h = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return softcap(h @ head, cfg.final_softcap)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _layer_forward(lp: LayerParams, x, cfg: ModelConfig, mixer: str,
                   rope_fn, positions):
    h = rms_norm(x, lp.norm1, cfg.norm_eps)
    x = x + attn_forward(lp.mixer, h, n_heads=cfg.n_heads,
                         n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                         rope_fn=rope_fn, q_positions=positions,
                         window=_window(cfg, mixer),
                         attn_softcap=cfg.attn_softcap, chunk=cfg.attn_chunk,
                         use_pallas=cfg.use_pallas)
    h = rms_norm(x, lp.norm2, cfg.norm_eps)
    mlp = lp.mlp
    return x + swiglu(h, mlp.w1, mlp.w3, mlp.w2)


def forward(params: TransformerParams, cfg: ModelConfig, x, positions):
    """x: (B, S, d) input embeddings; positions: (S,).  Returns the final
    hidden states (B, S, d).  The reference scans over stacked period
    parameters with a remat per period; here a loop over
    ``params.periods``, with autograd keeping each layer's activations."""
    spec = period_spec(cfg)
    rope_fn = make_rope_fn(cfg)
    for period in params.periods:
        for i, (mixer, _) in enumerate(spec):
            x = _layer_forward(period[f"l{i}"], x, cfg, mixer, rope_fn,
                               positions)
    return x


def apply(params: TransformerParams, cfg: ModelConfig, tokens):
    """tokens: (B, S) -> logits (B, S, V)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    return logits_from_hidden(params, cfg, forward(params, cfg, x, positions))


# ---------------------------------------------------------------------------
# paged decode (per-slot positions — the serving path, DESIGN §14)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, device):
    """{f"l{i}": {"k_pages", "v_pages": (n_periods, n_pages, page_size,
    KV, hd)}} — the reference's stacked layout.  Attention layers share a
    page pool with no slot axis, so ``n_slots`` sizes nothing here."""
    np_ = n_periods(cfg)
    dt = dtype_of(cfg.param_dtype)

    def stacked():
        one = init_paged_attn_cache(n_pages, page_size, cfg.n_kv_heads,
                                    cfg.head_dim_, dt, device)
        return {name: pool.expand((np_,) + pool.shape).clone()
                for name, pool in one.items()}

    return {f"l{i}": stacked() for i in range(len(period_spec(cfg)))}


def _layer_decode_paged(lp: LayerParams, cc, x, positions, page_table,
                        cfg: ModelConfig, mixer: str, rope_fn):
    h = rms_norm(x, lp.norm1, cfg.norm_eps)
    h, cc = attn_decode_paged(lp.mixer, cc, h, positions, page_table,
                              n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                              head_dim=cfg.head_dim_, rope_fn=rope_fn,
                              attn_softcap=cfg.attn_softcap,
                              window=_window(cfg, mixer))
    x = x + h
    h = rms_norm(x, lp.norm2, cfg.norm_eps)
    mlp = lp.mlp
    return x + (F.silu(h @ mlp.w1) * (h @ mlp.w3)) @ mlp.w2


@torch.inference_mode()
def paged_decode_step(params: TransformerParams, cfg: ModelConfig, cache,
                      tokens, positions, page_table, advance=None):
    """tokens: (S, 1); positions: (S,) int32 per-slot write positions;
    page_table: (S, max_pages) int32 -> (logits (S, 1, V), cache).

    ``advance`` ((S,) bool or None) is accepted for the reference's
    signature: it freezes recurrent per-slot state, and a dense model has
    none — a non-advancing slot's attention write lands in the scratch page
    either way.  The cache is updated in place and returned.  The paged
    cache never wraps: the scheduler keeps prompt + max_new_tokens <=
    max_pages * page_size per slot.
    """
    spec = period_spec(cfg)
    rope_fn = make_rope_fn(cfg)
    x = embed_tokens(params, cfg, tokens)
    for p, period in enumerate(params.periods):
        for i, (mixer, _) in enumerate(spec):
            cc = {name: pool[p] for name, pool in cache[f"l{i}"].items()}
            x = _layer_decode_paged(period[f"l{i}"], cc, x, positions,
                                    page_table, cfg, mixer, rope_fn)
    return logits_from_hidden(params, cfg, x), cache


def reset_slot(cache, slot: int):
    """Recycle slot ``slot``.  The reference zeroes the slot's recurrent
    (non-paged) state; a dense model's cache holds only paged pools, whose
    freed pages the allocator reclaims and length masks never read, so
    there is nothing to do."""
    return cache
