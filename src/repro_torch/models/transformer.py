"""Decoder-only LM — the port of ``repro/models/transformer.py``:
training/prefill forward (``apply``, through chunked attention or, with
``cfg.use_pallas``, the flash kernel), the rotating-buffer decode
(``init_cache`` / ``decode_step``) and the paged decode that serves.

Depth is n_periods x period as in the reference: a period is the repeating
block pattern (dense: [attn]; gemma2: [local, global]; jamba: 7 mamba + 1
attention with MoE every 2nd layer; xlstm: [mLSTM, sLSTM]).  A layer is
(mixer, mlp) with mixer in {attn, attn_local, mamba, mlstm, slstm} and mlp
in {dense, moe, none}: an xLSTM block carries its own norms, projections
and residuals (``models/xlstm.py``), so its layer has no ``norm2`` and no
``mlp``, and its ``norm1`` is a leaf that no block reads (kept, as in the
reference, so the flat store's leaves line up).  Parameters are
``nn.Module``s holding ``nn.Parameter``s in the reference's layout
(``periods[p]["l0"].mixer.wq`` is the reference's ``periods/l0/mixer/wq[p]``);
the functions below take them as arguments, mirroring the reference's pure
functions.  Under M-RoPE (qwen2-vl) positions are (3, S) (t, h, w) ids:
they rotate q and k, and their t row masks.

A learner whose weights lie sharded over a model group (``launch/``)
passes a parameter object with a ``gather_period`` hook
(``convert.PeriodParams``): ``forward`` and ``decode_step`` then ask it
for period p's layers when they reach period p, and with gradients on
``forward`` runs each period under non-reentrant
``torch.utils.checkpoint``, the gather inside: the backward gathers the
period again, then its gradient leaves through the hook's own backward
(the twin of the reference's remat per period).  ``decode_step``'s
``seq_shard`` runs the sequence-sharded decode (the buffer's time dim
over the model group, ``attention.attn_decode_sharded``).

Caches are dicts {f"l{i}": {leaf: (n_periods, ...)}} in the reference's
stacked layout and are updated IN PLACE (the reference donates them to a
jitted step and gets fresh buffers back).  Recurrent layers (mamba, mlstm,
slstm) keep per-slot state with the slot on axis 1; attention layers of
the paged cache share page pools with no slot axis.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..configs.base import ModelConfig
from .attention import (attn_decode, attn_decode_paged,
                        attn_decode_sharded, attn_forward, init_attn_cache,
                        init_attn_params, init_paged_attn_cache)
from .layers import (apply_mrope, apply_rope, dense_init, dtype_of,
                     embed_init, rms_norm, softcap, swiglu, weak_scalar)
from .mamba import (init_mamba_cache, init_mamba_params, mamba_decode,
                    mamba_forward)
from .moe import init_moe_params, moe_forward
from .moe_shardmap import moe_forward_shardmap, shardmap_applicable
from .xlstm import (init_mlstm_cache, init_mlstm_params, init_slstm_cache,
                    init_slstm_params, mlstm_block_decode,
                    mlstm_block_forward, slstm_block_decode,
                    slstm_block_forward)

PAGED = ("k_pages", "v_pages")
XLSTM = ("mlstm", "slstm")


# ---------------------------------------------------------------------------
# period spec
# ---------------------------------------------------------------------------

def period_spec(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    if cfg.block_period:
        spec = []
        for i, mixer in enumerate(cfg.block_period):
            if cfg.attn_layer_offset >= 0 and i == cfg.attn_layer_offset:
                mixer = "attn"
            if mixer in XLSTM:
                mlp = "none"
            elif cfg.n_experts and cfg.moe_every and (i % cfg.moe_every
                                                      == cfg.moe_every - 1):
                mlp = "moe"
            else:
                mlp = "dense"
            spec.append((mixer, mlp))
        return tuple(spec)
    mlp = "moe" if cfg.n_experts else "dense"
    if cfg.attn_pattern == "local_global":
        return (("attn_local", mlp), ("attn", mlp))
    if cfg.attn_pattern == "sliding":
        return (("attn_local", mlp),)
    return (("attn", mlp),)


def n_periods(cfg: ModelConfig) -> int:
    p = len(period_spec(cfg))
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"whole number of {p}-layer periods")
    return cfg.n_layers // p


def make_rope_fn(cfg: ModelConfig):
    """(x, positions) -> x rotated; positions are (3, ...) (t, h, w) ids
    under M-RoPE.  None for a model without RoPE."""
    if not cfg.use_rope:
        return None
    if cfg.mrope_sections:
        return lambda x, pos: apply_mrope(x, pos, cfg.rope_theta,
                                          cfg.mrope_sections)
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
    """norm1; mixer (AttnParams, MambaParams, MLSTMParams or SLSTMParams);
    norm2 and mlp (MLPParams or MoEParams), both None for an xLSTM layer,
    whose block has its own."""

    def __init__(self, norm1, mixer: nn.Module, norm2=None,
                 mlp: nn.Module = None):
        super().__init__()
        self.norm1 = nn.Parameter(norm1)
        self.mixer = mixer
        self.norm2 = None if norm2 is None else nn.Parameter(norm2)
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


def _init_layer(gen: torch.Generator, cfg: ModelConfig, mixer: str,
                mlp: str) -> LayerParams:
    dt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    if mixer in ("attn", "attn_local"):
        mix = init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim_, dt)
    elif mixer == "mamba":
        mix = init_mamba_params(gen, d, expand=cfg.ssm_expand,
                                state=cfg.ssm_state, conv=cfg.ssm_conv,
                                dtype=dt)
    elif mixer == "mlstm":
        mix = init_mlstm_params(gen, d, cfg.n_heads, dt)
    elif mixer == "slstm":
        mix = init_slstm_params(gen, d, cfg.n_heads, dt)
    else:
        raise ValueError(mixer)
    norm1 = torch.zeros((d,), dtype=torch.float32, device=dev)
    if mlp == "none":
        return LayerParams(norm1, mix)
    if mlp == "moe":
        ffn = init_moe_params(gen, d, cfg.d_ff, cfg.n_experts, dt)
    else:
        ffn = MLPParams(dense_init(gen, d, cfg.d_ff, dt),
                        dense_init(gen, d, cfg.d_ff, dt),
                        dense_init(gen, cfg.d_ff, d, dt))
    return LayerParams(norm1, mix,
                       torch.zeros((d,), dtype=torch.float32, device=dev),
                       ffn)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> TransformerParams:
    """Random weights drawn from ``gen`` on ``gen.device`` (the reference's
    distributions; not its draws, which come from ``jax.random``)."""
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    spec = period_spec(cfg)
    embed = embed_init(gen, cfg.padded_vocab, d, dt)
    periods = [{f"l{i}": _init_layer(gen, cfg, mixer, mlp)
                for i, (mixer, mlp) in enumerate(spec)}
               for _ in range(n_periods(cfg))]
    head = (None if cfg.tie_embeddings
            else dense_init(gen, d, cfg.padded_vocab, dt))
    return TransformerParams(
        embed, periods, torch.zeros((d,), dtype=torch.float32,
                                    device=gen.device), head)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: TransformerParams, cfg: ModelConfig, tokens):
    with obs.span("model.embed"):
        scale = weak_scalar(math.sqrt(cfg.d_model), params.embed.dtype)
        return params.embed[tokens.long()] * scale


def logits_from_hidden(params: TransformerParams, cfg: ModelConfig, x):
    h = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return softcap(h @ head, cfg.final_softcap)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _mlp(lp: LayerParams, x, cfg: ModelConfig, mlp: str):
    """The layer's FFN half: x + mlp(rms_norm(x)) (x itself for "none").
    ``moe_backend`` "shard_map" takes the expert-parallel all-to-all
    (``models/moe_shardmap.py``) under a mesh whose model axis divides the
    experts and the sequence, and the einsum path otherwise (one device,
    no model axis), as the reference does."""
    if mlp == "none":
        return x
    with obs.span("model.moe" if mlp == "moe" else "model.mlp"):
        h = rms_norm(x, lp.norm2, cfg.norm_eps)
        if mlp == "moe":
            if cfg.moe_backend == "shard_map" and shardmap_applicable(
                    cfg.n_experts, h.shape[1]):
                return x + moe_forward_shardmap(
                    lp.mlp, h, n_experts=cfg.n_experts,
                    top_k=cfg.experts_per_tok,
                    capacity_factor=cfg.capacity_factor)
            return x + moe_forward(lp.mlp, h, n_experts=cfg.n_experts,
                                   top_k=cfg.experts_per_tok,
                                   capacity_factor=cfg.capacity_factor)
        f = lp.mlp
        return x + swiglu(h, f.w1, f.w3, f.w2)


def _mamba_kw(cfg: ModelConfig):
    return dict(expand=cfg.ssm_expand, state=cfg.ssm_state,
                conv=cfg.ssm_conv)


_XLSTM_FORWARD = {"mlstm": mlstm_block_forward, "slstm": slstm_block_forward}
_XLSTM_DECODE = {"mlstm": mlstm_block_decode, "slstm": slstm_block_decode}


def _layer_forward(lp: LayerParams, x, cfg: ModelConfig, mixer: str,
                   mlp: str, rope_fn, positions):
    if mixer in XLSTM:
        with obs.span("model.xlstm"):
            x = _XLSTM_FORWARD[mixer](lp.mixer, x, n_heads=cfg.n_heads,
                                      chunk=cfg.scan_chunk,
                                      norm_eps=cfg.norm_eps)
        return _mlp(lp, x, cfg, mlp)
    with obs.span("model.mamba" if mixer == "mamba" else "model.attn"):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if mixer == "mamba":
            x = x + mamba_forward(lp.mixer, h, scan_chunk=cfg.scan_chunk,
                                  **_mamba_kw(cfg))
        else:
            # M-RoPE: (3, S) ids rotate q and k, their t row masks
            x = x + attn_forward(lp.mixer, h, n_heads=cfg.n_heads,
                                 n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                                 rope_fn=rope_fn, q_positions=positions,
                                 window=_window(cfg, mixer),
                                 attn_softcap=cfg.attn_softcap,
                                 chunk=cfg.attn_chunk,
                                 use_pallas=cfg.use_pallas,
                                 mask_positions=(positions[0]
                                                 if cfg.mrope_sections
                                                 else None))
    return _mlp(lp, x, cfg, mlp)


def _period_forward(period, x, cfg: ModelConfig, rope_fn, positions):
    for i, (mixer, mlp) in enumerate(period_spec(cfg)):
        x = _layer_forward(period[f"l{i}"], x, cfg, mixer, mlp, rope_fn,
                           positions)
    return x


def _gathered_period_forward(gather, p: int, x, cfg, rope_fn, positions):
    return _period_forward(gather(p), x, cfg, rope_fn, positions)


def forward(params: TransformerParams, cfg: ModelConfig, x, positions):
    """x: (B, S, d) input embeddings; positions: (S,), or (3, S) under
    M-RoPE.  Returns the final hidden states (B, S, d).  The reference
    scans over stacked period parameters with a remat per period; here a
    loop over ``params.periods``, with autograd keeping each layer's
    activations -- or, when ``params`` gathers its periods
    (``gather_period``), each period gathered as it is reached and, with
    gradients on, checkpointed with its gather (module docstring)."""
    rope_fn = make_rope_fn(cfg)
    gather = getattr(params, "gather_period", None)
    for p, period in enumerate(params.periods):
        if gather is None:
            x = _period_forward(period, x, cfg, rope_fn, positions)
        elif torch.is_grad_enabled():
            x = checkpoint(_gathered_period_forward, gather, p, x, cfg,
                           rope_fn, positions, use_reentrant=False)
        else:
            x = _gathered_period_forward(gather, p, x, cfg, rope_fn,
                                         positions)
    return x


def apply(params: TransformerParams, cfg: ModelConfig, tokens,
          positions=None, extra_embeds=None):
    """tokens: (B, S) -> logits (B, S_total, V).  ``extra_embeds``: (B, P,
    d) frontend embeddings (vision patches) put before the tokens' own;
    ``positions`` default to 0..S_total-1 (each of t, h, w under
    M-RoPE)."""
    x = embed_tokens(params, cfg, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
        if cfg.mrope_sections:
            positions = positions.expand(3, -1)
    x = forward(params, cfg, x, positions)
    with obs.span("model.head"):
        return logits_from_hidden(params, cfg, x)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _stacked(cfg: ModelConfig, one):
    """A layer cache {leaf: (...)} -> {leaf: (n_periods, ...)}."""
    np_ = n_periods(cfg)
    return {name: x.expand((np_,) + x.shape).clone()
            for name, x in one.items()}


def _recurrent_cache(cfg: ModelConfig, mixer: str, batch: int, device):
    """A recurrent layer's state for ``batch`` sequences (or slots)."""
    if mixer == "mlstm":
        return init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                dtype=dtype_of(cfg.param_dtype),
                                device=device)
    if mixer == "slstm":
        return init_slstm_cache(batch, cfg.d_model, cfg.n_heads,
                                device=device)
    return init_mamba_cache(batch, cfg.d_model,
                            dtype=dtype_of(cfg.param_dtype), device=device,
                            **_mamba_kw(cfg))


def _period_cache(cache, p: int):
    """Period ``p``'s views of every layer cache."""
    return {layer: {name: x[p] for name, x in c.items()}
            for layer, c in cache.items()}


def _write_state(cc, new_cc, advance=None):
    """Write a recurrent layer's new state into its cache views.  With an
    ``advance`` mask ((S,) bool, slot on axis 0) a slot with advance=False
    keeps its old state bitwise; ``new_cc`` was computed from the old state
    before anything is written."""
    for name, old in cc.items():
        new = new_cc[name]
        if advance is not None:
            new = torch.where(
                advance.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
        old.copy_(new)


def _recurrent_decode(lp: LayerParams, cc, x, cfg: ModelConfig, mixer: str,
                      advance=None):
    """A recurrent mixer's decode step: returns x after the mixer and its
    residual, and writes the new state into ``cc`` (slots with
    advance=False keep theirs bitwise)."""
    with obs.span("model.mamba" if mixer == "mamba" else "model.xlstm"):
        if mixer == "mamba":
            h, new = mamba_decode(lp.mixer, cc, rms_norm(x, lp.norm1,
                                                         cfg.norm_eps),
                                  **_mamba_kw(cfg))
            x = x + h
        else:
            x, new = _XLSTM_DECODE[mixer](lp.mixer, cc, x,
                                          n_heads=cfg.n_heads,
                                          norm_eps=cfg.norm_eps)
        _write_state(cc, new, advance)
        return x


# ---------------------------------------------------------------------------
# rotating-buffer decode (one position shared by the batch)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, buf_len: int, device):
    """Attention layers: {"k", "v": (n_periods, B, blen, KV, hd),
    "slot_pos": (n_periods, blen) int32, -1 = empty}, blen = min(buf_len,
    window) on windowed layers; recurrent layers: their state
    (``_recurrent_cache``)."""
    dt = dtype_of(cfg.param_dtype)

    def layer(mixer):
        if mixer not in ("attn", "attn_local"):
            return _recurrent_cache(cfg, mixer, batch, device)
        blen = min(buf_len, cfg.window) if (
            mixer == "attn_local" or cfg.attn_pattern == "sliding") \
            else buf_len
        return init_attn_cache(batch, blen, cfg.n_kv_heads, cfg.head_dim_,
                               dt, device)

    return {f"l{i}": _stacked(cfg, layer(mixer))
            for i, (mixer, _) in enumerate(period_spec(cfg))}


@torch.inference_mode()
def decode_step(params: TransformerParams, cfg: ModelConfig, cache, tokens,
                pos, seq_shard=None):
    """tokens: (B, 1); pos: int, the position every sequence writes at
    (under M-RoPE the same id for t, h and w).  -> (logits (B, 1, V),
    cache updated in place).

    ``seq_shard`` (the sequence-sharded decode, ``launch/train.py``): an
    object with ``rank`` and ``size`` (this rank's slice of every
    attention buffer's time dim), ``merge(m, l, o)`` (the ranks' softmax
    partials combined) and ``state(layer, cc)`` / ``keep(layer, cc,
    full)`` (a recurrent layer's whole state from the ranks' slices, and
    this rank's slice of the new one written back); ``cache`` is then
    this rank's slice of it."""
    spec = period_spec(cfg)
    rope_fn = make_rope_fn(cfg)
    if cfg.mrope_sections and rope_fn is not None:
        mrope = rope_fn
        rope_fn = lambda xx, p: mrope(xx, p.expand((3,) + p.shape))  # noqa
    pos = int(pos)
    gather = getattr(params, "gather_period", None)
    x = embed_tokens(params, cfg, tokens)
    for p, period in enumerate(params.periods):
        if gather is not None:
            period = gather(p)
        pc = _period_cache(cache, p)
        for i, (mixer, mlp) in enumerate(spec):
            lp, cc = period[f"l{i}"], pc[f"l{i}"]
            kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                      head_dim=cfg.head_dim_, rope_fn=rope_fn,
                      attn_softcap=cfg.attn_softcap)
            if mixer in ("attn", "attn_local"):
                with obs.span("model.attn"):
                    h = rms_norm(x, lp.norm1, cfg.norm_eps)
                    if seq_shard is None:
                        h, _ = attn_decode(lp.mixer, cc, h, pos, **kw)
                    else:
                        h, _ = attn_decode_sharded(
                            lp.mixer, cc, h, pos, rank=seq_shard.rank,
                            size=seq_shard.size, merge=seq_shard.merge,
                            **kw)
                    x = x + h
            elif seq_shard is not None:
                full = seq_shard.state(f"l{i}", cc)
                x = _recurrent_decode(lp, full, x, cfg, mixer)
                seq_shard.keep(f"l{i}", cc, full)
            else:
                x = _recurrent_decode(lp, cc, x, cfg, mixer)
            x = _mlp(lp, x, cfg, mlp)
    with obs.span("model.head"):
        return logits_from_hidden(params, cfg, x), cache


# ---------------------------------------------------------------------------
# paged decode (per-slot positions — the serving path, DESIGN §14)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, device):
    """Attention layers: {"k_pages", "v_pages": (n_periods, n_pages,
    page_size, KV, hd)}, a page pool with no slot axis (the scheduler's
    page table says which pages a slot owns); recurrent layers: per-slot
    state (mamba {"conv", "h"}; mlstm {"C", "conv", "m", "n"}; slstm {"c",
    "h", "m", "n"}; slot on axis 1), position-free and recycled by
    ``reset_slot``."""
    dt = dtype_of(cfg.param_dtype)

    def layer(mixer):
        if mixer not in ("attn", "attn_local"):
            return _recurrent_cache(cfg, mixer, n_slots, device)
        return init_paged_attn_cache(n_pages, page_size, cfg.n_kv_heads,
                                     cfg.head_dim_, dt, device)

    return {f"l{i}": _stacked(cfg, layer(mixer))
            for i, (mixer, _) in enumerate(period_spec(cfg))}


def _layer_decode_paged(lp: LayerParams, cc, x, positions, page_table,
                        cfg: ModelConfig, mixer: str, mlp: str, rope_fn,
                        advance):
    if mixer in ("attn", "attn_local"):
        with obs.span("model.attn"):
            h, _ = attn_decode_paged(lp.mixer, cc,
                                     rms_norm(x, lp.norm1, cfg.norm_eps),
                                     positions, page_table,
                                     n_heads=cfg.n_heads,
                                     n_kv=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim_, rope_fn=rope_fn,
                                     attn_softcap=cfg.attn_softcap,
                                     window=_window(cfg, mixer))
            x = x + h
    else:
        x = _recurrent_decode(lp, cc, x, cfg, mixer, advance)
    return _mlp(lp, x, cfg, mlp)


@torch.inference_mode()
def paged_decode_step(params: TransformerParams, cfg: ModelConfig, cache,
                      tokens, positions, page_table, advance=None):
    """tokens: (S, 1); positions: (S,) int32 per-slot write positions;
    page_table: (S, max_pages) int32; advance: (S,) bool or None ->
    (logits (S, 1, V), cache).

    A slot with advance=False runs through the batch but keeps its
    recurrent (mamba, mlstm, slstm) state bitwise; its attention write
    lands in the scratch page, which length masks never read.  None means
    every slot advances.  The cache is updated in place and returned.  The
    paged cache never wraps: the scheduler keeps prompt + max_new_tokens
    <= max_pages * page_size per slot.  No M-RoPE: the reference serves
    the vlm family through ``decode_step`` only.
    """
    spec = period_spec(cfg)
    rope_fn = make_rope_fn(cfg)
    x = embed_tokens(params, cfg, tokens)
    for p, period in enumerate(params.periods):
        pc = _period_cache(cache, p)
        for i, (mixer, mlp) in enumerate(spec):
            x = _layer_decode_paged(period[f"l{i}"], pc[f"l{i}"], x,
                                    positions, page_table, cfg, mixer, mlp,
                                    rope_fn, advance)
    with obs.span("model.head"):
        return logits_from_hidden(params, cfg, x), cache


def reset_slot(cache, slot: int):
    """Zero slot ``slot``'s recurrent (non-paged) state in place, so a
    recycled slot starts from the initial state.  Page pools pass through:
    the allocator reclaims freed pages and length masks never read their
    stale rows."""
    with torch.inference_mode():
        for layer in cache.values():
            for name, x in layer.items():
                if name not in PAGED:
                    x[:, slot] = 0
    return cache
