"""Encoder-decoder transformer (the seamless-m4t-large-v2 backbone) — the
port of ``repro/models/encdec.py``.

Encoder: bidirectional self-attention over frame embeddings that stand in
for the speech frontend (mel + conformer), as in the reference.  Decoder:
causal self-attention, cross-attention to the encoder's output, SwiGLU,
over text tokens.  Serving: ``init_cache`` runs the encoder once and keeps
each decoder layer's cross K/V; ``decode_step`` appends one token to a
rotating self-attention buffer (``attn_decode``) and attends to those K/V.
Under a model axis (``decode_step(seq_shard=)``, ``launch/train.py``)
both caches are cut on their time dim: the self-attention buffer's W and
the cross K/V's encoder length, each attention a softmax over the rank's
slice whose partials are merged across the ranks.

Parameters are ``nn.Module``s in the reference's layout: layer l's
``self_attn.wq`` is the reference's ``dec_layers/self_attn/wq[l]``.
Frames come in the compute dtype.  Caches are updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import (AttnParams, attn_cross_decode_sharded, attn_decode,
                        attn_decode_sharded, attn_forward, init_attn_cache,
                        init_attn_params)
from .layers import dense_init, dtype_of, embed_init, rms_norm, swiglu
from .transformer import MLPParams, embed_tokens, make_rope_fn

__all__ = ["EncLayerParams", "DecLayerParams", "EncDecParams",
           "init_params", "encode", "decode_train", "apply", "init_cache",
           "cross_kv", "decode_step"]


class EncLayerParams(nn.Module):
    """norm1; attn (AttnParams); norm2; mlp (MLPParams)."""

    def __init__(self, attn: AttnParams, mlp: MLPParams, norm1, norm2):
        super().__init__()
        self.attn = attn
        self.mlp = mlp
        self.norm1 = nn.Parameter(norm1)
        self.norm2 = nn.Parameter(norm2)


class DecLayerParams(nn.Module):
    """norm1; self_attn; norm_x; cross_attn; norm2; mlp."""

    def __init__(self, cross_attn: AttnParams, mlp: MLPParams, norm1, norm2,
                 norm_x, self_attn: AttnParams):
        super().__init__()
        self.cross_attn = cross_attn
        self.mlp = mlp
        self.norm1 = nn.Parameter(norm1)
        self.norm2 = nn.Parameter(norm2)
        self.norm_x = nn.Parameter(norm_x)
        self.self_attn = self_attn


class EncDecParams(nn.Module):
    """embed (V, d); enc_layers; enc_norm (d,); dec_layers; final_norm
    (d,); lm_head (d, V)."""

    def __init__(self, embed, enc_layers, enc_norm, dec_layers, final_norm,
                 lm_head):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_norm = nn.Parameter(enc_norm)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = nn.Parameter(lm_head)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> EncDecParams:
    """Random weights drawn from ``gen`` on ``gen.device`` (the reference's
    distributions, not its draws)."""
    dt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=dev)

    def attn():
        return init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim_, dt)

    def ff():
        return MLPParams(dense_init(gen, d, cfg.d_ff, dt),
                         dense_init(gen, d, cfg.d_ff, dt),
                         dense_init(gen, cfg.d_ff, d, dt))

    embed = embed_init(gen, cfg.padded_vocab, d, dt)
    enc = [EncLayerParams(attn(), ff(), zeros(), zeros())
           for _ in range(cfg.enc_layers)]
    dec = [DecLayerParams(cross_attn=attn(), mlp=ff(), norm1=zeros(),
                          norm2=zeros(), norm_x=zeros(), self_attn=attn())
           for _ in range(cfg.n_layers)]
    return EncDecParams(embed, enc, zeros(), dec, zeros(),
                        dense_init(gen, d, cfg.padded_vocab, dt))


def _attn_kw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, chunk=cfg.attn_chunk,
                use_pallas=cfg.use_pallas)


def _ff(lp, x, cfg: ModelConfig):
    f = lp.mlp
    return x + swiglu(rms_norm(x, lp.norm2, cfg.norm_eps), f.w1, f.w3, f.w2)


def encode(params: EncDecParams, cfg: ModelConfig, frames):
    """frames: (B, S_enc, d) frame embeddings -> memory (B, S_enc, d)."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    rope_fn = make_rope_fn(cfg)
    x = frames
    for lp in params.enc_layers:
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        x = x + attn_forward(lp.attn, h, rope_fn=rope_fn, q_positions=pos,
                             causal=False, **_attn_kw(cfg))
        x = _ff(lp, x, cfg)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def decode_train(params: EncDecParams, cfg: ModelConfig, tokens, memory):
    """tokens: (B, S_dec); memory: (B, S_enc, d) -> logits (B, S_dec, V)."""
    x = embed_tokens(params, cfg, tokens)
    pos = torch.arange(x.shape[1], device=x.device)
    rope_fn = make_rope_fn(cfg)
    for lp in params.dec_layers:
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        x = x + attn_forward(lp.self_attn, h, rope_fn=rope_fn,
                             q_positions=pos, causal=True, **_attn_kw(cfg))
        h = rms_norm(x, lp.norm_x, cfg.norm_eps)
        x = x + attn_forward(lp.cross_attn, h, rope_fn=rope_fn,
                             q_positions=pos, kv_input=memory, causal=False,
                             **_attn_kw(cfg))
        x = _ff(lp, x, cfg)
    return rms_norm(x, params.final_norm, cfg.norm_eps) @ params.lm_head


def apply(params: EncDecParams, cfg: ModelConfig, frames, tokens):
    return decode_train(params, cfg, tokens, encode(params, cfg, frames))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cross_kv(lp: DecLayerParams, cfg: ModelConfig, memory):
    """Decoder layer ``lp``'s cross K/V of ``memory`` (B, S_enc, d): each
    (B, S_enc, KV, hd) in the parameters' dtype, the keys rotated at
    0..S_enc-1."""
    B, Sk, _ = memory.shape
    dt = dtype_of(cfg.param_dtype)
    rope_fn = make_rope_fn(cfg)
    shape = (B, Sk, cfg.n_kv_heads, cfg.head_dim_)
    k = (memory @ lp.cross_attn.wk).reshape(shape)
    if rope_fn is not None:
        k = rope_fn(k, torch.arange(Sk, device=memory.device))
    return k.to(dt), (memory @ lp.cross_attn.wv).reshape(shape).to(dt)


@torch.inference_mode()
def init_cache(params: EncDecParams, cfg: ModelConfig, frames,
               buf_len: int):
    """Runs the encoder once.  -> {"cross": {"xk", "xv": (n_layers, B,
    S_enc, KV, hd)} (the keys rotated at 0..S_enc-1), "self": the rotating
    buffer of ``init_attn_cache`` stacked over the decoder layers}."""
    memory = encode(params, cfg, frames)
    dt = dtype_of(cfg.param_dtype)
    kv = [cross_kv(lp, cfg, memory) for lp in params.dec_layers]
    one = init_attn_cache(memory.shape[0], buf_len, cfg.n_kv_heads,
                          cfg.head_dim_, dt, memory.device)
    return {"cross": {"xk": torch.stack([k for k, _ in kv]),
                      "xv": torch.stack([v for _, v in kv])},
            "self": {name: x.expand((cfg.n_layers,) + x.shape).clone()
                     for name, x in one.items()}}


@torch.inference_mode()
def decode_step(params: EncDecParams, cfg: ModelConfig, cache, tokens, pos,
                seq_shard=None):
    """tokens: (B, 1); pos: int, the position every sequence writes at.
    -> (logits (B, 1, V), cache; its self-attention buffer updated in
    place).

    ``seq_shard`` (the sequence-sharded decode, ``launch/train.py``): an
    object with ``rank``, ``size`` and ``merge(m, l, o)``; ``cache`` is
    then this rank's slice of both caches (the self-attention buffer's
    rows [rank W/size, (rank + 1) W/size), ``slot_pos`` whole; the cross
    K/V's encoder positions [rank S/size, (rank + 1) S/size)), and each
    decoder layer merges two attentions' partials: the self-attention's
    (``attn_decode_sharded``), then the cross-attention's, whose query
    reads the first one's output (``attn_cross_decode_sharded``)."""
    pos = int(pos)
    x = embed_tokens(params, cfg, tokens)
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    rope_fn = make_rope_fn(cfg)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, rope_fn=rope_fn)
    for l, lp in enumerate(params.dec_layers):
        cc = {name: t[l] for name, t in cache["self"].items()}
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        if seq_shard is None:
            h, _ = attn_decode(lp.self_attn, cc, h, pos, **kw)
        else:
            h, _ = attn_decode_sharded(
                lp.self_attn, cc, h, pos, attn_softcap=0.0,
                rank=seq_shard.rank, size=seq_shard.size,
                merge=seq_shard.merge, **kw)
        x = x + h
        # cross-attention against the memory's K/V (no cache update)
        h = rms_norm(x, lp.norm_x, cfg.norm_eps)
        xk, xv = cache["cross"]["xk"][l], cache["cross"]["xv"][l]
        if seq_shard is not None:
            x = x + attn_cross_decode_sharded(lp.cross_attn, xk, xv, h, pos,
                                              merge=seq_shard.merge, **kw)
            x = _ff(lp, x, cfg)
            continue
        q = (h @ lp.cross_attn.wq).reshape(B, 1, H, hd)
        if rope_fn is not None:
            q = rope_fn(q, posv)
        qg = q.reshape(B, KV, H // KV, hd)
        s = torch.einsum("bkgd,bwkd->bkgw", qg.float(),
                         xk.float()) * hd ** -0.5
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgw,bwkd->bkgd", p, xv.float())
        x = x + o.reshape(B, 1, H * hd).to(x.dtype) @ lp.cross_attn.wo
        x = _ff(lp, x, cfg)
    return (rms_norm(x, params.final_norm, cfg.norm_eps) @ params.lm_head,
            cache)
