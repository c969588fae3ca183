"""build_model(cfg) — the port's uniform model API.

API:
  init(seed)                                            -> params
  loss_fn(params, batch)                                -> scalar
  apply(params, batch)                                  -> logits
  param_tree(params)                                    -> reference tree
  params_from_tree(tree)                                -> params (aliasing)
  train_batch_spec(global_batch, seq)                   -> {name: (shape,
                                                            dtype)}
  init_cache(params, batch, buf_len)                    -> rotating cache
  decode_step(params, cache, tokens, pos)               -> (logits, cache)
  init_paged_cache(params, n_slots, n_pages, page_size) -> paged cache
  paged_decode_step(params, cache, tokens, positions, page_table,
                    advance=None)                       -> (logits, cache)
  reset_slot(cache, slot)                               -> cache

Families, as in the reference:
  text (dense | moe | ssm | hybrid): batch = {tokens, labels, mask}; served
         by the paged decode (``has_paged``).
  vlm:   batch += patch_embeds (B, P, d), the stand-in for the vision
         tower, put before the text at M-RoPE positions (image patches on
         a grid at t = 0, text after it); the loss is over the text only,
         whose length is seq - P.  Decoded through ``decode_step``.
  audio: encoder-decoder; batch = {frames (B, seq/2, d), tokens / labels
         / mask (B, seq/2)}; ``init_cache(params, frames, buf_len)`` runs
         the encoder.  Decoded through ``decode_step``.
vlm and audio have no paged decode in the reference, so their
``has_paged`` is False and their paged entry points are None; nor does
the reference's flash route run them, so ``use_pallas`` raises
``ValueError`` for them.

``param_tree`` / ``params_from_tree`` carry parameters to and from the
reference's tree layout, which is the layout of the trainer's flat store:
``MultiLearnerTrainer(api.loss_fn, ..., params_from_tree=
api.params_from_tree)`` trains the model on views of that store.
Everything runs on ``api.device``, which is ``cuda`` unless the caller
passed ``device="cpu"``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .. import obs
from ..configs.base import ModelConfig
from ..device import resolve_device
from . import convert, encdec, transformer
from .layers import cross_entropy, dtype_of


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable
    init_cache: Callable
    decode_step: Callable
    has_decode: bool
    init_paged_cache: Optional[Callable]
    paged_decode_step: Optional[Callable]
    reset_slot: Optional[Callable]
    loss_fn: Callable
    apply: Callable
    param_tree: Callable
    params_from_tree: Callable
    train_batch_spec: Callable
    has_paged: bool


def _mrope_positions(cfg: ModelConfig, P: int, S_text: int, device=None):
    """(3, P + S_text) int32 (t, h, w) ids: the P image patches on a
    g x g grid (g = floor(sqrt(P))) at t = 0, the text tokens after it,
    each of t, h and w at base + i (the qwen2-vl scheme)."""
    g = max(1, int(math.sqrt(P)))
    i32 = torch.int32
    idx = torch.arange(P, dtype=i32, device=device)
    base = max((P - 1) // g, min(g, P) - 1, 0) + 1
    t_txt = base + torch.arange(S_text, dtype=i32, device=device)
    return torch.stack([
        torch.cat([torch.zeros((P,), dtype=i32, device=device), t_txt]),
        torch.cat([idx // g, t_txt]),
        torch.cat([idx % g, t_txt])])


def _text_spec(B: int, S: int):
    return {"labels": ((B, S), torch.int32),
            "mask": ((B, S), torch.float32),
            "tokens": ((B, S), torch.int32)}


def _n_patches(cfg: ModelConfig) -> int:
    return cfg.n_frontend_tokens if cfg.family == "vlm" else 0


def _text_positions(cfg: ModelConfig, batch):
    """The positions a text (or vlm) batch runs at: 0..S-1 (each of t, h,
    w under M-RoPE), a vlm's patches and text at their M-RoPE ids."""
    S, dev = batch["tokens"].shape[1], batch["tokens"].device
    P = _n_patches(cfg)
    if P:
        return _mrope_positions(cfg, P, S, dev)
    pos = torch.arange(S, device=dev)
    return pos.expand(3, -1) if cfg.mrope_sections else pos


def _text_embed(params, cfg: ModelConfig, batch):
    """The input embeddings (B, P + S, d): a vlm's patch embeddings, then
    the tokens'.  ``params``: anything with ``embed``."""
    x = transformer.embed_tokens(params, cfg, batch["tokens"])
    if _n_patches(cfg):
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def _text_loss(params, cfg: ModelConfig, x, batch):
    """The masked cross-entropy over the text of the final hidden states
    ``x``.  ``params``: anything with ``embed``, ``final_norm``,
    ``lm_head``."""
    with obs.span("model.head"):
        logits = transformer.logits_from_hidden(params, cfg, x)
        return cross_entropy(logits[:, _n_patches(cfg):], batch["labels"],
                             batch.get("mask"), logical_vocab=cfg.vocab)


def build_model(cfg: ModelConfig, device=None) -> ModelAPI:
    dev = resolve_device(device)
    act_dt = dtype_of(cfg.compute_dtype)
    if cfg.use_pallas and cfg.family in ("vlm", "audio"):
        needs = ("M-RoPE mask positions" if cfg.family == "vlm"
                 else "cross-attention")
        raise ValueError(
            f"{cfg.name}: use_pallas runs self-attention at positions "
            f"contiguous from 0, and the {cfg.family} family needs {needs}; "
            "the reference's flash route fails here too")
    if cfg.family == "audio":
        return _audio(cfg, dev, act_dt)

    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_params(cfg, gen)

    def hidden(params, batch):
        return transformer.forward(params, cfg, _text_embed(params, cfg,
                                                            batch),
                                   _text_positions(cfg, batch))

    if cfg.family == "vlm":
        P = cfg.n_frontend_tokens

        def apply(params, batch):
            return transformer.logits_from_hidden(params, cfg,
                                                  hidden(params, batch))

        def train_batch_spec(global_batch, seq):
            return {**_text_spec(global_batch, seq - P),
                    "patch_embeds": ((global_batch, P, cfg.d_model),
                                     act_dt)}
    else:
        def apply(params, batch):
            return transformer.apply(params, cfg, batch["tokens"])

        def train_batch_spec(global_batch, seq):
            return _text_spec(global_batch, seq)

    def loss_fn(params, batch):
        # period_loss's post(body(... pre(batch))) over the periods
        return _text_loss(params, cfg, hidden(params, batch), batch)

    def init_cache(params, batch_size, buf_len):
        return transformer.init_cache(cfg, batch_size, buf_len, dev)

    def decode_step(params, cache, tokens, pos):
        return transformer.decode_step(params, cfg, cache, tokens, pos)

    def init_paged_cache(params, n_slots, n_pages, page_size):
        return transformer.init_paged_cache(cfg, n_slots, n_pages, page_size,
                                            dev)

    def paged_decode_step(params, cache, tokens, positions, page_table,
                          advance=None):
        return transformer.paged_decode_step(params, cfg, cache, tokens,
                                             positions, page_table, advance)

    def params_from_tree(tree):
        return convert.transformer_from_tree(tree, cfg)

    paged = cfg.family != "vlm"
    return ModelAPI(cfg=cfg, device=dev, init=init, init_cache=init_cache,
                    decode_step=decode_step, has_decode=True,
                    init_paged_cache=init_paged_cache if paged else None,
                    paged_decode_step=paged_decode_step if paged else None,
                    reset_slot=transformer.reset_slot if paged else None,
                    loss_fn=loss_fn, apply=apply,
                    param_tree=convert.transformer_tree,
                    params_from_tree=params_from_tree,
                    train_batch_spec=train_batch_spec, has_paged=paged)


class PeriodLoss(NamedTuple):
    """A transformer-family model's ``loss_fn`` cut at its period
    boundaries, each piece a function of plain tensors (``torch.func``
    transforms them): ``positions(batch)``; ``pre(rest, batch) -> x0``
    (the embedding, and a vlm's patch embeddings before it); ``body(period,
    x, positions) -> x`` (one period); ``post(rest, x, batch) -> loss``
    (final norm, head, the masked cross-entropy over the text).  ``rest``
    is the tree's non-period leaves ({"embed", "final_norm"[,
    "lm_head"]}), ``period`` one period's tree (leaves without the period
    dim).  ``post(rest, body(...body(pre(rest, b))...), b)`` over the
    periods in order is ``loss_fn`` on the same leaves."""
    positions: Callable
    pre: Callable
    body: Callable
    post: Callable


def period_loss(cfg: ModelConfig) -> PeriodLoss:
    """``PeriodLoss`` of a transformer-family ``cfg`` (text or vlm): the
    pieces ``build_model``'s ``loss_fn`` is made of."""
    from types import SimpleNamespace
    from .convert import period_layers
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: an encoder-decoder has no periods")
    rope_fn = transformer.make_rope_fn(cfg)

    def head(rest):
        return SimpleNamespace(embed=rest["embed"],
                               final_norm=rest["final_norm"],
                               lm_head=rest.get("lm_head"))

    def positions(batch):
        return _text_positions(cfg, batch)

    def pre(rest, batch):
        return _text_embed(head(rest), cfg, batch)

    def body(period, x, pos):
        return transformer._period_forward(period_layers(period), x, cfg,
                                           rope_fn, pos)

    def post(rest, x, batch):
        return _text_loss(head(rest), cfg, x, batch)

    return PeriodLoss(positions, pre, body, post)


def _audio(cfg: ModelConfig, dev, act_dt) -> ModelAPI:
    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return encdec.init_params(cfg, gen)

    def apply(params, batch):
        return encdec.apply(params, cfg, batch["frames"], batch["tokens"])

    def loss_fn(params, batch):
        return cross_entropy(apply(params, batch), batch["labels"],
                             batch.get("mask"), logical_vocab=cfg.vocab)

    def init_cache(params, frames, buf_len):
        return encdec.init_cache(params, cfg, frames, buf_len)

    def decode_step(params, cache, tokens, pos):
        return encdec.decode_step(params, cfg, cache, tokens, pos)

    def train_batch_spec(global_batch, seq):
        s = seq // 2
        return {**_text_spec(global_batch, s),
                "frames": ((global_batch, s, cfg.d_model), act_dt)}

    def params_from_tree(tree):
        return convert.encdec_from_tree(tree, cfg)

    return ModelAPI(cfg=cfg, device=dev, init=init, init_cache=init_cache,
                    decode_step=decode_step, has_decode=True,
                    init_paged_cache=None, paged_decode_step=None,
                    reset_slot=None, loss_fn=loss_fn, apply=apply,
                    param_tree=convert.encdec_tree,
                    params_from_tree=params_from_tree,
                    train_batch_spec=train_batch_spec, has_paged=False)


def make_synthetic_batch(cfg: ModelConfig, seed: int, global_batch: int,
                         seq: int, device=None):
    """A random batch of ``train_batch_spec``'s shapes, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device: tokens and
    labels uniform over the vocabulary, masks of ones, embeddings N(0,
    0.1^2) in the compute dtype (the reference's law; its ``jax.random``
    draws differ)."""
    dev = resolve_device(device)
    spec = build_model(cfg, dev).train_batch_spec(global_batch, seq)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {}
    for name, (shape, dtype) in sorted(spec.items()):
        if name == "mask":
            batch[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif dtype == torch.int32:
            batch[name] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                        device=dev, dtype=dtype)
        else:
            batch[name] = torch.randn(shape, generator=gen,
                                      device=dev).to(dtype) * 0.1
    return batch
