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

    if cfg.family == "vlm":
        P = cfg.n_frontend_tokens

        def apply(params, batch):
            pos = _mrope_positions(cfg, P, batch["tokens"].shape[1], dev)
            return transformer.apply(params, cfg, batch["tokens"],
                                     positions=pos,
                                     extra_embeds=batch["patch_embeds"])

        def logits_for_loss(params, batch):
            return apply(params, batch)[:, P:]

        def train_batch_spec(global_batch, seq):
            return {**_text_spec(global_batch, seq - P),
                    "patch_embeds": ((global_batch, P, cfg.d_model),
                                     act_dt)}
    else:
        def apply(params, batch):
            return transformer.apply(params, cfg, batch["tokens"])

        logits_for_loss = apply

        def train_batch_spec(global_batch, seq):
            return _text_spec(global_batch, seq)

    def loss_fn(params, batch):
        return cross_entropy(logits_for_loss(params, batch), batch["labels"],
                             batch.get("mask"), logical_vocab=cfg.vocab)

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
