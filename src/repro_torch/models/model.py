"""build_model(cfg) — the port's uniform model API.

API:
  init(seed)                                            -> params
  loss_fn(params, batch)                                -> scalar
  apply(params, batch)                                  -> logits (B, S, V)
  param_tree(params)                                    -> reference tree
  params_from_tree(tree)                                -> params (aliasing)
  init_cache(params, batch, buf_len)                    -> rotating cache
  decode_step(params, cache, tokens, pos)               -> (logits, cache)
  init_paged_cache(params, n_slots, n_pages, page_size) -> paged cache
  paged_decode_step(params, cache, tokens, positions, page_table,
                    advance=None)                       -> (logits, cache)
  reset_slot(cache, slot)                               -> cache

A batch is ``{"tokens", "labels", "mask"}`` for one learner, as in the
reference.  ``param_tree`` / ``params_from_tree`` carry parameters to and
from the reference's tree layout, which is the layout of the trainer's
flat store: ``MultiLearnerTrainer(api.loss_fn, ...,
params_from_tree=api.params_from_tree)`` trains the model on views of that
store.  The text families dense, moe and hybrid are ported; the ssm
(xLSTM), vlm and audio families come with ROADMAP slice 5b and raise
``NotImplementedError``.  Everything runs on ``api.device``, which is
``cuda`` unless the caller passed ``device="cpu"``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import convert, transformer
from .layers import cross_entropy


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable
    init_cache: Callable
    decode_step: Callable
    has_decode: bool
    init_paged_cache: Callable
    paged_decode_step: Callable
    reset_slot: Callable
    loss_fn: Callable
    apply: Callable
    param_tree: Callable
    params_from_tree: Callable


def build_model(cfg: ModelConfig, device=None) -> ModelAPI:
    dev = resolve_device(device)
    transformer.period_spec(cfg)          # raises for unported families

    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_params(cfg, gen)

    def apply(params, batch):
        return transformer.apply(params, cfg, batch["tokens"])

    def loss_fn(params, batch):
        return cross_entropy(apply(params, batch), batch["labels"],
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

    return ModelAPI(cfg=cfg, device=dev, init=init, init_cache=init_cache,
                    decode_step=decode_step, has_decode=True,
                    init_paged_cache=init_paged_cache,
                    paged_decode_step=paged_decode_step,
                    reset_slot=transformer.reset_slot,
                    loss_fn=loss_fn, apply=apply,
                    param_tree=convert.transformer_tree,
                    params_from_tree=params_from_tree)
