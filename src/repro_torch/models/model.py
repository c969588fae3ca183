"""build_model(cfg) — the port's uniform model API (serving slice).

API:
  init(seed)                                            -> params
  init_paged_cache(params, n_slots, n_pages, page_size) -> paged cache
  paged_decode_step(params, cache, tokens, positions, page_table,
                    advance=None)                       -> (logits, cache)
  reset_slot(cache, slot)                               -> cache

Only the dense text family is ported; training (``loss_fn``, ``apply``)
and the rotating-buffer ``decode_step`` of ``repro.models.model`` come
with later slices.  Everything runs on ``api.device``, which is ``cuda``
unless the caller passed ``device="cpu"``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import transformer


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable
    init_paged_cache: Callable
    paged_decode_step: Callable
    reset_slot: Callable


def build_model(cfg: ModelConfig, device=None) -> ModelAPI:
    dev = resolve_device(device)
    transformer.period_spec(cfg)          # raises for unported families

    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_params(cfg, gen)

    def init_paged_cache(params, n_slots, n_pages, page_size):
        return transformer.init_paged_cache(cfg, n_slots, n_pages, page_size,
                                            dev)

    def paged_decode_step(params, cache, tokens, positions, page_table,
                          advance=None):
        return transformer.paged_decode_step(params, cfg, cache, tokens,
                                             positions, page_table, advance)

    return ModelAPI(cfg=cfg, device=dev, init=init,
                    init_paged_cache=init_paged_cache,
                    paged_decode_step=paged_decode_step,
                    reset_slot=transformer.reset_slot)
