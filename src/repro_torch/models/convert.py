"""Carry the reference's parameters into the port.

``params_from_jax`` takes the ``repro`` transformer's parameter pytree as
nested dicts of numpy arrays (``np.asarray`` of each leaf) and builds the
port's ``TransformerParams`` from it, so both packages can run the same
weights.  Weights keep the reference's (d_in, d_out) orientation.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .attention import AttnParams
from .transformer import (LayerParams, MLPParams, TransformerParams,
                          n_periods, period_spec)


def params_from_jax(tree, cfg: ModelConfig, device) -> TransformerParams:
    """tree: {"embed", "periods": {"l0": {"norm1", "mixer": {"wq", "wk",
    "wv", "wo"}, "norm2", "mlp": {"w1", "w3", "w2"}}}, "final_norm",
    "lm_head"}, period leaves stacked on axis 0."""
    def t(a):
        return torch.tensor(a, device=device)

    def layer(lp, p):
        m, f = lp["mixer"], lp["mlp"]
        return LayerParams(
            t(lp["norm1"][p]),
            AttnParams(t(m["wq"][p]), t(m["wk"][p]), t(m["wv"][p]),
                       t(m["wo"][p])),
            t(lp["norm2"][p]),
            MLPParams(t(f["w1"][p]), t(f["w3"][p]), t(f["w2"][p])))

    spec = period_spec(cfg)
    periods = [{f"l{i}": layer(tree["periods"][f"l{i}"], p)
                for i in range(len(spec))}
               for p in range(n_periods(cfg))]
    head = None if cfg.tie_embeddings else t(tree["lm_head"])
    return TransformerParams(t(tree["embed"]), periods, t(tree["final_norm"]),
                             head)
