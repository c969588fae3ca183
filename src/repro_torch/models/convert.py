"""Carry parameters between the reference's tree layout and the port's
parameter objects.

The reference keeps a model's parameters as a tree of arrays: the FC net as
a flat dict, the transformer as nested dicts whose period leaves are
stacked on axis 0 (``periods/l0/mixer/wq`` is (n_periods, d, d)).  That
tree is also the layout of the flat training store (``core/flatstate.py``).

  * ``tree_from_jax`` turns such a tree of numpy arrays (``np.asarray`` of
    each reference leaf) into the same tree of torch tensors — the FC net's
    parameters as they are, the transformer's ready for
    ``transformer_from_tree``.
  * ``transformer_tree`` stacks a ``TransformerParams`` into the tree.
  * ``transformer_from_tree`` builds a ``TransformerParams`` AROUND a tree's
    tensors, with no copy: layer p's ``wq`` is row p of the stacked leaf.
    Built around the flat store's views, its parameters are the store.
  * ``params_from_jax`` does both steps for a reference transformer tree.

Weights keep the reference's (d_in, d_out) orientation.  A layer's mixer
is attention (``wq, wk, wv, wo``) or mamba (``a_log, conv_b, conv_w, d,
dt_bias, dt_proj, in_proj, out_proj, x_proj``); its mlp is dense (``w1,
w3, w2``) or MoE (``router, w1, w2, w3``).  Each leaf keeps its own dtype
(the float32 router, ``a_log``, ``d``, ``dt_bias`` and norms of a bf16
model included).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.util import tree_map
from .attention import AttnParams
from .mamba import MambaParams
from .moe import MoEParams
from .transformer import (LayerParams, MLPParams, TransformerParams,
                          n_periods, period_spec)


def _tensor(a, device):
    # torch has no numpy bfloat16 (ml_dtypes' type): go through float32,
    # which holds every bfloat16 value exactly, and cast back
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype("float32"),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def tree_from_jax(tree, device=None):
    """A tree of numpy arrays -> the same tree of torch tensors, each leaf
    in its own dtype (bfloat16 included)."""
    return tree_map(lambda a: _tensor(a, device), tree)


def transformer_tree(params: TransformerParams):
    """``TransformerParams`` -> the reference's tree, period leaves stacked
    on axis 0 (a copy)."""
    def stack(get):
        return torch.stack([get(period) for period in params.periods])

    def module(k, part):
        names = [n for n, _ in getattr(params.periods[0][k],
                                       part).named_parameters()]
        return {n: stack(lambda pp, n=n: getattr(getattr(pp[k], part),
                                                 n).detach())
                for n in names}

    def layer(k):
        return {"norm1": stack(lambda pp: pp[k].norm1.detach()),
                "mixer": module(k, "mixer"),
                "norm2": stack(lambda pp: pp[k].norm2.detach()),
                "mlp": module(k, "mlp")}

    tree = {"embed": params.embed.detach(),
            "periods": {k: layer(k) for k in params.periods[0]},
            "final_norm": params.final_norm.detach()}
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head.detach()
    return tree


def _mixer(m, p):
    if "wq" in m:
        return AttnParams(m["wq"][p], m["wk"][p], m["wv"][p], m["wo"][p])
    return MambaParams(**{k: x[p] for k, x in m.items()})


def _mlp(f, p):
    if "router" in f:
        return MoEParams(f["router"][p], f["w1"][p], f["w3"][p], f["w2"][p])
    return MLPParams(f["w1"][p], f["w3"][p], f["w2"][p])


def transformer_from_tree(tree, cfg: ModelConfig) -> TransformerParams:
    """tree: {"embed", "periods": {"l0": {"norm1", "mixer", "norm2",
    "mlp"}}, "final_norm", "lm_head"}, period leaves stacked on axis 0.
    The parameters alias the tree's tensors (``nn.Parameter`` of row p of
    each stacked leaf)."""
    def layer(lp, p):
        return LayerParams(lp["norm1"][p], _mixer(lp["mixer"], p),
                           lp["norm2"][p], _mlp(lp["mlp"], p))

    spec = period_spec(cfg)
    periods = [{f"l{i}": layer(tree["periods"][f"l{i}"], p)
                for i in range(len(spec))}
               for p in range(n_periods(cfg))]
    head = None if cfg.tie_embeddings else tree["lm_head"]
    return TransformerParams(tree["embed"], periods, tree["final_norm"], head)


def params_from_jax(tree, cfg: ModelConfig, device) -> TransformerParams:
    """The reference transformer's parameter tree (numpy leaves) -> the
    port's ``TransformerParams`` on ``device``."""
    return transformer_from_tree(tree_from_jax(tree, device), cfg)
