"""Carry parameters between the reference's tree layout and the port's
parameter objects.

The reference keeps a model's parameters as a tree of arrays: the FC net as
a flat dict, the transformer as nested dicts whose period leaves are
stacked on axis 0 (``periods/l0/mixer/wq`` is (n_periods, d, d)), the
encoder-decoder likewise with its layer leaves stacked
(``dec_layers/self_attn/wq`` is (n_layers, d, d)).  That tree is also the
layout of the flat training store (``core/flatstate.py``).

  * ``tree_from_jax`` turns such a tree of numpy arrays (``np.asarray`` of
    each reference leaf) into the same tree of torch tensors.
  * ``transformer_tree`` / ``encdec_tree`` stack a model's parameter
    object into the tree (a copy).
  * ``transformer_from_tree`` / ``encdec_from_tree`` build the parameter
    object AROUND a tree's tensors, with no copy: layer p's ``wq`` is row
    p of the stacked leaf.  Built around the flat store's views, its
    parameters are the store.
  * ``params_from_jax`` does both steps for a reference model's tree.
  * ``PeriodParams`` is a transformer whose period layers are fetched as
    the forward reaches them (a learner sharded over a model group gathers
    one period at a time, ``launch/shardstore.LearnerGather``), and
    ``period_layers`` builds one period's layers around its tree, keeping
    the tensors as they are (autograd outputs included: no
    ``nn.Parameter``).

Weights keep the reference's (d_in, d_out) orientation.  A transformer
layer's mixer is attention (``wq, wk, wv, wo``), mamba (``a_log, conv_b,
conv_w, d, dt_bias, dt_proj, in_proj, out_proj, x_proj``), mLSTM (with
``w_igate``) or sLSTM (with ``r``); its mlp is dense (``w1, w3, w2``) or
MoE (``router, w1, w2, w3``), and an xLSTM layer has neither ``norm2`` nor
``mlp``.  Each leaf keeps its own dtype (the float32 router, gates, norms
and biases of a bf16 model included).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.util import tree_map
from .attention import AttnParams
from .encdec import DecLayerParams, EncDecParams, EncLayerParams
from .mamba import MambaParams
from .moe import MoEParams
from .transformer import (LayerParams, MLPParams, TransformerParams,
                          n_periods, period_spec)
from .xlstm import MLSTMParams, SLSTMParams


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


def _stack(modules):
    """Modules of one structure -> {name: ...: stacked leaf} nested as
    their attribute paths."""
    out = {}
    for name, _ in modules[0].named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.stack([m.get_parameter(name).detach()
                                  for m in modules])
    return out


def transformer_tree(params: TransformerParams):
    """``TransformerParams`` -> the reference's tree, period leaves stacked
    on axis 0 (a copy)."""
    tree = {"embed": params.embed.detach(),
            "periods": {k: _stack([pp[k] for pp in params.periods])
                        for k in params.periods[0]},
            "final_norm": params.final_norm.detach()}
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head.detach()
    return tree


def _mixer(m, p):
    if "w_igate" in m:
        return MLSTMParams(**{k: x[p] for k, x in m.items()})
    if "r" in m:
        return SLSTMParams(**{k: x[p] for k, x in m.items()})
    if "wq" in m:
        return _attn(m, p)
    return MambaParams(**{k: x[p] for k, x in m.items()})


def _attn(m, p):
    return AttnParams(m["wq"][p], m["wk"][p], m["wv"][p], m["wo"][p])


def _mlp(f, p):
    if "router" in f:
        return MoEParams(f["router"][p], f["w1"][p], f["w3"][p], f["w2"][p])
    return MLPParams(f["w1"][p], f["w3"][p], f["w2"][p])


def transformer_from_tree(tree, cfg: ModelConfig) -> TransformerParams:
    """tree: {"embed", "periods": {"l0": {"norm1", "mixer"[, "norm2",
    "mlp"]}}, "final_norm"[, "lm_head"]}, period leaves stacked on axis 0.
    The parameters alias the tree's tensors (``nn.Parameter`` of row p of
    each stacked leaf)."""
    def layer(lp, p):
        if "mlp" not in lp:
            return LayerParams(lp["norm1"][p], _mixer(lp["mixer"], p))
        return LayerParams(lp["norm1"][p], _mixer(lp["mixer"], p),
                           lp["norm2"][p], _mlp(lp["mlp"], p))

    spec = period_spec(cfg)
    periods = [{f"l{i}": layer(tree["periods"][f"l{i}"], p)
                for i in range(len(spec))}
               for p in range(n_periods(cfg))]
    head = None if cfg.tie_embeddings else tree["lm_head"]
    return TransformerParams(tree["embed"], periods, tree["final_norm"], head)


class PeriodParams(nn.Module):
    """A transformer's non-period parameters (``embed``, ``final_norm``,
    ``lm_head`` unless tied), built around a tree's tensors as
    ``transformer_from_tree`` builds them, and ``n_periods`` periods that
    ``gather_period(p)`` returns as ``{f"l{i}": layer}`` when the forward
    (or the decode) reaches period p (``transformer.forward``)."""

    def __init__(self, rest, n_periods: int, gather_period: Callable):
        super().__init__()
        self.embed = nn.Parameter(rest["embed"])
        self.final_norm = nn.Parameter(rest["final_norm"])
        self.lm_head = (nn.Parameter(rest["lm_head"]) if "lm_head" in rest
                        else None)
        self.periods = [None] * n_periods
        self.gather_period = gather_period


def _namespace(tree):
    return SimpleNamespace(**{k: _namespace(v) if isinstance(v, dict)
                              else v for k, v in tree.items()})


def period_layers(tree):
    """One period's tree {"l0": {"norm1", "mixer"[, "norm2", "mlp"]}}
    (leaves without the period dim) -> ``{f"l{i}": layer}``, each layer
    with the attributes of ``LayerParams`` (``norm2`` / ``mlp`` None for
    an xLSTM layer) and its mixer and mlp those of their parameter
    classes, the tree's tensors themselves."""
    return {name: SimpleNamespace(
        norm1=lp["norm1"], mixer=_namespace(lp["mixer"]),
        norm2=lp.get("norm2"),
        mlp=_namespace(lp["mlp"]) if "mlp" in lp else None)
        for name, lp in tree.items()}


def encdec_tree(params: EncDecParams):
    """``EncDecParams`` -> the reference's tree {"embed", "enc_layers",
    "enc_norm", "dec_layers", "final_norm", "lm_head"}, layer leaves
    stacked on axis 0 (a copy)."""
    return {"embed": params.embed.detach(),
            "enc_layers": _stack(list(params.enc_layers)),
            "enc_norm": params.enc_norm.detach(),
            "dec_layers": _stack(list(params.dec_layers)),
            "final_norm": params.final_norm.detach(),
            "lm_head": params.lm_head.detach()}


def encdec_from_tree(tree, cfg: ModelConfig) -> EncDecParams:
    """The encoder-decoder's tree -> ``EncDecParams`` aliasing its
    tensors."""
    e, d = tree["enc_layers"], tree["dec_layers"]
    enc = [EncLayerParams(_attn(e["attn"], i), _mlp(e["mlp"], i),
                          e["norm1"][i], e["norm2"][i])
           for i in range(cfg.enc_layers)]
    dec = [DecLayerParams(cross_attn=_attn(d["cross_attn"], i),
                          mlp=_mlp(d["mlp"], i), norm1=d["norm1"][i],
                          norm2=d["norm2"][i], norm_x=d["norm_x"][i],
                          self_attn=_attn(d["self_attn"], i))
           for i in range(cfg.n_layers)]
    return EncDecParams(tree["embed"], enc, tree["enc_norm"], dec,
                        tree["final_norm"], tree["lm_head"])


def params_from_tree(tree, cfg: ModelConfig):
    """A model's tree -> its parameter object (aliasing), by family."""
    if cfg.family == "audio":
        return encdec_from_tree(tree, cfg)
    return transformer_from_tree(tree, cfg)


def params_from_jax(tree, cfg: ModelConfig, device):
    """A reference model's parameter tree (numpy leaves) -> the port's
    parameter object on ``device``."""
    return params_from_tree(tree_from_jax(tree, device), cfg)
