"""A configuration file read into one plain shape, shared by the FLOP
counts, the weight generator, the plain references and the program's
configuration.

Two spellings are read.  A model published with a Hugging Face
``config.json`` keeps its keys (``hidden_size``, ``num_hidden_layers``,
``mamba_d_state``, ...); the repo's own paper-scale model keeps the port's
field names (``d_model``, ``n_layers``, ...).  Options that exist only in
the program (how it runs, not what it computes) sit under ``"port"``.
"""
from __future__ import annotations

import math


def _period_hf(c: dict):
    """(mixer, mlp) of each layer of one period of a Jamba-style config:
    attention every ``attn_layer_period`` layers at ``attn_layer_offset``,
    experts every ``expert_layer_period`` at ``expert_layer_offset``."""
    ap, ao = c["attn_layer_period"], c["attn_layer_offset"]
    ep, eo = c["expert_layer_period"], c["expert_layer_offset"]
    n = ap * ep // math.gcd(ap, ep)
    return [("attn" if i % ap == ao else "mamba",
             "moe" if c["num_experts"] > 1 and i % ep == eo else "dense")
            for i in range(n)]


def shape(c: dict) -> dict:
    """The configuration's shape under one set of names."""
    port = c.get("port", {})
    if "hidden_size" in c:
        d, h = c["hidden_size"], c["num_attention_heads"]
        period = _period_hf(c)
        s = dict(family="hybrid", n_layers=c["num_hidden_layers"],
                 d_model=d, n_heads=h, n_kv_heads=c["num_key_value_heads"],
                 head_dim=c.get("head_dim") or d // h,
                 d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                 n_experts=c["num_experts"],
                 top_k=c["num_experts_per_tok"], period=period,
                 ssm_state=c["mamba_d_state"], ssm_conv=c["mamba_d_conv"],
                 ssm_expand=c["mamba_expand"], dt_rank=c["mamba_dt_rank"],
                 rope=False, rope_theta=10000.0, norm_eps=c["rms_norm_eps"],
                 window=c.get("sliding_window") or 0,
                 tie_embeddings=c["tie_word_embeddings"],
                 dtype=c["dtype"])
    else:
        s = dict(family=c["family"], n_layers=c["n_layers"],
                 d_model=c["d_model"], n_heads=c["n_heads"],
                 n_kv_heads=c["n_kv_heads"], head_dim=c["head_dim"],
                 d_ff=c["d_ff"], vocab=c["vocab"], n_experts=0, top_k=0,
                 period=[("attn", "dense")], rope=True,
                 rope_theta=c["rope_theta"], norm_eps=c["norm_eps"],
                 window=0, tie_embeddings=c["tie_embeddings"],
                 dtype=c["dtype"])
    s["capacity_factor"] = port.get("capacity_factor", 1.25)
    s["port"] = port
    if s["n_layers"] % len(s["period"]):
        raise ValueError(f"{s['n_layers']} layers is not a whole number of "
                         f"{len(s['period'])}-layer periods")
    return s


def n_periods(s: dict) -> int:
    return s["n_layers"] // len(s["period"])


def layer_counts(s: dict) -> dict:
    reps = n_periods(s)
    out = {"attn": 0, "mamba": 0, "moe": 0, "dense": 0}
    for mixer, mlp in s["period"]:
        out[mixer] += reps
        out[mlp] += reps
    return out


def port_config(s: dict, name: str):
    """The port's ``ModelConfig`` for this shape (imports the program)."""
    from repro_torch.configs.base import ModelConfig

    port = dict(s["port"])
    kw = dict(name=name, n_layers=s["n_layers"], d_model=s["d_model"],
              n_heads=s["n_heads"], n_kv_heads=s["n_kv_heads"],
              head_dim=s["head_dim"], d_ff=s["d_ff"], vocab=s["vocab"],
              rope_theta=s["rope_theta"], norm_eps=s["norm_eps"],
              tie_embeddings=s["tie_embeddings"], use_rope=s["rope"],
              param_dtype=s["dtype"], compute_dtype=s["dtype"])
    if s["family"] == "hybrid":
        spec = s["period"]
        attn = [i for i, (m, _) in enumerate(spec) if m == "attn"]
        moe = [i for i, (_, f) in enumerate(spec) if f == "moe"]
        every = moe[1] - moe[0] if len(moe) > 1 else len(spec)
        # the port's rule: attention at one offset; experts where
        # i % moe_every == moe_every - 1
        if len(attn) != 1 or any(i % every != every - 1 for i in moe) \
                or len(moe) != len(spec) // every:
            raise ValueError(f"the port cannot lay out the period {spec}")
        if s["dt_rank"] != math.ceil(s["d_model"] / 16):
            raise ValueError("the port's mamba takes dt_rank = ceil(d / 16)")
        kw.update(family="hybrid", block_period=len(spec) * ("mamba",),
                  attn_layer_offset=attn[0], n_experts=s["n_experts"],
                  experts_per_tok=s["top_k"], moe_every=every,
                  ssm_state=s["ssm_state"], ssm_conv=s["ssm_conv"],
                  ssm_expand=s["ssm_expand"],
                  attn_pattern="sliding" if s["window"] else "global",
                  window=s["window"] or 4096,
                  capacity_factor=s["capacity_factor"])
    else:
        kw.update(family="dense")
    kw.update(port)
    return ModelConfig(**kw)
