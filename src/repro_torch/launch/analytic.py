"""Closed-form FLOP and device-byte counts of a step — the port of
``repro/launch/analytic.py``.

Pure formulas over a ``ModelConfig`` and its ``period_spec`` (this is how
model flops are conventionally reported): the 6ND weight term plus the
attention (and mLSTM) terms, the bytes a training, prefill or decode step
must move, and the gossip bytes a rank sends a round.  All results are
PER CHIP: totals divided by the chip count (on the launch path a chip is
a rank).  ``gossip_link_bytes_per_chip(..., backend="ppermute")`` is what
``chip_smoke.py`` holds its measured point-to-point bytes against.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models.transformer import period_spec

WB = {"float32": 4, "bfloat16": 2, "float16": 2}


def _attn_layers(cfg: ModelConfig) -> dict:
    """Counts of each mixer kind across the full stack."""
    spec = period_spec(cfg)
    reps = cfg.n_layers // len(spec)
    counts = {"attn": 0, "attn_local": 0, "mamba": 0, "mlstm": 0, "slstm": 0}
    moe_layers = 0
    dense_layers = 0
    for mixer, mlp in spec:
        counts[mixer] += reps
        if mlp == "moe":
            moe_layers += reps
        elif mlp == "dense":
            dense_layers += reps
    return {**counts, "moe": moe_layers, "dense_mlp": dense_layers}


def attention_flops(cfg: ModelConfig, batch: int, seq: int, *,
                    backward: bool, window_override: int | None = None) -> float:
    """Score+PV flops for the whole stack (excluded from the 6ND weight term)."""
    c = _attn_layers(cfg)
    hd = cfg.head_dim_
    H = cfg.n_heads
    total = 0.0
    for kind, n in (("attn", c["attn"]), ("attn_local", c["attn_local"])):
        if not n:
            continue
        win = cfg.window if kind == "attn_local" else 0
        if window_override is not None:
            win = window_override
        s_eff = min(seq, win) if win else seq
        # causal: each query sees ~min(pos, s_eff) keys; average ~ s_eff/2
        # when win < seq else seq/2
        avg_ctx = s_eff if (win and win < seq) else seq / 2.0
        fwd = 4.0 * batch * seq * avg_ctx * H * hd  # scores + pv, 2 matmuls
        total += n * (fwd * (3.0 if backward else 1.0))
    # mLSTM intra-chunk quadratic
    if c["mlstm"]:
        ch = cfg.scan_chunk
        di = 2 * cfg.d_model
        fwd = 4.0 * batch * seq * ch * di
        total += c["mlstm"] * fwd * (3.0 if backward else 1.0)
    return total


def train_flops_per_chip(cfg: ModelConfig, global_batch: int, seq: int,
                         n_chips: int) -> float:
    tokens = global_batch * seq
    weight_term = 6.0 * cfg.n_active_params() * tokens
    attn_term = attention_flops(cfg, global_batch, seq, backward=True)
    return (weight_term + attn_term) / n_chips


def prefill_flops_per_chip(cfg: ModelConfig, global_batch: int, seq: int,
                           n_chips: int) -> float:
    tokens = global_batch * seq
    weight_term = 2.0 * cfg.n_active_params() * tokens
    attn_term = attention_flops(cfg, global_batch, seq, backward=False)
    return (weight_term + attn_term) / n_chips


def decode_flops_per_chip(cfg: ModelConfig, global_batch: int, ctx: int,
                          n_chips: int, *, window_capped: bool) -> float:
    weight_term = 2.0 * cfg.n_active_params() * global_batch
    c = _attn_layers(cfg)
    hd, H = cfg.head_dim_, cfg.n_heads
    attn = 0.0
    for kind, n in (("attn", c["attn"]), ("attn_local", c["attn_local"])):
        win = cfg.window if (kind == "attn_local" or window_capped) else 0
        s_eff = min(ctx, win) if win else ctx
        attn += n * 4.0 * global_batch * s_eff * H * hd
    return (weight_term + attn) / n_chips


# ---------------------------------------------------------------------------
# HBM bytes
# ---------------------------------------------------------------------------

ACT_RW_TRAIN = 14.0   # fwd writes + bwd reads per activation element (std est.)
ACT_RW_FWD = 4.0


def _act_bytes(cfg: ModelConfig, batch: int, seq: int, n_chips: int,
               factor: float) -> float:
    wb = WB[cfg.compute_dtype]
    n_layers = cfg.n_layers + cfg.enc_layers
    return batch * seq * cfg.d_model * n_layers * wb * factor / n_chips


def train_bytes_per_chip(cfg: ModelConfig, global_batch: int, seq: int,
                         n_chips: int, n_learners: int,
                         gossip_neighbors: int = 1) -> float:
    wb = WB[cfg.param_dtype]
    P = cfg.n_params()
    # each learner replica is sharded over (n_chips / n_learners) chips
    p_local = P * n_learners / n_chips
    # fwd read + bwd read + grad write(f32) + momentum r/w(f32) + write
    # + gossip read of k neighbor replicas + mixed write
    weight_traffic = p_local * (3 * wb + 12 + (gossip_neighbors + 1) * wb)
    act = _act_bytes(cfg, global_batch, seq, n_chips, ACT_RW_TRAIN)
    return weight_traffic + act


def prefill_bytes_per_chip(cfg: ModelConfig, global_batch: int, seq: int,
                           n_chips: int) -> float:
    wb = WB[cfg.param_dtype]
    return cfg.n_params() * wb / n_chips \
        + _act_bytes(cfg, global_batch, seq, n_chips, ACT_RW_FWD) \
        + kv_cache_bytes(cfg, global_batch, seq, n_chips)


def kv_cache_bytes(cfg: ModelConfig, batch: int, buf: int,
                   n_chips: int) -> float:
    wb = WB[cfg.param_dtype]
    c = _attn_layers(cfg)
    per_layer = 2.0 * batch * buf * cfg.n_kv_heads * cfg.head_dim_ * wb
    n_attn = c["attn"] + c["attn_local"]
    ssm_state = (c["mamba"] * 2 * cfg.ssm_expand * cfg.d_model
                 * cfg.ssm_state * 4.0 * batch)
    return (n_attn * per_layer + ssm_state) / n_chips


def decode_bytes_per_chip(cfg: ModelConfig, global_batch: int, ctx: int,
                          n_chips: int, *, window_capped: bool) -> float:
    wb = WB[cfg.param_dtype]
    c = _attn_layers(cfg)
    weights = cfg.n_params() * wb / n_chips      # every weight read once
    buf_full = min(ctx, cfg.window) if window_capped else ctx
    cache_read = 0.0
    for kind, n in (("attn", c["attn"]), ("attn_local", c["attn_local"])):
        buf = min(ctx, cfg.window) if kind == "attn_local" else buf_full
        cache_read += n * 2.0 * global_batch * buf * cfg.n_kv_heads \
            * cfg.head_dim_ * wb
    ssm = (c["mamba"] + c["mlstm"] + c["slstm"]) * 2 * cfg.ssm_expand \
        * cfg.d_model * cfg.ssm_state * 4.0 * global_batch * 2
    return weights + (cache_read + ssm) / n_chips


# ---------------------------------------------------------------------------
# gossip (cross-learner) bytes — the DPSGD-specific collective term
# ---------------------------------------------------------------------------

def gossip_link_bytes_per_chip(cfg: ModelConfig, n_chips: int,
                               n_learners: int, backend: str) -> float:
    """Per-chip link bytes of one gossip round.  einsum: the L x L mixing
    gathers every replica shard (L x p_local per chip); ppermute ring: 2
    neighbour exchanges of p_local (a rank's received bytes on the launch
    path)."""
    wb = WB[cfg.param_dtype]
    p_local = cfg.n_params() * wb * n_learners / n_chips
    if backend == "einsum":
        return n_learners * p_local
    return 2.0 * p_local
