"""ModelConfig — the port's own copy of ``repro.configs.base.ModelConfig``.

Same fields with the same defaults (a test holds them equal to the
reference's), so a configuration reads the same in both packages.  Only
what the ported families use is implemented on top of them; the model code
raises ``NotImplementedError`` for the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio | fc
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    source: str = ""

    # --- attention ----------------------------------------------------------
    attn_pattern: str = "global"   # global | local_global | sliding
    window: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()
    attn_chunk: int = 1024

    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    moe_backend: str = "einsum"

    # --- SSM / xLSTM ----------------------------------------------------------
    block_period: Tuple[str, ...] = ()
    attn_layer_offset: int = -1
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    scan_chunk: int = 64

    # --- enc-dec / frontends --------------------------------------------------
    enc_layers: int = 0
    modality: str = "text"
    n_frontend_tokens: int = 1024

    use_rope: bool = True
    use_pallas: bool = False       # attention through the flash kernel

    # --- numerics -------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    vocab_pad: int = 256

    # ------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def n_params(self) -> int:
        """Analytic parameter count, the reference's formula (the 6ND
        model flops and the byte counts of ``launch/analytic.py``)."""
        d, h, kv, hd, ff, v = (self.d_model, self.n_heads, self.n_kv_heads,
                               self.head_dim_, self.d_ff, self.padded_vocab)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.family == "ssm":
            per_layer = self._xlstm_params()
        elif self.family == "hybrid":
            per_layer = self._hybrid_params()
        else:
            mlp = 3 * d * ff
            if self.n_experts:
                moe = self.n_experts * 3 * d * ff + d * self.n_experts
                frac_moe = 1.0 / self.moe_every
                mlp = frac_moe * moe + (1 - frac_moe) * mlp
            per_layer = attn + mlp + 2 * d
        total = self.n_layers * per_layer \
            + v * d * (1 if self.tie_embeddings else 2)
        if self.enc_layers:     # encoder layers + decoder cross-attention
            total += self.enc_layers * (attn + 3 * d * ff + 2 * d)
            total += self.n_layers * attn
        return int(total)

    def n_active_params(self) -> int:
        """Active (per-token) parameters: a MoE counts its top-k experts."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        total_moe = self.n_layers / self.moe_every * (
            self.n_experts * 3 * d * ff)
        active_moe = self.n_layers / self.moe_every * (
            self.experts_per_tok * 3 * d * ff)
        return int(self.n_params() - total_moe + active_moe)

    def _xlstm_params(self) -> int:
        d = self.d_model
        m = 2 * d * 2 * d + 3 * 2 * d + 2 * d * d + d * 2 * d
        s = 4 * (d * d + d * d) + 2 * d * 4 * d
        return (m + s) // 2 + 2 * d

    def _hybrid_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        di = self.ssm_expand * d
        mamba = 2 * d * di + di * self.ssm_conv + di * (
            2 * self.ssm_state + di // 16) + di * d
        attn = (self.n_heads + 2 * self.n_kv_heads) * self.head_dim_ * d \
            + self.n_heads * self.head_dim_ * d
        n_attn = self.n_layers // 8
        n_mamba = self.n_layers - n_attn
        mlp_dense = 3 * d * ff
        mlp_moe = self.n_experts * 3 * d * ff + d * self.n_experts
        n_moe = self.n_layers // self.moe_every if self.moe_every else 0
        mlps = n_moe * mlp_moe + (self.n_layers - n_moe) * mlp_dense
        return (n_mamba * mamba + n_attn * attn + mlps
                + 2 * d * self.n_layers) // self.n_layers

    def smoke_config(self) -> "ModelConfig":
        """Reduced same-family variant for CPU tests, identical to the
        reference's: <=2 (periods of) layers, d_model<=256, <=4 experts."""
        period = max(len(self.block_period), 1)
        n_layers = min(2 * period, self.n_layers)
        if self.family == "hybrid":
            n_layers = period
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            enc_layers=min(2, self.enc_layers) if self.enc_layers else 0,
            d_model=min(256, self.d_model),
            n_heads=4, n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=64,
            d_ff=min(512, self.d_ff) if self.d_ff else 0,
            vocab=min(512, self.vocab),
            mrope_sections=(8, 12, 12) if self.mrope_sections else (),
            n_experts=min(4, self.n_experts) if self.n_experts else 0,
            experts_per_tok=(min(2, self.experts_per_tok)
                             if self.experts_per_tok else 0),
            window=64,
            attn_chunk=32,
            scan_chunk=8,
            n_frontend_tokens=8,
            param_dtype="float32", compute_dtype="float32",
        )
