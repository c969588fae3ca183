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
