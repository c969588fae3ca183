"""Public dispatchers over the port's kernels.

The rule (as in ``repro.kernels.ops``, with the device taking the place of
the JAX backend): a CPU tensor goes to the plain version in ``ref``; a
CUDA tensor goes to the hand-written kernel, which launches or raises.
Nothing falls back from a failed build or launch.
"""
from __future__ import annotations

from . import ref
from .decode_attention import paged_decode_attention_fwd


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           window: int = 0, attn_softcap: float = 0.0):
    """Paged serving decode attention (DESIGN §14).

    q: (S, H, hd) — one query token per serve slot; k_pages, v_pages:
    (P, page, KV, hd) shared pools; page_table: (S, max_pages) int32
    physical page ids in logical order; lengths: (S,) int32 valid tokens
    per slot (current token included).  Inference only.
    """
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, lengths, window=window,
            attn_softcap=attn_softcap)
    return paged_decode_attention_fwd(
        q, k_pages, v_pages, page_table, lengths, window=window,
        attn_softcap=attn_softcap)
