"""The frozen FLOP and byte counts against counts made by hand at
transformer-100m's and Jamba's shapes."""
from __future__ import annotations

import json

import pytest

from conftest import CHECKOUT


def _shape(name):
    from portbench.model import shape
    return shape(json.loads(
        (CHECKOUT / "portbench" / "configs" / f"{name}.json").read_text()))


def test_transformer_100m_parameters_and_step_flops():
    from portbench import flops
    s = _shape("transformer-100m")
    # a layer: q,k,v,o 4 x 768^2 = 2,359,296; SwiGLU 3 x 768 x 2,048 =
    # 4,718,592; two norms 1,536 -> 7,079,424 x 12 = 84,953,088; embed and
    # head 2 x 32,768 x 768 = 50,331,648
    assert flops.n_params(s) == 135_284_736
    assert flops.n_matmul_params(s) == 135_284_736 - 25_165_824
    # 64 rows of 512: causal pairs 512 x 513 / 2 = 131,328; 4 FLOPs a
    # pair a head-dim lane, 12 heads x 64, 12 layers, 64 rows
    assert flops.attention_flops(s, 64, 512) == 12 * 4 * 64 * 131_328 * 768
    assert flops.train_flops(s, 64, 512) == pytest.approx(
        6 * 110_118_912 * 32_768 + 3 * 309_841_625_088, rel=1e-12)


def test_jamba_period_parameters():
    from portbench import flops
    from portbench.model import layer_counts
    s = _shape("jamba-v0.1-52b-1p")
    assert layer_counts(s) == {"attn": 1, "mamba": 7, "moe": 4, "dense": 4}
    attn = 4096 * 4096 * 2 + 2 * 4096 * 1024                  # 41,943,040
    mamba = (2 * 4096 * 8192 + 8192 * 4 + 8192 * (256 + 32)
             + 256 * 8192 + 8192 * 4096)                       # 105,152,512
    moe = 16 * 3 * 4096 * 14336 + 4096 * 16
    dense = 3 * 4096 * 14336
    total = (attn + 7 * mamba + 4 * moe + 4 * dense + 2 * 4096 * 8
             + 2 * 65536 * 4096)
    assert total == 13_294_141_440
    assert flops.n_params(s) == total
    # a token multiplies through all but the embedding and 14 of each
    # MoE layer's 16 experts
    assert flops.n_matmul_params(s) == \
        total - 65536 * 4096 - 4 * 14 * 3 * 4096 * 14336
    assert flops.decode_flops(s, [100] * 64) == pytest.approx(
        2 * 3_160_702_976 * 64 + 4 * 32 * 128 * 100 * 64, rel=1e-12)


def test_gossip_bound_at_the_100m_store():
    from portbench.rooflines import gossip
    T = 1_056_920
    # w (= remote), g, mu in; w', mu' out: 5 x 8 x T x 128 x 4 bytes, the
    # (1, 8) partners and the (8, 4) coefficients
    assert gossip.nbytes(8, T) == 5 * 8 * T * 512 + 32 + 128
    t, by = gossip.bound_s(8, T)
    assert by == "bytes" and t == pytest.approx(21_645_721_760 / 3.35e12)


def test_flash_bound_at_the_flash4k_shape():
    from portbench.rooflines import flash
    pairs = 4096 * 4097 // 2
    assert flash.flops(2, 12, 4096, 64) == 4 * pairs * 2 * 12 * 64
    t, by = flash.bound_s(2, 12, 12, 4096, 64, 4)
    assert by == "operations"
    assert t == pytest.approx(51_552_190_464 / 67e12)


def test_decode_bound_at_the_jamba_serve_shape():
    from portbench.rooflines import decode
    lengths = [1000] * 64
    # q and out: 2 x 64 x 32 x 128; K and V: 2 x 64,000 x 8 x 128, at 2
    # bytes; the (64, 96) table and 64 lengths at 4
    want = 2 * (2 * 64 * 32 * 128 + 2 * 64_000 * 8 * 128) + 4 * (64 * 96
                                                                + 64)
    assert decode.nbytes(64, 32, 8, 128, 2, 64_000, 96) == want
    t, by = decode.bound_s(64, 32, 8, 128, 2, lengths, 96)
    assert by == "bytes" and t == pytest.approx(want / 3.35e12)
    assert decode.live_positions([10, 5000], window=4096) == 4106


def test_causal_pairs_with_a_window():
    from portbench.flops import causal_pairs
    assert causal_pairs(4, 0) == 10
    assert causal_pairs(6, 2) == 3 + 4 * 2
    brute = sum(1 for q in range(9) for k in range(9)
                if k <= q and q - k < 4)
    assert causal_pairs(9, 4) == brute


def test_mfu_readers_never_pass_the_peak_at_the_device_floor():
    """A step that took exactly its FLOPs at the peak reads 100%."""
    from portbench import flops, peaks, spec
    s = _shape("transformer-100m")
    tr = {"learners": 8, "local_batch": 8, "seq": 512}
    f = flops.train_flops(s, 64, 512)
    rec = {"kind": "train", "shape": s, "traffic": tr, "window_steps": 3,
           "window_s": 3 * f / peaks.F32_FLOPS}
    v, unit = spec.metric("step_mfu.train").read(rec)
    assert unit == "%" and v == pytest.approx(100.0)
