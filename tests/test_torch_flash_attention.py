"""The port's flash attention against the JAX reference.

The same numpy inputs go through the port's plain version
(``repro_torch.kernels.ref.flash_attention_ref``) and the reference's jnp
oracle over the reference's whole sweep grid (tests/test_kernels.py
``test_flash_attention_sweep``: 3 shapes x 2 dtypes x 4 mask settings),
and through the reference's Pallas kernel in interpret mode on 4 of those
cases.  float32 is held to the reference's own sweep tier, 2e-6 absolute
(both sides compute the same dense float32 softmax; the sums run in other
orders: measured at most 6.0e-7).  bfloat16 is held per element to one
bfloat16 ulp of the value, 2^-7 |want|, plus 1e-3 of the output's rms for
sums near 0: each side rounds its float32 result to bfloat16 once, so a
value near a rounding boundary may land one ulp apart and no further.
Where the logit softcap binds (q scaled so scores reach tens), float32 is
held to 1e-5, the reference's tier above S = 256.

``ops.flash_attention``'s q, k, v gradients (the reference's custom VJP:
kernel forward, oracle backward) are held against ``jax.grad`` at 1e-5
absolute on the reference's model-layout shapes (measured: 4.8e-6 on
gradients of O(10)), both
through the CPU dispatch (the plain version with autograd) and through
``FlashAttention`` itself with a CPU stand-in for the kernel forward.

The CUDA kernels must agree with their plain version on the card within
the same tiers (``cuda`` marker, skipped here): the float32 kernel (FMA
scores, P.V in three TF32 terms on the tensor cores) for float32 inputs
and hd 32, and the tensor-core kernel for bf16 at hd 64 and 128; both
mask ragged tiles and so take every length the reference takes.  The
wrapper's shape rule (every hd from 1 to 256: an hd between the
instantiated 32 / 64 / 128 / 256 is zero-padded to the next one and run
with its own scale) and its choice between the two kernels are checked
on the CPU, the padding step against the plain version on the unpadded
inputs, and so are the float32 kernel's numerics: an emulation of
its tile order, its float32 FMA scores and its TF32 splits of P and V
holds the float32 tiers at the float32 shapes of ``chip_smoke.py``,
where scores in three TF32 terms, or P.V in one, would not.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_fwd as jax_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_shapes, flash_attention_fwd, kernel_for, pad_head_dim,
    padded_head_dim)

SHAPES = [(128, 64, 4, 4), (256, 64, 4, 2), (256, 128, 2, 1)]
DTYPES = ["float32", "bfloat16"]
MASKS = [dict(causal=True), dict(causal=True, window=64),
         dict(causal=False), dict(causal=True, attn_softcap=50.0)]
ATOL_F32 = 2e-6
BF16_ULP, BF16_RMS = 2.0 ** -7, 1e-3
GRAD_ATOL = 1e-5
RAGGED_MASKS = [dict(causal=True, window=32, attn_softcap=50.0),
                dict(causal=False)]
INTERPRET_CASES = [((128, 64, 4, 4), "float32", MASKS[0]),
                   ((256, 64, 4, 2), "float32", MASKS[1]),
                   ((256, 128, 2, 1), "bfloat16", MASKS[3]),
                   ((128, 64, 4, 4), "float32", MASKS[2])]


def _operands(S, hd, H, KV, dtype, seed=0, Sk=None, q_scale=1.0):
    """(B=1) q (1, H, S, hd), k, v (1, KV, Sk, hd) as numpy float32 holding
    values exactly representable in ``dtype``, q times ``q_scale``."""
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((1, H, S, hd), (1, KV, Sk, hd), (1, KV, Sk, hd))]
    arrs[0] *= np.float32(q_scale)
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _jax(arrs, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype, device="cpu"):
    return [torch.tensor(a, device=device).to(getattr(torch, dtype))
            for a in arrs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tier_ratio(got, want):
    """max |got - want| over the bf16 tier, 2^-7 |want| + 1e-3 rms."""
    g, w = _f32(got), _f32(want)
    tol = BF16_ULP * np.abs(w) + BF16_RMS * np.sqrt(np.mean(w ** 2))
    return float(np.max(np.abs(g - w) / tol))


def _assert_within_tier(got, want, dtype, atol_f32=ATOL_F32):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol_f32,
                                   rtol=0)
        return
    ratio = _tier_ratio(got, want)
    assert ratio <= 1.0, f"|got - want| reaches {ratio} x one bf16 ulp"


@pytest.mark.parametrize("kw", MASKS, ids=["causal", "window64", "full",
                                           "softcap50"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,hd,H,KV", SHAPES)
def test_plain_version_matches_reference_oracle(S, hd, H, KV, dtype, kw):
    arrs = _operands(S, hd, H, KV, dtype, seed=S + hd)
    want = jax_ref.flash_attention_ref(*_jax(arrs, dtype), **kw)
    got = ref.flash_attention_ref(*_torch(arrs, dtype), **kw)
    assert got.dtype == getattr(torch, dtype)
    _assert_within_tier(got, want, dtype)


def test_plain_version_matches_reference_oracle_where_the_cap_binds():
    """q x 8: scores reach tens, so the cap at 50 moves them by whole
    units; the cap's effect dwarfs the tier."""
    arrs = _operands(256, 128, 4, 2, "float32", seed=5, q_scale=8.0)
    kw = dict(causal=True, window=128, attn_softcap=50.0)
    want = jax_ref.flash_attention_ref(*_jax(arrs, "float32"), **kw)
    got = ref.flash_attention_ref(*_torch(arrs, "float32"), **kw)
    _assert_within_tier(got, want, "float32", atol_f32=1e-5)
    uncapped = ref.flash_attention_ref(*_torch(arrs, "float32"),
                                       **{**kw, "attn_softcap": 0.0})
    assert float((uncapped - got).abs().max()) > 1e3 * 1e-5


@pytest.mark.parametrize("shape,dtype,kw", INTERPRET_CASES,
                         ids=["causal_f32", "window_gqa_f32",
                              "softcap_mqa_bf16", "full_f32"])
def test_plain_version_matches_pallas_interpret_mode(shape, dtype, kw):
    S, hd, H, KV = shape
    arrs = _operands(S, hd, H, KV, dtype, seed=S + hd)
    want = jax_kernel(*_jax(arrs, dtype), block_q=64, block_k=64,
                      interpret=True, **kw)
    got = ref.flash_attention_ref(*_torch(arrs, dtype), **kw)
    _assert_within_tier(got, want, dtype)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("Sk,kw", [(100, RAGGED_MASKS[0]),
                                   (37, RAGGED_MASKS[1])],
                         ids=["Sk100_window_softcap", "Sk37_full"])
def test_plain_version_matches_pallas_interpret_mode_at_ragged_lengths(
        hd, Sk, kw):
    """float32 at Sq 100 (the reference's block is then the whole length)
    against Sk 100 with a window and the softcap, and against Sk 37."""
    arrs = _operands(100, hd, 4, 2, "float32", seed=hd + Sk, Sk=Sk)
    want = jax_kernel(*_jax(arrs, "float32"), interpret=True, **kw)
    got = ref.flash_attention_ref(*_torch(arrs, "float32"), **kw)
    _assert_within_tier(got, want, "float32")


def _model_layout_operands():
    """The reference's ``test_flash_attention_model_layout_and_grad``
    shapes: q (2, 64, 4, 32), k, v (2, 64, 2, 32)."""
    rng = np.random.default_rng(9)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))]


def _jax_grads(arrs, **kw):
    def f(q, k, v):
        return jnp.sum(jax_ops.flash_attention(q, k, v, **kw) ** 2)
    return jax.grad(f, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrs])


def _port_grads(fn, arrs):
    qkv = [torch.tensor(a, requires_grad=True) for a in arrs]
    torch.sum(fn(*qkv) ** 2).backward()
    return [t.grad for t in qkv]


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=16,
                                     attn_softcap=30.0)],
                         ids=["causal", "window_softcap"])
def test_dispatcher_gradients_match_reference_custom_vjp(kw):
    arrs = _model_layout_operands()
    want = _jax_grads(arrs, **kw)
    got = _port_grads(lambda q, k, v: ops.flash_attention(q, k, v, **kw),
                      arrs)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.fixture
def cpu_kernel(monkeypatch):
    """``FlashAttention`` with its kernel forward replaced by the plain
    version on the CPU (counting calls): the Function's own backward and
    once-differentiable guard run as they do on the card."""
    calls = []

    def fake(q, k, v, **kw):
        calls.append(kw)
        return ref.flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_fwd", fake)
    return calls


def test_function_backward_is_the_reference_recompute(cpu_kernel):
    kw = dict(causal=True, window=16, attn_softcap=30.0)
    arrs = _model_layout_operands()
    want = _jax_grads(arrs, **kw)
    got = _port_grads(lambda q, k, v: ops.FlashAttention.apply(
        q, k, v, kw["causal"], kw["window"], kw["attn_softcap"]), arrs)
    assert cpu_kernel == [kw]                 # forward only, once
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)


def test_double_backward_through_the_function_raises(cpu_kernel):
    q, k, v = [torch.tensor(a, requires_grad=True)
               for a in _model_layout_operands()]
    out = ops.FlashAttention.apply(q, k, v, True, 0, 0.0)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(torch.sum(out ** 2), q, create_graph=True)
    # a plain backward goes through
    out = ops.FlashAttention.apply(q, k, v, True, 0, 0.0)
    (gq,) = torch.autograd.grad(torch.sum(out ** 2), q)
    assert not gq.requires_grad and np.isfinite(gq.numpy()).all()
    # the plain route differentiates twice, as a probe's HVP needs
    plain = ops.flash_attention(q, k, v)
    (gq,) = torch.autograd.grad(torch.sum(plain ** 2), q, create_graph=True)
    (hq,) = torch.autograd.grad(torch.sum(gq), q)
    assert np.isfinite(hq.numpy()).all()


def test_dispatcher_takes_plain_version_for_cpu_tensors():
    q, k, v = [torch.tensor(a) for a in _model_layout_operands()]
    before = flash_attention_fwd.launches
    got = ops.flash_attention(q, k, v, window=8)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=8)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)
    assert got.shape == q.shape
    assert flash_attention_fwd.launches == before
    # positions are accepted and not read (contiguous from 0)
    junk = torch.full((64,), 7)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, q_positions=junk, k_positions=junk,
                            window=8, backend="ref"), got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, k, v, backend="pallas")


def test_fully_masked_rows_average_v_as_the_reference_does():
    """Non-causal with a window and Sq > Sk + window: the last rows see no
    live key; the oracle (and the TPU kernel) give the uniform average of
    V there."""
    arrs = _operands(256, 32, 2, 2, "float32", seed=3, Sk=128)
    kw = dict(causal=False, window=64)
    want = jax_ref.flash_attention_ref(*_jax(arrs, "float32"), **kw)
    got = ref.flash_attention_ref(*_torch(arrs, "float32"), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-6, rtol=0)
    v = arrs[2]
    np.testing.assert_allclose(_f32(got)[0, :, -1], v[0].mean(axis=1),
                               atol=2e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _torch(_operands(64, 32, 2, 2, "float32"), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Sq,Sk", [(100, 100), (128, 128), (384, 384),
                                   (1, 1), (37, 100), (256, 128),
                                   (100, 384)])
def test_wrapper_takes_every_length_the_reference_takes_in_bf16(Sq, Sk,
                                                                hd):
    """The reference takes any length below its 128 block or a multiple of
    it; the tensor-core kernel masks its ragged tiles and takes them all.
    The reference's own Pallas kernel agrees at the ragged length."""
    assert kernel_for(torch.bfloat16, hd) == "tc"
    assert check_shapes((1, 4, Sq, hd), (1, 2, Sk, hd), (1, 2, Sk, hd),
                        torch.bfloat16) == "tc"
    if (Sq, Sk) == (100, 100):
        arrs = _operands(100, hd, 4, 2, "bfloat16", seed=hd)
        kw = dict(causal=True, window=32, attn_softcap=50.0)
        want = jax_kernel(*_jax(arrs, "bfloat16"), interpret=True, **kw)
        got = ref.flash_attention_ref(*_torch(arrs, "bfloat16"), **kw)
        _assert_within_tier(got, want, "bfloat16")


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 32),
                                      (torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 32)])
@pytest.mark.parametrize("Sq,Sk", [(100, 100), (100, 37), (1, 1), (65, 130),
                                   (513, 512)])
def test_wrapper_takes_every_length_in_float32_and_bf16_at_hd_32(Sq, Sk,
                                                                dtype, hd):
    assert check_shapes((2, 4, Sq, hd), (2, 2, Sk, hd), (2, 2, Sk, hd),
                        dtype) == "mma"


def test_wrapper_shape_rule_refuses_what_no_kernel_takes():
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="head_dim"):
        check_shapes((1, 4, 128, 264), (1, 2, 128, 264), (1, 2, 128, 264),
                     bf)
    with pytest.raises(ValueError, match="H % KV"):
        check_shapes((1, 3, 128, 128), (1, 2, 128, 128), (1, 2, 128, 128),
                     bf)
    with pytest.raises(ValueError, match="fit"):
        check_shapes((1, 4, 128, 128), (1, 2, 128, 128), (1, 2, 64, 128),
                     bf)
    with pytest.raises(ValueError, match="at least one row"):
        check_shapes((1, 4, 0, 64), (1, 2, 64, 64), (1, 2, 64, 64),
                     torch.float32)
    # float32 at any hd, and bf16 at hd 32, route to the float32 kernel by
    # (dtype, hd) alone, which masks its ragged tiles: every length
    assert kernel_for(torch.float32, 128) == "mma"
    assert kernel_for(torch.float32, 64) == "mma"
    assert kernel_for(bf, 32) == "mma"
    assert check_shapes((1, 4, 128, 64), (1, 2, 192, 64), (1, 2, 192, 64),
                        torch.float32) == "mma"
    assert check_shapes((1, 4, 100, 64), (1, 2, 100, 64), (1, 2, 100, 64),
                        torch.float32) == "mma"
    assert check_shapes((1, 4, 100, 32), (1, 2, 100, 32), (1, 2, 100, 32),
                        bf) == "mma"


@pytest.mark.parametrize("hd", [0, 257, 264, 512])
def test_wrapper_refuses_a_head_dim_outside_1_to_256(hd):
    with pytest.raises(ValueError, match="1 <= hd <= 256"):
        check_shapes((1, 4, 64, hd), (1, 2, 64, hd), (1, 2, 64, hd),
                     torch.float32)


def test_wrapper_takes_every_head_dim_from_1_to_256():
    """Each hd runs the kernel instantiated at the next of 32 / 64 / 128
    / 256: bf16 through the tensor-core kernel where that is 64 or 128."""
    for hd in range(1, 257):
        hp = padded_head_dim(hd)
        assert hp == min(d for d in (32, 64, 128, 256) if d >= hd)
        for dt in (torch.float32, torch.bfloat16):
            want = ("tc" if dt == torch.bfloat16 and hp in (64, 128)
                    else "mma")
            assert kernel_for(dt, hd) == want
            assert check_shapes((1, 4, 37, hd), (1, 2, 50, hd),
                                (1, 2, 50, hd), dt) == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd,kw", [
    (1, MASKS[0]), (20, MASKS[1]), (48, MASKS[3]), (80, MASKS[2]),
    (96, dict(causal=True, window=32, attn_softcap=50.0)), (200, MASKS[0])])
def test_padding_step_then_plain_version_equals_the_plain_version(
        hd, kw, dtype):
    """The wrapper's zero padding of the head dim, then the plain version
    with the true hd's scale, keeping the first hd columns: the plain
    version on the unpadded inputs, bitwise (the zero columns add exact
    zeros; measured 0.0 at every case here)."""
    arrs = _operands(100, hd, 4, 2, dtype, seed=hd, Sk=90)
    q, k, v = _torch(arrs, dtype)
    qp, kp, vp = pad_head_dim(q, k, v)
    hp = padded_head_dim(hd)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == hp > hd
    assert all(t.is_contiguous() and t.dtype == q.dtype
               for t in (qp, kp, vp))
    assert not qp[..., hd:].any() and torch.equal(qp[..., :hd], q)
    got = ref.flash_attention_ref(qp, kp, vp, scale=hd ** -0.5, **kw)
    assert not got[..., hd:].float().any()
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert torch.equal(got[..., :hd], want)
    if hd <= 128:
        # and the reference's oracle at the true hd, at its sweep's tier
        # (set for its head dims, 64 and 128; at hd 200 the longer q.k
        # sums, taken in another order, reach 3.0e-6)
        _assert_within_tier(got[..., :hd],
                            jax_ref.flash_attention_ref(*_jax(arrs, dtype),
                                                        **kw), dtype)


def test_padding_step_keeps_an_instantiated_head_dim_as_given():
    q, k, v = _torch(_operands(64, 64, 2, 2, "float32"), "float32")
    assert all(a is b for a, b in zip(pad_head_dim(q, k, v), (q, k, v)))


# ---------------------------------------------------------------------------
# the CUDA kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


CUDA_CASES = [
    # (S, hd, H, KV, dtype, mask, Sk, q scale)
    (128, 64, 4, 4, "float32", MASKS[0], None, 1.0),
    (256, 64, 4, 2, "float32", MASKS[1], None, 1.0),
    (256, 128, 2, 1, "bfloat16", MASKS[3], None, 1.0),
    (256, 32, 4, 4, "float32", MASKS[2], None, 1.0),
    (512, 128, 32, 16, "bfloat16",
     dict(causal=True, window=128, attn_softcap=50.0), None, 1.0),
    (192, 128, 14, 2, "bfloat16", MASKS[0], None, 1.0),         # G = 7
    (128, 64, 12, 1, "float32", MASKS[0], None, 1.0),           # G = 12
    (128, 128, 48, 1, "bfloat16", MASKS[0], None, 1.0),         # G = 48
    (256, 32, 2, 2, "float32", dict(causal=False, window=64), 128, 1.0),
    (128, 64, 4, 2, "float32", MASKS[0], 256, 1.0),             # Sq < Sk
    (512, 128, 32, 16, "float32",                       # the cap binds
     dict(causal=True, window=128, attn_softcap=50.0), None, 8.0),
    # ragged lengths: the float32 kernel's last q and key tiles
    (100, 32, 4, 2, "float32", RAGGED_MASKS[0], None, 1.0),
    (100, 64, 4, 2, "float32", RAGGED_MASKS[0], None, 1.0),
    (100, 128, 4, 2, "float32", RAGGED_MASKS[0], None, 1.0),
    (100, 32, 4, 2, "float32", RAGGED_MASKS[1], 37, 1.0),
    (100, 64, 4, 2, "float32", RAGGED_MASKS[1], 37, 1.0),
    (100, 128, 4, 2, "float32", RAGGED_MASKS[1], 37, 1.0),
    (300, 64, 12, 12, "float32", dict(causal=True), None, 1.0),
    (37, 64, 4, 2, "float32", dict(causal=True), 200, 1.0),     # Sq < Sk
    (100, 32, 4, 2, "bfloat16", RAGGED_MASKS[0], None, 1.0),
    (1, 128, 4, 1, "float32", dict(causal=True), 1, 1.0),
    # hd 256 (the float32 kernel's widest instance, float32 and bf16) and
    # head dims zero-padded to the next instance (96 -> 128, 20 -> 32,
    # 80 -> 128 on the tensor cores, 200 -> 256)
    (100, 256, 4, 2, "float32", RAGGED_MASKS[0], None, 1.0),
    (512, 256, 8, 2, "float32",                         # the cap binds
     dict(causal=True, window=64, attn_softcap=50.0), None, 8.0),
    (100, 256, 4, 2, "bfloat16", RAGGED_MASKS[1], 37, 1.0),
    (256, 256, 4, 4, "bfloat16", MASKS[3], None, 1.0),
    (256, 96, 8, 2, "float32", MASKS[0], None, 1.0),
    (100, 20, 4, 2, "bfloat16", RAGGED_MASKS[0], None, 1.0),
    (256, 80, 4, 2, "bfloat16", MASKS[1], None, 1.0),
    (100, 200, 4, 1, "float32", RAGGED_MASKS[1], 37, 1.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd,H,KV,dtype,kw,Sk,q_scale", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, S, hd, H, KV, dtype,
                                           kw, Sk, q_scale):
    q, k, v = _torch(_operands(S, hd, H, KV, dtype, seed=S + H, Sk=Sk,
                               q_scale=q_scale), dtype, cuda_device)
    want = ref.flash_attention_ref(q, k, v, **kw)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_within_tier(got, want, dtype,
                        atol_f32=ATOL_F32 if S <= 256 else 1e-5)


TC_CASES = [
    # (Sq, hd, H, KV, mask, Sk, q scale): bf16 through the tensor cores
    (256, 128, 4, 2, dict(causal=True), None, 1.0),
    (256, 64, 4, 2, dict(causal=True), None, 1.0),
    (512, 128, 32, 16, dict(causal=True, window=128, attn_softcap=50.0),
     None, 1.0),
    (384, 64, 4, 1, dict(causal=True, window=100, attn_softcap=50.0), None,
     1.0),
    (256, 128, 2, 2, dict(causal=False), None, 1.0),
    (256, 64, 2, 2, dict(causal=False, window=64), 128, 1.0),  # no live key
    (100, 128, 4, 2, dict(causal=True), None, 1.0),            # ragged
    (100, 64, 4, 2, dict(causal=True, window=16, attn_softcap=50.0), None,
     1.0),
    (100, 128, 4, 2, dict(causal=False), 37, 1.0),
    (1024, 128, 8, 1, dict(causal=True), None, 1.0),
    (512, 128, 4, 2, dict(causal=True, attn_softcap=50.0), None, 8.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd,H,KV,kw,Sk,q_scale", TC_CASES)
def test_cuda_tensor_core_kernel_matches_plain_version(cuda_device, S, hd, H,
                                                       KV, kw, Sk, q_scale):
    q, k, v = _torch(_operands(S, hd, H, KV, "bfloat16", seed=S + hd + H,
                               Sk=Sk, q_scale=q_scale), "bfloat16",
                     cuda_device)
    want = ref.flash_attention_ref(q, k, v, **kw)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    _assert_within_tier(got, want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,name", [
    ("float32", 128, "flash_attention_mma_kernel"),
    ("float32", 64, "flash_attention_mma_kernel"),
    ("float32", 32, "flash_attention_mma_kernel"),
    ("bfloat16", 32, "flash_attention_mma_kernel"),
    ("bfloat16", 128, "flash_attention_tc_kernel"),
    ("bfloat16", 64, "flash_attention_tc_kernel"),
    ("float32", 256, "flash_attention_mma_kernel"),
    ("bfloat16", 256, "flash_attention_mma_kernel"),
    ("bfloat16", 80, "flash_attention_tc_kernel")])
def test_cuda_inputs_reach_the_kernel_their_dtype_and_width_name(
        cuda_device, dtype, hd, name):
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _torch(_operands(128, hd, 4, 2, dtype), dtype, cuda_device)
    flash_attention_fwd(q, k, v)          # loaded before the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):   # the profiler may drop a short window's events
            flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_attention" in e.name]
    assert names and all(name in n for n in names), names
    assert any(("_tc_" in n) == (name.endswith("_tc_kernel"))
               for n in names)


@pytest.mark.cuda
def test_cuda_function_reads_the_model_layout_and_matches_gradients(
        cuda_device):
    arrs = _model_layout_operands()
    kw = dict(causal=True, window=16, attn_softcap=30.0)
    qkv = [torch.tensor(a, device=cuda_device, requires_grad=True)
           for a in arrs]
    before = flash_attention_fwd.launches
    out = ops.flash_attention(*qkv, **kw)
    torch.sum(out ** 2).backward()
    assert flash_attention_fwd.launches == before + 1
    assert out.is_contiguous()
    # against the plain route on the CPU, which the CPU tests hold to the
    # reference (whose Pallas kernel lowers for a TPU or in interpret mode,
    # not for a JAX GPU backend)
    want = _port_grads(lambda q, k, v: ops.flash_attention(q, k, v, **kw),
                       arrs)
    for t, w in zip(qkv, want):
        np.testing.assert_allclose(_f32(t.grad), w.numpy(),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _torch(_operands(128, 64, 4, 2, "float32"), "float32",
                     cuda_device)
    with pytest.raises(ValueError, match="at least one row"):
        flash_attention_fwd(q[:, :, :0], k, v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(*(torch.cat([t] * 5, dim=-1)[..., :264]
                              for t in (q, k, v)))
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention_fwd(q[:, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(2, 3), k, v)


def _round_tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def test_one_rounding_of_p_misses_the_bf16_tier_and_two_bf16_terms_do_not():
    """Why the tensor-core kernel multiplies P V with P in two bf16 terms:
    a dense float32 attention with P = softmax numerators rounded once,
    to bf16 or to TF32, lands outside the bf16 tier of the exact one on
    causal rows with few keys (an output near 0 built from a few large
    weights); hi + lo in bf16 stays inside it, as P unrounded does
    (measured 12.7, 1.57, 0.92 and 0.78 x the tier; the last two are the
    one-ulp flips of rounding a float32 result to bf16)."""
    S, H, KV, hd = 1024, 16, 8, 128
    arrs = _operands(S, hd, H, KV, "bfloat16", seed=21)
    q, k, v = (torch.tensor(a) for a in arrs)
    G = H // KV
    kf, vf = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = q @ kf.transpose(-1, -2) * hd ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    exact = (p.double() @ vf.double() / l.double()).bfloat16()
    hi = p.bfloat16().float()

    def ratio(pp):
        return _tier_ratio((pp @ vf / l).bfloat16(), exact)

    assert ratio(hi) > 1.0
    assert ratio(_round_tf32(p)) > 1.0
    assert ratio(hi + (p - hi).bfloat16().float()) <= 1.0


# ---------------------------------------------------------------------------
# the float32 kernel's numerics, emulated on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.py's float32 flash cases (the 100m training shape, hd 32 full
# and no-live-key rows, gemma2's heads with q x 8 so the cap binds) with S
# cut to 512, and its ragged float32 cases:
# (name, B, H, KV, hd, Sq, mask, Sk or None, q scale)
EMU_CASES = [
    ("train_100m", 2, 12, 12, 64, 512, dict(causal=True), None, 1.0),
    ("full_hd32", 1, 4, 2, 32, 256, dict(causal=False), None, 1.0),
    ("no_live_key_rows", 1, 4, 2, 32, 256, dict(causal=False, window=64),
     128, 1.0),
    ("softcap_binds", 1, 32, 16, 128, 512,
     dict(causal=True, window=4096, attn_softcap=50.0), None, 8.0),
    ("ragged_hd32", 1, 4, 2, 32, 100, RAGGED_MASKS[0], None, 1.0),
    ("ragged_hd64", 1, 4, 2, 64, 100, RAGGED_MASKS[0], None, 1.0),
    ("ragged_hd128", 1, 4, 2, 128, 100, RAGGED_MASKS[0], None, 1.0),
    ("ragged_sk37", 1, 4, 2, 128, 100, RAGGED_MASKS[1], 37, 1.0),
]
KERNEL_ROWS = 64                    # the float32 kernel's q tile


def _kernel_tiles(hd):
    """(keys a tile, key groups) of the float32 kernel at head width hd."""
    return (64, 1) if hd == 128 else (32, 4)


def _emu_operands(case):
    _, B, H, KV, hd, Sq, _, Sk, q_scale = case
    rng = np.random.default_rng(hd + Sq + H)
    Sk = Sq if Sk is None else Sk
    return [torch.from_numpy(c * rng.standard_normal(s, dtype=np.float32))
            for s, c in (((B, H, Sq, hd), q_scale), ((B, KV, Sk, hd), 1.0),
                         ((B, KV, Sk, hd), 1.0))]


def _split_tf32(x):
    """x = hi + lo in TF32, each rounded to nearest (ties away)."""
    hi = _round_tf32(x)
    return hi, _round_tf32(x - hi)


def _fma_scores(q, k):
    """q k^T as float32 FMAs, d in order: each step's product and sum
    exact in float64, rounded once to float32."""
    s = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float32)
    for d in range(q.shape[-1]):
        s = (s.double() + q[..., d, None].double()
             * k[..., None, :, d].double()).float()
    return s


def _emulate_f32_kernel(q, k, v, *, causal=True, window=0,
                        attn_softcap=0.0, scores="fma", pv="3xtf32"):
    """The float32 kernel's arithmetic on float32 CPU tensors: scores
    ``"fma"`` (the kernel), ``"3xtf32"`` (lo.hi + hi.lo + hi.hi) or
    ``"tf32"`` (one TF32 pass); per 64-row block, the key tiles it visits
    (the fully masked ones skipped unless a row has no live key), dealt in
    turn to its key groups (four of 32-key tiles at hd 32 and 64, one of
    64-key tiles at 128), each group's online softmax over its tiles in
    order, P.V with P and V as hi + lo TF32 terms (``pv="3xtf32"``, the
    kernel) or in one TF32 pass, and the groups' states merged in group
    order."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    k, v = (t.repeat_interleave(H // KV, 1) for t in (k, v))
    if scores == "fma":
        s_all = _fma_scores(q, k)
    elif scores == "3xtf32":
        (qh, ql), (kh, kl) = _split_tf32(q), _split_tf32(k)
        s_all = (ql @ kh.mT + qh @ kl.mT) + qh @ kh.mT
    else:
        s_all = _round_tf32(q) @ _round_tf32(k).mT
    vh, vl = _split_tf32(v)
    out = torch.empty_like(q)
    keys_per_tile, groups = _kernel_tiles(hd)
    nk = -(-Sk // keys_per_tile)
    for q0 in range(0, Sq, KERNEL_ROWS):
        rows = torch.arange(q0, min(q0 + KERNEL_ROWS, Sq))
        qmax = int(rows[-1])
        t_lo, t_hi = 0, nk
        if not (window and qmax - (Sk - 1) >= window):
            if causal:
                t_hi = min(nk, qmax // keys_per_tile + 1)
            if window and q0 - window - (keys_per_tile - 1) >= 0:
                t_lo = (q0 - window - (keys_per_tile - 1)) // keys_per_tile + 1
        states = []
        for grp in range(groups):
            states.append(_emulate_group(
                s_all, v, vh, vl, rows,
                [range(t * keys_per_tile, min((t + 1) * keys_per_tile, Sk))
                 for t in range(t_lo + grp, t_hi, groups)],
                hd, causal, window, attn_softcap, pv))
        m, l, acc = states[0]
        for mb, lb, accb in states[1:]:
            m_new = torch.maximum(m, mb)
            ca, cb = torch.exp(m - m_new), torch.exp(mb - m_new)
            m, l, acc = m_new, l * ca + lb * cb, acc * ca + accb * cb
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)
    return out


def _emulate_group(s_all, v, vh, vl, rows, tiles, hd, causal, window,
                   attn_softcap, pv):
    """One key group's (m, l, acc) over ``tiles`` (ranges of keys) in
    order."""
    B, H = s_all.shape[:2]
    m = torch.full((B, H, len(rows), 1), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, len(rows), hd))
    for tile in tiles:
        keys = torch.tensor(tile)
        x = s_all[:, :, rows][..., keys] * hd ** -0.5
        if attn_softcap:
            x = attn_softcap * torch.tanh(x / attn_softcap)
        live = torch.ones((len(rows), len(keys)), dtype=torch.bool)
        if causal:
            live &= rows[:, None] >= keys[None]
        if window:
            live &= rows[:, None] - keys[None] < window
        x = torch.where(live, x, ref.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp(x - m_new)
        corr = torch.exp(m - m_new)
        l, m = l * corr + p.sum(-1, keepdim=True), m_new
        vt_h, vt_l = vh[:, :, keys], vl[:, :, keys]
        if pv == "3xtf32":
            ph, pl = _split_tf32(p)
            pv_t = (pl @ vt_h + ph @ vt_l) + ph @ vt_h
        else:
            pv_t = _round_tf32(p) @ _round_tf32(v[:, :, keys])
        acc = acc * corr + pv_t
    return m, l, acc


def _f32_tier(Sq):
    return ATOL_F32 if Sq <= 256 else 1e-5


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_float32_kernel_numerics_hold_the_float32_tiers(case):
    """FMA scores and P.V in three TF32 terms stay within the tier of the
    plain version (measured 0.07-0.48 x); P.V in one TF32 pass, with the
    same scores, misses it (95-471 x)."""
    q, k, v = _emu_operands(case)
    kw = case[6]
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = _f32_tier(q.shape[2])
    got = _emulate_f32_kernel(q, k, v, **kw)
    err = float((got - want).abs().max())
    assert err <= tol, f"{err} = {err / tol} x the tier"
    one_pass = _emulate_f32_kernel(q, k, v, pv="tf32", **kw)
    assert float((one_pass - want).abs().max()) > tol


@pytest.mark.parametrize("case", [EMU_CASES[0], EMU_CASES[3]],
                         ids=["train_100m", "softcap_binds"])
def test_scores_in_three_tf32_terms_miss_the_tier_where_the_cap_binds(case):
    """Why the float32 kernel scores in FMAs: three TF32 terms hold each
    product to 2^-22 but sum it in another order than the plain version,
    which at scores of tens (q x 8) leaves the two 2.5 x the tier apart
    (measured; the FMA scores 0.26 x); at the training shape's scores of
    ~1 they would pass (0.12 x), and one TF32 pass misses both (80 x and
    940 x)."""
    q, k, v = _emu_operands(case)
    kw = case[6]
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = _f32_tier(q.shape[2])

    def ratio(scores):
        got = _emulate_f32_kernel(q, k, v, scores=scores, **kw)
        return float((got - want).abs().max()) / tol

    assert ratio("tf32") > 10
    if kw.get("attn_softcap"):
        assert ratio("3xtf32") > 1.5
    else:
        assert ratio("3xtf32") < 0.5
