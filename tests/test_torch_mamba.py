"""The port's Mamba block (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba`` on the CPU.

The reference draws the parameters and both packages take the same numpy
inputs.  Tiers: the chunked scan 1e-6 (the port runs the combines of
``jax.lax.associative_scan`` in the same order; XLA may contract a
multiply-add into one rounding); ``mamba_forward`` and ``mamba_decode`` in
float32 1e-5 (absolute and relative: the projections sum in other
orders); in bf16, ``||port - ref|| / ||ref|| <= 2e-2`` (the dense bf16
tier: the two frameworks round bf16 at other places).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import mamba as jm  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402

D, N, CONV = 32, 8, 4
KW = dict(expand=2, state=N, conv=CONV)
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_RTOL = 2e-2


def _params(dtype=jnp.float32, seed=0):
    jp = jm.init_mamba_params(jax.random.PRNGKey(seed), D, dtype=dtype, **KW)
    tp = tree_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, mamba.MambaParams(**tp)


def _x(B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D), dtype=np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("S,chunk", [(16, 4), (24, 8), (10, 64), (7, 7),
                                     (12, 3)])
def test_chunked_scan_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    B, di = 2, 6
    a = rng.uniform(0.5, 1.0, (B, S, di, N)).astype(np.float32)
    b = rng.standard_normal((B, S, di, N), dtype=np.float32)
    h0 = rng.standard_normal((B, di, N), dtype=np.float32)
    jhs, jh = jm._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0), chunk)
    hs, h = mamba._ssm_scan_chunked(torch.tensor(a), torch.tensor(b),
                                    torch.tensor(h0), chunk)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6,
                               rtol=1e-6)
    # and it is the recurrence h_t = a_t h_{t-1} + b_t
    want, hh = [], h0.astype(np.float64)
    for t in range(S):
        hh = a[:, t] * hh + b[:, t]
        want.append(hh)
    np.testing.assert_allclose(hs.numpy(), np.stack(want, 1), atol=1e-5,
                               rtol=1e-5)


def test_ragged_chunk_raises_value_error():
    a = torch.ones((1, 10, 2, N))
    with pytest.raises(ValueError, match="scan chunk"):
        mamba._ssm_scan_chunked(a, a, torch.zeros((1, 2, N)), 4)
    _, p = _params()
    with pytest.raises(ValueError, match="scan chunk"):
        mamba.mamba_forward(p, torch.zeros((1, 10, D)), scan_chunk=4, **KW)


@pytest.mark.parametrize("S,chunk", [(16, 4), (12, 64)])
def test_mamba_forward_matches_reference(S, chunk):
    jp, p = _params()
    x = _x(2, S)
    jy, jh = jm.mamba_forward(jp, jnp.asarray(x), scan_chunk=chunk,
                              return_state=True, **KW)
    with torch.no_grad():
        y, h = mamba.mamba_forward(p, torch.tensor(x), scan_chunk=chunk,
                                   return_state=True, **KW)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_mamba_forward_bf16_matches_reference_and_keeps_dtypes():
    jp, p = _params(jnp.bfloat16)
    for name in ("a_log", "d", "dt_bias"):
        assert getattr(p, name).dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                 "out_proj"):
        assert getattr(p, name).dtype == torch.bfloat16, name
    x = _x(2, 16)
    jy = jm.mamba_forward(jp, jnp.asarray(x, jnp.bfloat16), scan_chunk=8,
                          **KW)
    with torch.no_grad():
        y = mamba.mamba_forward(p, torch.tensor(x).to(torch.bfloat16),
                                scan_chunk=8, **KW)
    assert y.dtype == torch.bfloat16
    assert _rel(y.float().numpy(), np.asarray(jy, np.float32)) <= BF16_RTOL


def test_bf16_layer_takes_dt_and_the_scan_in_float32(monkeypatch):
    """dt is the float32 softplus of the bf16 ``dt_in @ dt_proj`` plus the
    float32 ``dt_bias`` (the reference's promotion, 1e-6), and the scan
    runs on float32 operands.  No bf16 output can hold either rule: dt or
    the scan put in bf16 moves a bf16 layer at (2, 16, 256) from 4.49e-3
    to 4.49e-3 / 4.53e-3 of the reference, and jamba's smoke logits from
    2.91e-2 to 2.75e-2 / 2.91e-2, below their own bf16 rounding; so the
    rule is held here, where a bf16 dt misses 1e-6 by orders."""
    jp, p = _params(jnp.bfloat16)
    dt_in = np.random.default_rng(3).standard_normal(
        (2, 16, p.dt_proj.shape[0]), dtype=np.float32)
    want = jax.nn.softplus(jnp.asarray(dt_in, jnp.bfloat16) @ jp["dt_proj"]
                           + jp["dt_bias"])
    with torch.no_grad():
        got = mamba._dt(p, torch.tensor(dt_in).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-6, rtol=1e-6)

    seen, scan = [], mamba._ssm_scan_chunked

    def recording(a, b, h0, chunk):
        seen.append((a.dtype, b.dtype, h0.dtype))
        return scan(a, b, h0, chunk)

    monkeypatch.setattr(mamba, "_ssm_scan_chunked", recording)
    with torch.no_grad():
        mamba.mamba_forward(p, torch.tensor(_x(2, 16)).to(torch.bfloat16),
                            scan_chunk=8, **KW)
    assert seen == [(torch.float32,) * 3]


def _decode_run(step, init_cache, params, x, lib):
    cache = init_cache(x.shape[0], D, **KW)
    outs = []
    for t in range(x.shape[1]):
        o, cache = step(params, cache, lib(x[:, t:t + 1]), **KW)
        outs.append(np.asarray(o))
    return np.concatenate(outs, axis=1), cache


def test_mamba_decode_matches_reference_and_forward():
    """Token-at-a-time decode: equal to the reference's decode, and to the
    port's own prefill forward (outputs and the final state)."""
    jp, p = _params()
    x = _x(3, 9)
    jout, jcache = _decode_run(jm.mamba_decode, jm.init_mamba_cache, jp, x,
                               jnp.asarray)
    with torch.no_grad():
        out, cache = _decode_run(mamba.mamba_decode, mamba.init_mamba_cache,
                                 p, x, torch.tensor)
        full, h = mamba.mamba_forward(p, torch.tensor(x), scan_chunk=9,
                                      return_state=True, **KW)
    np.testing.assert_allclose(out, jout, **TOL)
    for name in ("conv", "h"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(out, full.numpy(), **TOL)
    np.testing.assert_allclose(cache["h"].numpy(), h.numpy(), **TOL)


def test_mamba_decode_bf16_cache_dtypes():
    jp, p = _params(jnp.bfloat16)
    cache = mamba.init_mamba_cache(2, D, dtype=torch.bfloat16, **KW)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["h"].dtype == torch.float32
    x = _x(2, 4)
    jcache = jm.init_mamba_cache(2, D, dtype=jnp.bfloat16, **KW)
    with torch.no_grad():
        for t in range(4):
            xt = x[:, t:t + 1]
            jo, jcache = jm.mamba_decode(jp, jcache,
                                         jnp.asarray(xt, jnp.bfloat16), **KW)
            o, cache = mamba.mamba_decode(p, cache, torch.tensor(xt).to(
                torch.bfloat16), **KW)
            assert _rel(o.float().numpy(),
                        np.asarray(jo, np.float32)) <= BF16_RTOL
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["h"].dtype == torch.float32
    assert _rel(cache["h"].numpy(), np.asarray(jcache["h"])) <= BF16_RTOL


def test_gradients_match_reference():
    jp, p = _params()
    x = _x(2, 8)
    r = np.random.default_rng(5).standard_normal((2, 8, D), dtype=np.float32)

    def jloss(pp):
        return jnp.sum(jm.mamba_forward(pp, jnp.asarray(x), scan_chunk=4,
                                        **KW) * r)

    jg = jax.grad(jloss)(jp)
    loss = torch.sum(mamba.mamba_forward(p, torch.tensor(x), scan_chunk=4,
                                         **KW) * torch.tensor(r))
    loss.backward()
    for name, g in jg.items():
        np.testing.assert_allclose(getattr(p, name).grad.numpy(),
                                   np.asarray(g), err_msg=name, **TOL)
