"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and the ssm family
(xlstm-350m's smoke config) against the reference on the CPU.

The reference draws the parameters (``params_from_jax`` carries them
across) and both packages take the same numpy inputs.  Tiers:

  * float32: 1e-5 of the largest reference value (absolute) and 1e-5
    relative, for the chunkwise mLSTM, the sLSTM scan, both blocks'
    forward and decode (outputs and state), the model's logits and loss;
    a block's gradients 1e-5 relative in norm, leaf by leaf, the model's
    1e-4 (the zoo tests' gradient tier: ``fgate_b``'s gradient sums the
    forget-gate cotangents of every position and head with cancellation,
    measured 1.4e-5, every other leaf below 6e-6).  The reference's own
    properties, on the port: the chunkwise mLSTM equals the sequential
    recurrence, and token-by-token decode equals the forward, within the
    same 1e-5;
  * bf16: ``||port - ref|| / ||ref|| <= 3.5e-2`` on the model's logits.
    Each xLSTM layer divides by the normalizer |q . n|, so a bf16 rounding
    one place off grows through the layers: the reference's own jitted and
    eager bf16 runs lie 1.28e-2 apart, and each 1.77e-2 from its float32
    run on the same weights; the port's bf16 run lies 2.16e-2 from the
    reference's (two roundings of one float32 value, each ~1.8e-2 away).
    The control, the port with every bf16 result rounded to one mantissa
    bit fewer (``CoarseBF16``), lies 4.67e-2 away and fails the tier.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import AlgoConfig as JaxAlgoConfig  # noqa: E402
from repro.core import MultiLearnerTrainer as JaxTrainer  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.core.util import value_and_grad  # noqa: E402
from repro_torch.models import build_model, xlstm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.models.transformer import period_spec  # noqa: E402

D, H = 32, 2
ARCH = "xlstm-350m"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
BF16_RTOL = 3.5e-2


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-5,
                               err_msg=what)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _block(kind, dtype=jnp.float32, seed=0):
    init = {"mlstm": jx.init_mlstm_params, "slstm": jx.init_slstm_params}
    cls = {"mlstm": xlstm.MLSTMParams, "slstm": xlstm.SLSTMParams}
    jp = init[kind](jax.random.PRNGKey(seed), D, H, dtype)
    tp = tree_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, cls[kind](**tp)


def _x(B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D), dtype=np.float32)


def _qkv(B, S, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, dh), dtype=np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B, S, H), dtype=np.float32)
    fg = rng.standard_normal((B, S, H), dtype=np.float32) + 2.0
    return q, k, v, ig, fg


# -- the mLSTM and sLSTM recurrences -------------------------------------------

@pytest.mark.parametrize("S,chunk", [(16, 4), (24, 8), (8, 64), (12, 3)])
def test_mlstm_chunkwise_matches_reference(S, chunk):
    """Outputs and the final state, from a zero and from a given state."""
    q, k, v, ig, fg = _qkv(2, S, 8, S)
    rng = np.random.default_rng(99)
    state = {"C": rng.standard_normal((2, H, 8, 8), dtype=np.float32),
             "n": rng.standard_normal((2, H, 8), dtype=np.float32),
             "m": rng.standard_normal((2, H), dtype=np.float32)}
    for st in (None, state):
        jh, js = jx.mlstm_chunkwise(
            *map(jnp.asarray, (q, k, v, ig, fg)), chunk,
            state=None if st is None else jax.tree_util.tree_map(
                jnp.asarray, st), return_state=True)
        h, s = xlstm.mlstm_chunkwise(
            *map(torch.tensor, (q, k, v, ig, fg)), chunk,
            state=None if st is None else {n: torch.tensor(x)
                                           for n, x in st.items()},
            return_state=True)
        _close(h.numpy(), jh, f"h, state {st is not None}")
        for name in ("C", "n", "m"):
            _close(s[name].numpy(), js[name], name)


def _sequential_mlstm(q, k, v, ig, fg):
    """The stabilised mLSTM recurrence one step at a time (the reference's
    own test's ground truth, in torch)."""
    B, S, Hh, dh = q.shape
    C = torch.zeros((B, Hh, dh, dh))
    n = torch.zeros((B, Hh, dh))
    m = torch.zeros((B, Hh))
    outs = []
    for t in range(S):
        logf = torch.nn.functional.logsigmoid(fg[:, t])
        m_new = torch.maximum(logf + m, ig[:, t])
        fp, ip = torch.exp(logf + m - m_new), torch.exp(ig[:, t] - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", k[:, t], v[:, t])
        n = fp[..., None] * n + ip[..., None] * k[:, t]
        qt = q[:, t] * dh ** -0.5
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qt, n))
        outs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(outs, 1)


def test_mlstm_chunkwise_equals_sequential_recurrence():
    q, k, v, ig, fg = map(torch.tensor, _qkv(1, 16, 8, 0))
    _close(xlstm.mlstm_chunkwise(q, k, v, ig, fg, chunk=4).numpy(),
           _sequential_mlstm(q, k, v, ig, fg).numpy())


@pytest.mark.parametrize("S,chunk", [(16, 4), (9, 64)])
def test_slstm_scan_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    dh = D // H
    wx = rng.standard_normal((2, S, 4 * D), dtype=np.float32)
    r = rng.standard_normal((H, dh, 4 * dh), dtype=np.float32) / 4
    h0, c0, n0, m0 = (rng.standard_normal((2, H, dh), dtype=np.float32)
                      for _ in range(4))
    n0 = np.abs(n0)
    jhs, jc = jx.slstm_scan(*map(jnp.asarray, (wx, r, h0, c0, n0, m0)), H,
                            chunk)
    hs, c = xlstm.slstm_scan(*map(torch.tensor, (wx, r, h0, c0, n0, m0)),
                             H, chunk)
    _close(hs.numpy(), jhs, "hs")
    for name, a, b in zip("hcnm", c, jc):
        _close(a.numpy(), b, name)


def test_ragged_chunks_raise_value_error():
    q, k, v, ig, fg = map(torch.tensor, _qkv(1, 12, 8, 0))
    with pytest.raises(ValueError, match="multiple"):
        xlstm.mlstm_chunkwise(q, k, v, ig, fg, chunk=5)
    z = torch.zeros((1, H, D // H))
    with pytest.raises(ValueError, match="multiple"):
        xlstm.slstm_scan(torch.zeros((1, 12, 4 * D)), torch.zeros(
            (H, D // H, 4 * D // H)), z, z, z, z, H, chunk=5)


# -- the blocks -------------------------------------------------------------------

KINDS = ["mlstm", "slstm"]


def _forward(kind, lib, params, x, chunk=4):
    mod = jx if lib == "jax" else xlstm
    fn = getattr(mod, f"{kind}_block_forward")
    return fn(params, x, n_heads=H, chunk=chunk)


@pytest.mark.parametrize("kind", KINDS)
def test_block_forward_matches_reference(kind):
    jp, p = _block(kind)
    x = _x(2, 16)
    with torch.no_grad():
        got = _forward(kind, "torch", p, torch.tensor(x))
    _close(got.numpy(), _forward(kind, "jax", jp, jnp.asarray(x)))


def _decode_run(kind, lib, params, x, dtype=None):
    """Token-by-token decode of x (numpy, float32) in ``dtype`` (the
    parameters' by default) -> (outputs (B, S, D) float32, final cache)."""
    mod = jx if lib == "jax" else xlstm
    if lib == "jax":
        def conv(a):
            return jnp.asarray(a, dtype or jnp.float32)
        cache_dt = dict(dtype=dtype or jnp.float32)
    else:
        def conv(a):
            return torch.tensor(a).to(dtype or torch.float32)
        cache_dt = dict(dtype=dtype or torch.float32)
    cache = (mod.init_mlstm_cache(x.shape[0], D, H, **cache_dt)
             if kind == "mlstm" else mod.init_slstm_cache(x.shape[0], D, H))
    outs = []
    for t in range(x.shape[1]):
        o, cache = getattr(mod, f"{kind}_block_decode")(
            params, cache, conv(x[:, t:t + 1]), n_heads=H)
        outs.append(_np(o) if lib == "jax" else o.float().numpy())
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("kind", KINDS)
def test_block_decode_matches_reference_and_forward(kind):
    """Token-by-token decode equals the reference's decode (outputs and
    every state leaf) and the port's own forward over the sequence."""
    jp, p = _block(kind, seed=2)
    x = _x(3, 8, seed=3)
    jout, jcache = _decode_run(kind, "jax", jp, x)
    with torch.no_grad():
        out, cache = _decode_run(kind, "torch", p, x)
        full = _forward(kind, "torch", p, torch.tensor(x))
    _close(out, jout, "decode")
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        _close(cache[name].numpy(), jcache[name], name)
    _close(out, full.numpy(), "decode against forward")


@pytest.mark.parametrize("kind", KINDS)
def test_block_gradients_match_reference(kind):
    jp, p = _block(kind, seed=4)
    x = _x(2, 8, seed=5)
    r = np.random.default_rng(6).standard_normal((2, 8, D),
                                                  dtype=np.float32)

    def jloss(pp):
        return jnp.sum(_forward(kind, "jax", pp, jnp.asarray(x)) * r)

    jg = jax.grad(jloss)(jp)
    torch.sum(_forward(kind, "torch", p, torch.tensor(x))
              * torch.tensor(r)).backward()
    for name, g in jg.items():
        got = getattr(p, name).grad.numpy()
        rel = np.linalg.norm(got - np.asarray(g)) / max(
            np.linalg.norm(np.asarray(g)), 1e-30)
        assert rel <= 1e-5, f"{name}: relative error {rel}"


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_block_keeps_float32_state(kind):
    """A bf16 block: projections in bf16, the gates, recurrences and state
    in float32, the conv history in bf16; output within the bf16 tier of
    the reference's after 4 decode steps."""
    jp, p = _block(kind, dtype=jnp.bfloat16, seed=7)
    x = _np(jnp.asarray(_x(2, 4, seed=8), jnp.bfloat16))
    with torch.no_grad():
        out, cache = _decode_run(kind, "torch", p, x, torch.bfloat16)
    jout, _ = _decode_run(kind, "jax", jp, x, jnp.bfloat16)
    for name, t in cache.items():
        want = torch.bfloat16 if name == "conv" else torch.float32
        assert t.dtype == want, (name, t.dtype)
    assert _rel(out, jout) <= BF16_RTOL


# -- the ssm family: xlstm-350m's smoke config ----------------------------------

def _models(**overrides):
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke_config(),
                               **overrides)
    cfg = dataclasses.replace(get_config(ARCH).smoke_config(), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def models():
    return _models()


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


def test_period_spec_and_leaves_match_reference(models):
    """[mLSTM, sLSTM] periods with no FFN of their own; the port's tree has
    the reference's leaves in its order, ``norm1`` (read by no block)
    included."""
    from repro.models import transformer as jt
    from repro_torch.tree import tree_flatten
    japi, jparams, api, params = models
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (api.cfg, japi.cfg)):
        assert period_spec(cfg) == jt.period_spec(jcfg) == (
            ("mlstm", "none"), ("slstm", "none"))
    leaves, _ = tree_flatten(api.param_tree(params))
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert [tuple(x.shape) for x in leaves] == [x.shape for _, x in jleaves]
    assert "norm1" in api.param_tree(params)["periods"]["l0"]
    assert "norm2" not in api.param_tree(params)["periods"]["l0"]


def test_apply_and_loss_match_reference(models):
    japi, jparams, api, params = models
    b = _batch(api.cfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    with torch.no_grad():
        got = api.apply(params, tb).numpy()
        loss = float(api.loss_fn(params, tb))
    _close(got, japi.apply(jparams, jb))
    jloss = float(japi.loss_fn(jparams, jb))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)


def test_gradients_match_reference(models):
    """Every leaf's loss gradient within 1e-4 relative; the unread
    ``norm1`` leaves get 0, as in the reference."""
    japi, jparams, api, params = models
    b = _batch(api.cfg.vocab, seed=1)
    jg = jax.grad(japi.loss_fn)(jparams, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    _, g = value_and_grad(api.loss_fn, api.param_tree(params),
                          {k: torch.tensor(v) for k, v in b.items()},
                          api.params_from_tree)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    from repro_torch.tree import tree_leaves
    for (path, want), got in zip(jflat, tree_leaves(g)):
        want, got = np.asarray(want), got.numpy()
        if "norm1" in jax.tree_util.keystr(path):
            assert not want.any() and not got.any()
            continue
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-4, f"{jax.tree_util.keystr(path)}: {rel}"


class CoarseBF16(torch.overrides.TorchFunctionMode):
    """Rounds every new bf16 result to one mantissa bit fewer (the control
    a bf16 tier must reject); views and in-place results pass unchanged."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (isinstance(out, torch.Tensor)
                and out.dtype == torch.bfloat16):
            return out
        ptr = out.untyped_storage().data_ptr()
        if any(isinstance(a, torch.Tensor)
               and a.untyped_storage().data_ptr() == ptr
               for a in (*args, *(kwargs or {}).values())):
            return out
        bits = out.view(torch.int16).to(torch.int32)
        return ((bits + 1) // 2 * 2).to(torch.int16).view(torch.bfloat16)


@pytest.fixture(scope="module")
def bf16_run():
    japi, jparams, api, params = _models(**BF16)
    b = {"tokens": _batch(api.cfg.vocab)["tokens"]}
    want = _np(japi.apply(jparams, {"tokens": jnp.asarray(b["tokens"])}))
    with torch.no_grad():
        got = api.apply(params, {"tokens": torch.tensor(b["tokens"])})
        with CoarseBF16():
            coarse = api.apply(params, {"tokens": torch.tensor(b["tokens"])})
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), coarse.float().numpy(), want


def test_bf16_apply_matches_reference(bf16_run):
    got, _, want = bf16_run
    assert _rel(got, want) <= BF16_RTOL


def test_bf16_tier_rejects_one_bit_less_precision(bf16_run):
    _, coarse, want = bf16_run
    assert _rel(coarse, want) > BF16_RTOL


def test_rotating_decode_matches_reference_and_apply(models):
    """``decode_step`` (a shared position, the rotating cache) against the
    reference's, and the port's decode against its own ``apply``."""
    japi, jparams, api, params = models
    vocab, B, S = api.cfg.vocab, 2, 8
    toks = np.random.default_rng(3).integers(0, vocab, (B, S)).astype(
        np.int32)
    cache = api.init_cache(params, B, S)
    jcache = japi.init_cache(jparams, B, S)
    got, want = [], []
    for pos in range(S):
        lg, cache = api.decode_step(params, cache,
                                    torch.tensor(toks[:, pos:pos + 1]), pos)
        jl, jcache = japi.decode_step(jparams, jcache,
                                      jnp.asarray(toks[:, pos:pos + 1]), pos)
        got.append(lg.numpy())
        want.append(np.asarray(jl))
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    _close(got, want, "decode")
    with torch.no_grad():
        full = api.apply(params, {"tokens": torch.tensor(toks)}).numpy()
    _close(got, full, "decode against apply")


def test_dpsgd_flat_step_matches_reference(models):
    """Two flat-engine DPSGD steps (4 learners, random_pair, sgd with
    momentum) on the reference's batches and partner tables: the store,
    the momentum and the metrics within the trainer tests' tiers."""
    japi, jparams, api, _ = models
    n, b, seq = 4, 2, 16
    jtr = JaxTrainer(japi.loss_fn, jax_optim.sgd(0.1, momentum=0.9),
                     JaxAlgoConfig(algo="dpsgd", topology="random_pair",
                                   n_learners=n), engine="flat",
                     kernel_backend="ref")
    ptr = MultiLearnerTrainer(api.loss_fn, optim.sgd(0.1, momentum=0.9),
                              AlgoConfig(algo="dpsgd",
                                         topology="random_pair",
                                         n_learners=n),
                              params_from_tree=api.params_from_tree,
                              device="cpu")
    assert ptr.is_flat and ptr.is_fused
    jstate = jtr.init(jax.random.PRNGKey(0), jparams)
    pstate = ptr.init(0, tree_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jparams)))
    for step in range(2):
        batch = {k: v.reshape((n, b) + v.shape[1:]) for k, v in _batch(
            api.cfg.vocab, B=n * b, S=seq, seed=10 + step).items()}
        pstate, pm = ptr.train_step(
            pstate, {k: torch.tensor(v) for k, v in batch.items()},
            reference_rounds(jtr, jstate))
        jstate, jm = jtr.train_step(jstate, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        compare_states(jstate, jm, pstate, pm, f"xlstm step {step}")


def reference_rounds(tr, state):
    """The partner / coefficient tables the reference's flat engine uses
    at ``state.step`` (its ``jax.random`` matchings)."""
    key = jax.random.fold_in(state.rng, state.step)
    k_mix, _ = jax.random.split(key)
    return [(np.array(p), np.array(c))
            for p, c in tr._schedule.step_rounds(k_mix, int(state.step))]


def compare_states(jstate, jm, pstate, pm, what):
    """Store and momentum within 1e-4 absolute + 1e-4 relative, the loss,
    gradient norm and consensus distance 1e-4 relative (the trainer
    tests' tiers for a model after 2 steps)."""
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pstate.params.numpy(),
                               np.asarray(jstate.params), **tol,
                               err_msg=f"{what} params")
    np.testing.assert_allclose(pstate.opt_state["mu"].numpy(),
                               np.asarray(jstate.opt_state["mu"]), **tol,
                               err_msg=f"{what} momentum")
    for f in ("loss", "grad_norm", "sigma_w_sq"):
        np.testing.assert_allclose(float(getattr(pm, f)),
                                   float(getattr(jm, f)), rtol=1e-4,
                                   atol=1e-12, err_msg=f"{what} {f}")
