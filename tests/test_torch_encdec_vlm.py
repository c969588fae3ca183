"""The port's vlm family (qwen2-vl-7b: M-RoPE, patch embeddings before the
text) and audio family (seamless-m4t-large-v2: the encoder-decoder)
against the reference on the CPU, at their smoke configs.

The reference draws the parameters (``params_from_jax`` carries them
across) and both packages take the same numpy inputs.  Tiers:

  * float32: 1e-5 of the largest reference value (absolute) and 1e-5
    relative, for ``apply_mrope``, cross-attention, ``encode``, ``apply``,
    the cross K/V of ``init_cache``, ``decode_step``, and the loss;
    gradients 1e-4 relative in norm (the zoo tests' gradient tier;
    measured at most 2.6e-6).  The reference's own property, on the port:
    the encoder-decoder's token-by-token decode equals its teacher-forced
    forward, within the same 1e-5 (the reference's own test allows 2e-2);
  * bf16: every logit within 2e-2 of the largest reference logit plus
    2e-2 of its own value (the dense and moe tier); the control, the port
    with every bf16 result rounded to one mantissa bit fewer
    (``CoarseBF16``), reaches 1.37 (qwen2-vl) and 1.36 (seamless) times
    that tier and fails it; the sound runs 0.53 and 0.36 times.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model import _mrope_positions as jax_mrope_positions  # noqa: E402,E501
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AlgoConfig, MultiLearnerTrainer  # noqa: E402
from repro_torch.core.util import value_and_grad  # noqa: E402
from repro_torch.models import build_model, encdec, make_synthetic_batch  # noqa: E402,E501
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import AttnParams, attn_forward  # noqa: E402,E501
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402
from repro_torch.models.layers import apply_mrope, apply_rope  # noqa: E402
from repro_torch.models.model import _mrope_positions  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

VLM, AUDIO = "qwen2-vl-7b", "seamless-m4t-large-v2"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
BF16_TIER = 2e-2


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), _np(want)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-5,
                               err_msg=what)


def _t(x):
    return x.detach().float().numpy()


# -- M-RoPE ---------------------------------------------------------------------

@pytest.mark.parametrize("sections,shape", [
    ((8, 12, 12), (2, 10, 4, 64)),
    ((16, 24, 24), (1, 6, 2, 128)),
    ((1, 2, 1), (3, 5, 2, 8))])
def test_apply_mrope_matches_reference(sections, shape):
    """Frequency i rotates by the t, h or w id of its section; (3, S) ids
    and the decode step's (3, 1)."""
    rng = np.random.default_rng(len(sections) + shape[-1])
    x = rng.standard_normal(shape, dtype=np.float32)
    S = shape[1]
    for pos in (rng.integers(0, 50, (3, S)), np.full((3, 1), 7)):
        xs = x[:, :pos.shape[1]]
        got = apply_mrope(torch.tensor(xs), torch.tensor(pos), 1e6, sections)
        want = jlayers.apply_mrope(jnp.asarray(xs), jnp.asarray(pos), 1e6,
                                   sections)
        _close(got.numpy(), want)


def test_apply_mrope_with_equal_ids_is_rope():
    """t = h = w: M-RoPE is the 1-D rotation (a text token's)."""
    x = torch.randn((1, 5, 2, 64), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)
    torch.testing.assert_close(apply_mrope(x, pos.expand(3, -1), 1e4,
                                           (8, 12, 12)),
                               apply_rope(x, pos, 1e4), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(x, pos.expand(3, -1), 1e4, (8, 12, 11))


@pytest.mark.parametrize("P,S_text", [(8, 5), (9, 3), (1, 4), (16, 0),
                                      (1024, 7), (10, 2)])
def test_mrope_positions_match_reference(P, S_text):
    cfg = get_config(VLM).smoke_config()
    got = _mrope_positions(cfg, P, S_text)
    want = np.asarray(jax_mrope_positions(jax_get_config(VLM).smoke_config(),
                                          P, S_text))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- attention: cross-attention and mask positions ------------------------------

def _attn(d=64, H=4, KV=2, hd=16, seed=0):
    jp = jattn.init_attn_params(jax.random.PRNGKey(seed), d, H, KV, hd,
                                jnp.float32)
    tp = tree_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, AttnParams(tp["wq"], tp["wk"], tp["wv"], tp["wo"])


def test_cross_attention_matches_reference():
    """kv_input: keys from the memory, rotated and masked at 0..Sk-1,
    non-causal; GQA (4 heads on 2), Sk != S, chunked over both."""
    jp, p = _attn()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 64), dtype=np.float32)
    mem = rng.standard_normal((2, 20, 64), dtype=np.float32)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, causal=False, chunk=4)
    pos = np.arange(12)
    want = jattn.attn_forward(
        jp, jnp.asarray(x), rope_fn=lambda a, q: jlayers.apply_rope(
            a, q, 1e4), q_positions=jnp.asarray(pos),
        kv_input=jnp.asarray(mem), **kw)
    got = attn_forward(p, torch.tensor(x),
                       rope_fn=lambda a, q: apply_rope(a, q, 1e4),
                       q_positions=torch.tensor(pos),
                       kv_input=torch.tensor(mem), **kw)
    _close(_t(got), want)


def test_mrope_attention_masks_by_the_time_ids():
    """(3, S) ids rotate q and k; their t row masks (image patches share
    t = 0 and see one another)."""
    jp, p = _attn(seed=2)
    cfg = dataclasses.replace(get_config(VLM).smoke_config(),
                              mrope_sections=(2, 3, 3))
    pos = _mrope_positions(cfg, 9, 7)
    x = np.random.default_rng(3).standard_normal((1, 16, 64),
                                                 dtype=np.float32)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, chunk=8)
    want = jattn.attn_forward(
        jp, jnp.asarray(x), rope_fn=lambda a, q: jlayers.apply_mrope(
            a, q, 1e6, (2, 3, 3)), q_positions=jnp.asarray(pos.numpy()),
        mask_positions=jnp.asarray(pos[0].numpy()), **kw)
    got = attn_forward(p, torch.tensor(x),
                       rope_fn=lambda a, q: apply_mrope(a, q, 1e6,
                                                        (2, 3, 3)),
                       q_positions=pos, mask_positions=pos[0], **kw)
    _close(_t(got), want)


def test_flash_route_refuses_what_the_reference_cannot_run():
    """``use_pallas`` takes self-attention at positions contiguous from 0:
    cross-attention and separate mask positions raise, as does
    ``build_model`` for the vlm and audio families."""
    _, p = _attn()
    x = torch.zeros((1, 8, 64))
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_fn=None,
              q_positions=torch.arange(8), use_pallas=True)
    with pytest.raises(ValueError, match="cross-attention"):
        attn_forward(p, x, kv_input=torch.zeros((1, 4, 64)), **kw)
    with pytest.raises(ValueError, match="M-RoPE"):
        attn_forward(p, x, mask_positions=torch.arange(8), **kw)
    for name in (VLM, AUDIO):
        cfg = dataclasses.replace(get_config(name), use_pallas=True)
        with pytest.raises(ValueError, match="use_pallas"):
            build_model(cfg, device="cpu")


# -- the models ---------------------------------------------------------------

def _models(arch, **overrides):
    jcfg = dataclasses.replace(jax_get_config(arch).smoke_config(),
                               **overrides)
    cfg = dataclasses.replace(get_config(arch).smoke_config(), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    return japi, jparams, api, params


@pytest.fixture(scope="module", params=[VLM, AUDIO])
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def audio():
    return _models(AUDIO)


@pytest.fixture(scope="module")
def vlm():
    return _models(VLM)


def _batch(cfg, B=2, seq=32, seed=0, n=None):
    """numpy batch of ``train_batch_spec``'s shapes (leading (n, B) when
    ``n`` is given)."""
    rng = np.random.default_rng(seed)
    lead = (B,) if n is None else (n, B)
    spec = build_model(cfg, device="cpu").train_batch_spec(B, seq)
    out = {}
    for name, (shape, dtype) in spec.items():
        shape = lead + shape[1:]
        if name == "mask":
            out[name] = (rng.random(shape) > 0.2).astype(np.float32)
        elif dtype == torch.int32:
            out[name] = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        else:
            out[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _jax_batch(b, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 and k != "mask"
                           else None) for k, v in b.items()}


def _torch_batch(b, dtype=torch.float32):
    return {k: (torch.tensor(v).to(dtype) if v.dtype == np.float32
                and k != "mask" else torch.tensor(v)) for k, v in b.items()}


def test_train_batch_spec_matches_reference(models):
    japi, _, api, _ = models
    for B, seq in ((2, 32), (4, 64)):
        want = japi.train_batch_spec(B, seq)
        got = api.train_batch_spec(B, seq)
        assert sorted(got) == sorted(want)
        for k, (shape, dtype) in got.items():
            assert shape == want[k].shape, k
            assert str(dtype).split(".")[-1] == str(want[k].dtype), k
    batch = make_synthetic_batch(api.cfg, 0, 2, 32, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: s for k, s in api.train_batch_spec(2, 32).items()}
    assert (batch["mask"] == 1).all()
    assert int(batch["tokens"].max()) < api.cfg.vocab


def test_apply_and_loss_match_reference(models):
    japi, jparams, api, params = models
    b = _batch(api.cfg)
    with torch.no_grad():
        got = api.apply(params, _torch_batch(b)).numpy()
        loss = float(api.loss_fn(params, _torch_batch(b)))
    _close(got, japi.apply(jparams, _jax_batch(b)))
    jloss = float(japi.loss_fn(jparams, _jax_batch(b)))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)


def test_gradients_match_reference(models):
    japi, jparams, api, params = models
    b = _batch(api.cfg, seed=1)
    jg = jax.grad(japi.loss_fn)(jparams, _jax_batch(b))
    _, g = value_and_grad(api.loss_fn, api.param_tree(params),
                          _torch_batch(b), api.params_from_tree)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = tree_leaves(g)
    assert len(got) == len(jflat)
    for (path, want), x in zip(jflat, got):
        want = np.asarray(want)
        rel = np.linalg.norm(x.numpy() - want) / max(np.linalg.norm(want),
                                                     1e-30)
        assert rel <= 1e-4, f"{jax.tree_util.keystr(path)}: {rel}"


def test_vlm_loss_is_over_the_text_only(vlm):
    """The patches come first and feed the text (changing them changes the
    loss), and the loss is the text positions' cross-entropy alone."""
    from repro_torch.models.layers import cross_entropy
    _, _, api, params = vlm
    P = api.cfg.n_frontend_tokens
    b = _torch_batch(_batch(api.cfg, seed=2))
    with torch.no_grad():
        logits = api.apply(params, b)
        loss = float(api.loss_fn(params, b))
        moved = float(api.loss_fn(params, {**b, "patch_embeds":
                                           b["patch_embeds"] + 1.0}))
    assert logits.shape[1] == P + b["tokens"].shape[1]
    assert loss == float(cross_entropy(logits[:, P:], b["labels"], b["mask"],
                                       logical_vocab=api.cfg.vocab))
    assert moved != loss


def test_vlm_decode_step_matches_reference(vlm):
    """The rotating-buffer decode under M-RoPE: the step's position is the
    t, h and w id at once (the reference's broadcast), so decode equals a
    text-only ``transformer.apply`` (positions 0..S-1 for each of t, h,
    w), not the patches-first ``api.apply`` (text at base + i)."""
    japi, jparams, api, params = vlm
    B, S = 2, 8
    toks = np.random.default_rng(4).integers(0, api.cfg.vocab, (B, S)) \
        .astype(np.int32)
    cache, jcache = api.init_cache(params, B, S), japi.init_cache(jparams,
                                                                  B, S)
    got, want = [], []
    for pos in range(S):
        lg, cache = api.decode_step(params, cache,
                                    torch.tensor(toks[:, pos:pos + 1]), pos)
        jl, jcache = japi.decode_step(jparams, jcache,
                                      jnp.asarray(toks[:, pos:pos + 1]), pos)
        got.append(lg.numpy())
        want.append(np.asarray(jl))
    got = np.concatenate(got, 1)
    _close(got, np.concatenate(want, 1), "decode")
    with torch.no_grad():
        full = transformer.apply(params, api.cfg, torch.tensor(toks))
    _close(got, _t(full), "decode against text-only apply")
    jfull = jtransformer.apply(jparams, japi.cfg, jnp.asarray(toks))
    _close(_t(full), jfull, "text-only apply")


def test_encdec_encode_and_cache_match_reference(audio):
    japi, jparams, api, params = audio
    cfg = api.cfg
    frames = 0.1 * np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        mem = encdec.encode(params, cfg, torch.tensor(frames))
    _close(mem.numpy(), jencdec.encode(jparams, japi.cfg,
                                       jnp.asarray(frames)), "memory")
    cache = api.init_cache(params, torch.tensor(frames), 8)
    jcache = japi.init_cache(jparams, jnp.asarray(frames), 8)
    for part in ("cross", "self"):
        assert sorted(cache[part]) == sorted(jcache[part])
        for name, x in cache[part].items():
            assert tuple(x.shape) == jcache[part][name].shape, name
            _close(x.numpy(), jcache[part][name], f"{part}/{name}")


def test_encdec_decode_matches_reference_and_teacher_forcing(audio):
    """``decode_step`` (self-attention through the rotating buffer,
    cross-attention to the cached K/V) against the reference's, and
    against the port's own teacher-forced ``apply`` (the reference's own
    property: decode reproduces the training forward)."""
    japi, jparams, api, params = audio
    cfg = api.cfg
    rng = np.random.default_rng(6)
    frames = (0.1 * rng.standard_normal((2, 16, cfg.d_model))).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    cache = api.init_cache(params, torch.tensor(frames), 8)
    jcache = japi.init_cache(jparams, jnp.asarray(frames), 8)
    got, want = [], []
    for t in range(8):
        lg, cache = api.decode_step(params, cache,
                                    torch.tensor(toks[:, t:t + 1]), t)
        jl, jcache = japi.decode_step(jparams, jcache,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        got.append(lg.numpy())
        want.append(np.asarray(jl))
    got = np.concatenate(got, 1)
    _close(got, np.concatenate(want, 1), "decode")
    with torch.no_grad():
        full = api.apply(params, {"frames": torch.tensor(frames),
                                  "tokens": torch.tensor(toks)})
    _close(got, _t(full), "decode against teacher forcing")


def test_audio_family_has_no_paged_serving(audio):
    from repro_torch.serve import ServeEngine
    _, _, api, params = audio
    assert not api.has_paged and api.paged_decode_step is None
    with pytest.raises(ValueError, match="no paged"):
        ServeEngine(api, params)


# -- bf16 --------------------------------------------------------------------------

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


def _excess(got, want):
    """|got - want| in units of the bf16 tier (at most 1 passes)."""
    tier = BF16_TIER * np.max(np.abs(want)) + BF16_TIER * np.abs(want)
    return float(np.max(np.abs(got - want) / tier))


@pytest.fixture(scope="module", params=[VLM, AUDIO])
def bf16_run(request):
    japi, jparams, api, params = _models(request.param, **BF16)
    b = _batch(api.cfg)
    vocab = api.cfg.vocab
    want = _np(japi.apply(jparams, _jax_batch(b, jnp.bfloat16)))[..., :vocab]
    with torch.no_grad():
        got = api.apply(params, _torch_batch(b, torch.bfloat16))
        with CoarseBF16():
            coarse = api.apply(params, _torch_batch(b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    return _t(got)[..., :vocab], _t(coarse)[..., :vocab], want


def test_bf16_apply_matches_reference(bf16_run):
    got, _, want = bf16_run
    assert _excess(got, want) <= 1.0


def test_bf16_tier_rejects_one_bit_less_precision(bf16_run):
    _, coarse, want = bf16_run
    assert _excess(coarse, want) > 1.0


# -- the trainer -----------------------------------------------------------------

def test_dpsgd_flat_step_matches_reference(models):
    """Two flat-engine DPSGD steps (4 learners, random_pair, sgd with
    momentum) on the reference's batches and partner tables: the store,
    the momentum and the metrics within 1e-4 (the trainer tests' tier for
    a model after 2 steps)."""
    japi, jparams, api, _ = models
    n = 4
    algo = dict(algo="dpsgd", topology="random_pair", n_learners=n)
    jtr = JaxTrainer(japi.loss_fn, jax_optim.sgd(0.1, momentum=0.9),
                     JaxAlgoConfig(**algo), engine="flat",
                     kernel_backend="ref")
    ptr = MultiLearnerTrainer(api.loss_fn, optim.sgd(0.1, momentum=0.9),
                              AlgoConfig(**algo),
                              params_from_tree=api.params_from_tree,
                              device="cpu")
    assert ptr.is_flat and ptr.is_fused
    jstate = jtr.init(jax.random.PRNGKey(0), jparams)
    pstate = ptr.init(0, tree_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jparams)))
    tol = dict(atol=1e-4, rtol=1e-4)
    for step in range(2):
        b = _batch(api.cfg, B=2, seq=24, seed=10 + step, n=n)
        key = jax.random.fold_in(jstate.rng, jstate.step)
        rounds = [(np.array(p), np.array(c)) for p, c in
                  jtr._schedule.step_rounds(jax.random.split(key)[0],
                                            int(jstate.step))]
        pstate, pm = ptr.train_step(pstate, _torch_batch(b), rounds)
        jstate, jm = jtr.train_step(jstate, _jax_batch(b))
        what = f"{api.cfg.name} step {step}"
        np.testing.assert_allclose(pstate.params.numpy(),
                                   np.asarray(jstate.params), **tol,
                                   err_msg=f"{what} params")
        np.testing.assert_allclose(pstate.opt_state["mu"].numpy(),
                                   np.asarray(jstate.opt_state["mu"]),
                                   **tol, err_msg=f"{what} momentum")
        for f in ("loss", "grad_norm", "sigma_w_sq"):
            np.testing.assert_allclose(float(getattr(pm, f)),
                                       float(getattr(jm, f)), rtol=1e-4,
                                       atol=1e-12, err_msg=f"{what} {f}")
