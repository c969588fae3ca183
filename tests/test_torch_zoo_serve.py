"""The port's moe, hybrid and ssm families against the JAX reference, on
the CPU: granite-moe-3b-a800m and qwen3-moe-235b-a22b (moe),
jamba-v0.1-52b (hybrid: 7 mamba + 1 attention layers, MoE every 2nd layer,
no RoPE) and xlstm-350m (ssm: mLSTM + sLSTM blocks, no attention), each at
its smoke config.

Both packages run the SAME weights: the reference's ``init_params`` draws
them and ``params_from_jax`` carries them across.  Tiers:

  * float32: logits within 1e-5 of the largest reference logit (absolute)
    and 1e-5 relative, the loss within 1e-5 relative — the two frameworks
    sum matrix products in other orders;
  * bf16 (parameters and compute): logits within 2e-2 of the largest
    reference logit, the loss within 1e-3 relative — the tier of
    tests/test_torch_dense_flash.py, the two frameworks rounding bf16 at
    other places.  The bf16 runs share the reference's routing (below).
    jamba's bf16 logits are held to 6e-2 in the Frobenius norm instead:
    eight random-weight layers (7 of them a recurrence over the sequence)
    carry bf16 rounding far, so that two sound runs of the reference
    itself, eager and under ``jax.jit``, lie 5.2e-2 apart, and the port
    2.9e-2 from the reference (7.7e-2 from its float32 run);
  * xlstm's bf16 logits are held to 3.5e-2 in the Frobenius norm: each
    layer divides by the mLSTM normalizer |q . n|, and the reference's
    own jitted and eager runs lie 1.28e-2 apart (tests/test_torch_xlstm.py
    measures the rest); the port lies 2.16e-2 from it, the control 4.67e-2;
  * each bf16 tier rejects the control: the port with every bf16 result
    rounded to one mantissa bit fewer (``CoarseBF16``), measured at 1.35
    x the 2e-2 tier (granite-moe, qwen3-moe) and 7.2e-2 Frobenius
    (jamba).  dt, the scan or the norms put in bf16 move jamba's logits
    to 2.75e-2 / 2.91e-2 / 3.33e-2 only, under what two sound runs
    differ by: tests/test_torch_mamba.py holds the scan's dtypes
    directly;
  * routing: a bf16 router input that differs by one rounding can send a
    token to another expert, a discrete jump and not an error within a
    tier (measured at this seed: 4 of jamba's 128 routed tokens, 1 of
    granite-moe's 64).  The bf16 runs therefore replay the reference's
    expert choices in the port (recorded by a debug callback on
    ``jax.lax.top_k``; the port's gates are its own probabilities at those
    experts) and report how many tokens the port would have sent
    elsewhere.  The float32 runs route on their own;
  * the port's paged decode against its own rotating-buffer decode:
    bitwise, as the reference holds its own two paths
    (tests/test_serve.py::test_paged_decode_bitwise_matches_rotating);
  * a slot with advance=False keeps every recurrent leaf bitwise, and
    ``reset_slot`` zeroes exactly the slot's recurrent leaves.

Capacity-factor routing makes a MoE token's output depend on the other
tokens of its batch, so the engines are compared on the same request
stream (the port's ``ServeEngine`` against the reference's), not against
isolated runs.
"""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.util import value_and_grad  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import PAGED, period_spec  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
         "xlstm-350m"]
PAGE, MAX_PAGES = 4, 4
BUF = PAGE * MAX_PAGES
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
HYBRID_BF16_RTOL = 6e-2
SSM_BF16_RTOL = 3.5e-2
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


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


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def jamba():
    return _models("jamba-v0.1-52b")


@pytest.fixture(scope="module")
def xlstm():
    return _models("xlstm-350m")


def _shuffled_table(n_slots, seed=0):
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, 1 + n_slots * MAX_PAGES))
    return pages.reshape(n_slots, MAX_PAGES).astype(np.int32)


def _batch(vocab, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "mask": mask}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- (a) prefill forward and loss ----------------------------------------------

def test_period_specs_match_reference():
    from repro.models import transformer as jt
    for arch in ARCHS:
        for cfg in (get_config(arch), get_config(arch).smoke_config()):
            assert period_spec(cfg) == jt.period_spec(
                jax_get_config(arch) if cfg.name == arch
                else jax_get_config(arch).smoke_config())
    spec = period_spec(get_config("jamba-v0.1-52b"))
    assert [m for m, _ in spec] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in spec] == ["dense", "moe"] * 4


def _share_reference_routing(monkeypatch):
    """Record the reference's top-k expert ids as it runs and replay them,
    call by call, in the port's ``moe.route``.  Returns the list of tokens
    per call that the port's own top-k would have routed otherwise."""
    recorded, flips = [], []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        vals, ids = top_k(x, k)
        jax.debug.callback(lambda a: recorded.append(np.array(a)), ids,
                           ordered=True)
        return vals, ids

    def replay(logits, k):
        jax.effects_barrier()
        probs = torch.softmax(logits, dim=-1)
        ids = torch.from_numpy(recorded.pop(0)).long()
        flips.append(int((torch.topk(probs, k, dim=-1)[1] != ids)
                         .any(-1).sum()))
        gates = probs.gather(1, ids)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True),
                                          min=1e-9), ids

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    monkeypatch.setattr(moe, "route", replay)
    return flips


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_excess(family, got, want):
    """How far ``got`` lies from ``want`` in units of the bf16 tier (at
    most 1 passes): jamba's Frobenius distance over HYBRID_BF16_RTOL,
    xlstm's over SSM_BF16_RTOL, the others' worst |got - want| over 2e-2
    (max |want| + |want|)."""
    if family == "hybrid":
        return _rel(got, want) / HYBRID_BF16_RTOL
    if family == "ssm":
        return _rel(got, want) / SSM_BF16_RTOL
    tol = TOL["bfloat16"]
    return float(np.max(np.abs(got - want)
                        / (tol * np.max(np.abs(want)) + tol * np.abs(want))))


class CoarseBF16(torch.overrides.TorchFunctionMode):
    """Rounds every new bf16 result to one mantissa bit fewer (7
    significant bits, nearest): the port one bit less precise than bf16
    throughout, the control each bf16 tier must reject.  Views and
    in-place results (storage shared with an argument) pass unchanged."""

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


def _apply_both(arch, monkeypatch, dtype, mode=None):
    """(port logits, reference logits, port loss, reference loss, tokens
    routed otherwise) on one batch; bf16 runs share the reference's
    routing; ``mode`` wraps the port's run."""
    bf16 = dtype == "bfloat16"
    japi, jparams, api, params = _models(arch, **(BF16 if bf16 else {}))
    vocab = api.cfg.vocab
    b = _batch(vocab)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    flips = _share_reference_routing(monkeypatch) if bf16 else []
    want = _f32(japi.apply(jparams, jb))[..., :vocab]
    jloss = float(japi.loss_fn(jparams, jb))
    with torch.no_grad(), (mode or contextlib.nullcontext()):
        got = api.apply(params, tb)
        loss = float(api.loss_fn(params, tb))
    assert got.dtype == getattr(torch, dtype)
    return got.float().numpy()[..., :vocab], want, loss, jloss, flips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_loss_match_reference(arch, dtype, monkeypatch):
    got, want, loss, jloss, flips = _apply_both(arch, monkeypatch, dtype)
    what = f"{arch} {dtype}, tokens routed otherwise: {flips}"
    if dtype == "bfloat16":
        family = get_config(arch).family
        assert _bf16_excess(family, got, want) <= 1.0, what
    else:
        scale = float(np.max(np.abs(want)))
        np.testing.assert_allclose(got, want, atol=TOL[dtype] * scale,
                                   rtol=TOL[dtype], err_msg=what)
    assert abs(loss - jloss) <= LOSS_RTOL[dtype] * abs(jloss), what


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tier_rejects_one_bit_less_precision(arch, monkeypatch):
    """The control: the port one mantissa bit below bf16 (measured 1.35 x
    the tier for the moe configs, 1.2 x for jamba) must miss the tier its
    sound run passes."""
    got, want, _, _, flips = _apply_both(arch, monkeypatch, "bfloat16",
                                         CoarseBF16())
    assert _bf16_excess(get_config(arch).family, got, want) > 1.0, (
        f"{arch}: one bit below bf16 passes the bf16 tier; tokens routed "
        f"otherwise: {flips}")


def test_gradients_match_reference(models):
    """The float32 loss gradient of every leaf, relative 1e-4 in norm (the
    router's through the renormalized gates; jamba's through the scan)."""
    japi, jparams, api, params = models
    b = _batch(api.cfg.vocab, seed=1)
    jg = _flat(jax.grad(japi.loss_fn)(jparams, {k: jnp.asarray(v)
                                                for k, v in b.items()}),
               np.asarray)
    _, g = value_and_grad(api.loss_fn, api.param_tree(params),
                          {k: torch.tensor(v) for k, v in b.items()},
                          api.params_from_tree)
    got = _flat(g, lambda t: t.numpy())
    assert sorted(got) == sorted(jg)
    for name, want in jg.items():
        rel = np.linalg.norm(got[name] - want) / max(np.linalg.norm(want),
                                                    1e-30)
        assert rel <= 1e-4, f"{name}: relative error {rel}"


def _flat(tree, fn, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, fn, f"{prefix}/{k}"))
        return out
    return {prefix: fn(tree)}


# -- (b) paged decode -----------------------------------------------------------

def _recurrent(cache, lib=np.asarray):
    """{"l{i}/leaf": array} of the non-paged (per-slot) cache leaves."""
    return {f"{layer}/{name}": lib(x) for layer, c in cache.items()
            for name, x in c.items() if name not in PAGED}


def test_paged_decode_step_matches_reference(models):
    japi, jparams, api, params = models
    vocab, B = api.cfg.vocab, 3
    table = _shuffled_table(B, seed=2)
    jcache = japi.init_paged_cache(jparams, B, 1 + B * MAX_PAGES, PAGE)
    cache = api.init_paged_cache(params, B, 1 + B * MAX_PAGES, PAGE)
    rng = np.random.default_rng(3)
    for step in range(8):                   # ragged: slot 0 six steps ahead
        toks = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        positions = np.array([step + 6, step + 3, step], np.int32)
        jl, jcache = japi.paged_decode_step(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(positions),
            jnp.asarray(table))
        tl, cache = api.paged_decode_step(
            params, cache, torch.tensor(toks), torch.tensor(positions),
            torch.tensor(table))
        np.testing.assert_allclose(tl.numpy()[..., :vocab],
                                   np.asarray(jl)[..., :vocab], atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {step}")
    want = _recurrent(jcache)
    got = _recurrent(cache, lambda t: t.numpy())
    assert sorted(got) == sorted(want)
    for k in want:
        # the mLSTM memory C sums outer products k v^T (|C| reaches ~21 at
        # this seed): xlstm's state is held, as logits are, to 1e-5 of its
        # largest value
        scale = (float(np.max(np.abs(want[k])))
                 if api.cfg.family == "ssm" else 1.0)
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale,
                                   rtol=1e-5, err_msg=k)


def test_paged_decode_bitwise_matches_rotating(models):
    """Six shared-position steps crossing a page boundary through a
    shuffled table: the paged step equals the rotating-buffer step
    bitwise, and the rotating step matches the reference's."""
    japi, jparams, api, params = models
    vocab, B = api.cfg.vocab, 3
    cache_r = api.init_cache(params, B, BUF)
    cache_p = api.init_paged_cache(params, B, 1 + B * MAX_PAGES, PAGE)
    jcache_r = japi.init_cache(jparams, B, BUF)
    table = torch.tensor(_shuffled_table(B))
    rng = np.random.default_rng(1)
    for pos in range(6):
        toks = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        lr_, cache_r = api.decode_step(params, cache_r, torch.tensor(toks),
                                       pos)
        lp_, cache_p = api.paged_decode_step(
            params, cache_p, torch.tensor(toks),
            torch.full((B,), pos, dtype=torch.int32), table)
        assert torch.equal(lr_[..., :vocab], lp_[..., :vocab]), f"pos={pos}"
        jl, jcache_r = japi.decode_step(jparams, jcache_r, jnp.asarray(toks),
                                        pos)
        np.testing.assert_allclose(lr_.numpy()[..., :vocab],
                                   np.asarray(jl)[..., :vocab], atol=1e-5,
                                   rtol=1e-5, err_msg=f"rotating pos={pos}")


def test_advance_mask_freezes_recurrent_state(jamba):
    """advance=False keeps every recurrent (mamba) leaf of its slot
    bitwise through fused steps; the advancing slot's leaves move and
    match the reference's masked run."""
    _advance_mask_check(jamba)


def test_xlstm_advance_mask_freezes_recurrent_state(xlstm):
    """The same for the mLSTM (C, conv, m, n) and sLSTM (c, h, m, n)
    leaves."""
    _advance_mask_check(xlstm)


def _advance_mask_check(models):
    japi, jparams, api, params = models
    vocab, B = api.cfg.vocab, 2
    table = _shuffled_table(B)
    cache = api.init_paged_cache(params, B, 1 + B * MAX_PAGES, PAGE)
    jcache = japi.init_paged_cache(jparams, B, 1 + B * MAX_PAGES, PAGE)
    before = _recurrent(cache, lambda t: t.clone())
    assert before, "no recurrent leaves"
    rng = np.random.default_rng(4)
    mask = np.array([True, False])
    for pos in range(3):
        toks = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        positions = np.full((B,), pos, np.int32)
        _, cache = api.paged_decode_step(
            params, cache, torch.tensor(toks), torch.tensor(positions),
            torch.tensor(table), torch.tensor(mask))
        _, jcache = japi.paged_decode_step(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(positions),
            jnp.asarray(table), jnp.asarray(mask))
    after = _recurrent(cache, lambda t: t.clone())
    want = _recurrent(jcache)
    moved = 0
    for k in before:                       # leaves are (periods, slot, ...)
        assert torch.equal(after[k][:, 1], before[k][:, 1]), k
        moved += int(not torch.equal(after[k][:, 0], before[k][:, 0]))
        np.testing.assert_allclose(after[k].numpy(), want[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert moved == len(before)


def test_reset_slot_zeroes_the_slot_recurrent_leaves(jamba):
    _reset_slot_check(jamba)


def test_xlstm_reset_slot_zeroes_the_slot_recurrent_leaves(xlstm):
    _reset_slot_check(xlstm)


def _reset_slot_check(models):
    _, _, api, params = models
    vocab, B = api.cfg.vocab, 3
    table = torch.tensor(_shuffled_table(B))
    cache = api.init_paged_cache(params, B, 1 + B * MAX_PAGES, PAGE)
    rng = np.random.default_rng(6)
    for pos in range(4):
        toks = torch.tensor(rng.integers(0, vocab, (B, 1)).astype(np.int32))
        _, cache = api.paged_decode_step(
            params, cache, toks, torch.full((B,), pos, dtype=torch.int32),
            table)
    before = {f"{l}/{n}": x.clone() for l, c in cache.items()
              for n, x in c.items()}
    out = api.reset_slot(cache, 1)
    assert out is cache
    for l, c in cache.items():
        for n, x in c.items():
            k = f"{l}/{n}"
            if n in PAGED:
                assert torch.equal(x, before[k]), k
                continue
            assert before[k][:, 1].abs().sum() > 0, k
            assert (x[:, 1] == 0).all(), k
            assert torch.equal(x[:, 0], before[k][:, 0]), k
            assert torch.equal(x[:, 2], before[k][:, 2]), k


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_reset_slot_is_a_no_op_without_recurrent_state(arch):
    cfg = get_config(arch).smoke_config()
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    cache = api.init_paged_cache(params, 2, 9, PAGE)
    assert all(set(c) == set(PAGED) for c in cache.values())
    for c in cache.values():
        for x in c.values():
            x.fill_(1.0)
    api.reset_slot(cache, 0)
    assert all((x == 1).all() for c in cache.values() for x in c.values())


# -- (c) the engines generate the same tokens -----------------------------------

def _jobs(vocab, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, n).tolist(), m)
            for n, m in ((3, 5), (7, 3), (1, 6), (5, 4), (2, 5))]


def test_engine_generates_the_reference_tokens(models):
    japi, jparams, api, params = models
    jobs = _jobs(api.cfg.vocab, 0)
    jeng = JaxServeEngine(japi, jparams, n_slots=2, page_size=PAGE,
                          max_len=BUF)
    jreqs = [jeng.submit(p, m) for p, m in jobs]
    jeng.run()
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    eng.warmup()
    reqs = [eng.submit(p, m) for p, m in jobs]
    eng.run()
    assert [list(r.generated) for r in reqs] == [list(r.generated)
                                                 for r in jreqs]
    assert eng.real_steps == jeng.real_steps
    assert eng.alloc.free_pages == eng.n_pages - 1
    # eviction reset every recycled slot's recurrent state
    for k, x in _recurrent(eng.cache, lambda t: t).items():
        assert (x == 0).all(), k


def test_engine_stall_keeps_recurrent_state_frozen(jamba):
    """A pool too small for both slots stalls one mid-flight (advance
    False): the port's engine generates the reference engine's tokens."""
    japi, jparams, api, params = jamba
    rng = np.random.default_rng(1)
    p0, p1 = (rng.integers(1, api.cfg.vocab, n).tolist() for n in (3, 7))
    out = []
    for Eng, a, p in ((JaxServeEngine, japi, jparams),
                      (ServeEngine, api, params)):
        eng = Eng(a, p, n_slots=2, page_size=PAGE, max_len=BUF, n_pages=4)
        r0, r1 = eng.submit(p0, 5), eng.submit(p1, 3)
        eng.run()
        assert eng.stall_events > 0
        out.append([list(r0.generated), list(r1.generated)])
    assert out[0] == out[1]


# -- xlstm behind the engine (tests/test_serve.py's ssm cases) ------------------

def _isolated(api, params, prompt, max_new):
    eng = ServeEngine(api, params, n_slots=1, page_size=PAGE, max_len=BUF)
    r = eng.submit(prompt, max_new)
    eng.run()
    return list(r.generated)


def test_xlstm_engine_midflight_join_matches_isolated(xlstm):
    """Five requests on two slots join a running batch and recycle slots:
    each decodes exactly the tokens it gets alone, and the reference's
    engine's."""
    japi, jparams, api, params = xlstm
    jobs = _jobs(api.cfg.vocab, 0)
    expect = [_isolated(api, params, p, m) for p, m in jobs]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    eng.warmup()
    reqs = [eng.submit(p, m) for p, m in jobs]
    eng.run()
    assert [list(r.generated) for r in reqs] == expect
    assert eng.alloc.free_pages == eng.n_pages - 1
    assert all(s.state == "free" for s in eng.slots)
    jeng = JaxServeEngine(japi, jparams, n_slots=2, page_size=PAGE,
                          max_len=BUF)
    jreqs = [jeng.submit(p, m) for p, m in jobs]
    jeng.run()
    assert [list(r.generated) for r in jreqs] == expect


def test_xlstm_engine_stall_on_page_exhaustion_recovers(xlstm):
    """A pool too small for both slots stalls one mid-flight; its mLSTM /
    sLSTM state stays frozen while it waits, so both requests still decode
    their isolated tokens (the reference's engine's too)."""
    japi, jparams, api, params = xlstm
    rng = np.random.default_rng(1)
    p0, p1 = (rng.integers(1, api.cfg.vocab, n).tolist() for n in (3, 7))
    expect = [_isolated(api, params, p0, 5), _isolated(api, params, p1, 3)]
    for Eng, a, p in ((ServeEngine, api, params),
                      (JaxServeEngine, japi, jparams)):
        eng = Eng(a, p, n_slots=2, page_size=PAGE, max_len=BUF, n_pages=4)
        r0, r1 = eng.submit(p0, 5), eng.submit(p1, 3)
        eng.run()
        assert eng.stall_events > 0
        assert [list(r0.generated), list(r1.generated)] == expect


def test_xlstm_engine_idle_slot_then_late_join(xlstm):
    """A FREE slot idling beside a running one accumulates no recurrent
    state: a request admitted into it later decodes exactly its isolated
    tokens (the reference's regression for the unmasked paged step)."""
    _, _, api, params = xlstm
    rng = np.random.default_rng(7)
    pa, pb, pc = (rng.integers(1, api.cfg.vocab, n).tolist()
                  for n in (4, 2, 3))
    expect = [_isolated(api, params, p, m)
              for p, m in ((pa, 8), (pb, 2), (pc, 4))]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    eng.warmup()
    ra, rb = eng.submit(pa, 8), eng.submit(pb, 2)
    while not rb.done:
        eng.step()
    for _ in range(3):
        eng.step()
    rc = eng.submit(pc, 4)
    eng.run()
    assert [list(r.generated) for r in (ra, rb, rc)] == expect
