"""The port's serving path against the JAX reference, on the CPU.

Both packages run ``transformer-100m``'s smoke config with the SAME
weights: the reference's ``init_params`` draws them and
``repro_torch.models.convert.params_from_jax`` carries them across.  The
port must match the reference's ``paged_decode_step`` logits (float32,
atol/rtol 1e-5: the two frameworks sum matrix products in different
orders) and its ``ServeEngine`` must generate the same tokens; the
engine's scheduling behaviour mirrors tests/test_serve.py.

gemma2-27b's smoke config in bf16 (parameters, compute and the paged K/V
pools; local/global layers with a window of 3 so the local mask bites,
softcaps 50 / 30) goes through both packages' ``paged_decode_step`` on the
same weights: logits within 2e-2 of the largest reference logit, the
tier of tests/test_torch_dense_flash.py (the two frameworks round bf16 at
other places).  The port's ``ServeEngine`` serves it end to end.
"""
import copy
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
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import OutOfPages, PageAllocator, \
    ServeEngine  # noqa: E402

PAGE, MAX_PAGES = 4, 4
BUF = PAGE * MAX_PAGES
TOL = dict(atol=1e-5, rtol=1e-5)
ENGINE_SEED = 0       # 6 requests whose every sampled step has a clear top-1


# gemma2-style attention on the same dense model: alternating sliding-
# window (3 tokens, so the mask bites within 6 steps) and global layers,
# attention-logit and final softcaps
LOCAL_GLOBAL = dict(attn_pattern="local_global", window=3,
                    attn_softcap=50.0, final_softcap=30.0)


def _models(**overrides):
    jcfg = dataclasses.replace(
        jax_get_config("transformer-100m").smoke_config(), **overrides)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(
        get_config("transformer-100m").smoke_config(), **overrides)
    api = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def models():
    return _models()


def _shuffled_table(n_slots, seed=0):
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, 1 + n_slots * MAX_PAGES))
    return pages.reshape(n_slots, MAX_PAGES).astype(np.int32)


def _steps_both(models, B, feeds, table):
    """Run the same (tokens, positions) feeds through both packages'
    paged_decode_step; yields (jax logits, port logits) per step."""
    japi, jparams, api, params = models
    jcache = japi.init_paged_cache(jparams, B, 1 + B * MAX_PAGES, PAGE)
    cache = api.init_paged_cache(params, B, 1 + B * MAX_PAGES, PAGE)
    for toks, positions in feeds:
        jl, jcache = japi.paged_decode_step(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(positions),
            jnp.asarray(table))
        tl, cache = api.paged_decode_step(
            params, cache, torch.tensor(toks), torch.tensor(positions),
            torch.tensor(table))
        yield np.asarray(jl), tl.numpy(), jcache, cache


# -- (a) shared positions through a shuffled table ----------------------------

@pytest.mark.parametrize("overrides", [{}, LOCAL_GLOBAL],
                         ids=["global", "local_global_softcap"])
def test_paged_decode_step_matches_reference(overrides):
    models = _models(**overrides)
    vocab = models[2].cfg.vocab
    B = 3
    rng = np.random.default_rng(1)
    feeds = [(rng.integers(0, vocab, (B, 1)).astype(np.int32),
              np.full((B,), pos, np.int32)) for pos in range(6)]
    for pos, (jl, tl, jcache, cache) in enumerate(
            _steps_both(models, B, feeds, _shuffled_table(B))):
        np.testing.assert_allclose(tl[..., :vocab], jl[..., :vocab],
                                   err_msg=f"pos={pos}", **TOL)
    # the in-place pools hold what the reference's donated cache holds
    for layer in cache:
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(cache[layer][name].numpy(),
                                       np.asarray(jcache[layer][name]),
                                       **TOL)


# -- (b) ragged positions in one step -----------------------------------------

def test_ragged_positions_match_reference_and_solo_runs(models):
    api, params = models[2], models[3]
    vocab = api.cfg.vocab
    rng = np.random.default_rng(3)
    streams = [rng.integers(0, vocab, n).astype(np.int32) for n in (6, 3, 1)]

    solo = []
    for s in streams:
        cache = api.init_paged_cache(params, 1, 1 + MAX_PAGES, PAGE)
        table = torch.arange(1, 1 + MAX_PAGES, dtype=torch.int32)[None]
        for pos in range(s.shape[0]):
            lg, cache = api.paged_decode_step(
                params, cache, torch.tensor(s[pos]).reshape(1, 1),
                torch.tensor([pos], dtype=torch.int32), table)
        solo.append(lg[0, 0, :vocab].numpy())

    B = len(streams)
    maxlen = max(s.shape[0] for s in streams)
    feeds, live_at = [], []
    for step in range(maxlen):            # slot i starts late: ragged
        toks = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        live = []
        for i, s in enumerate(streams):
            off = step - (maxlen - s.shape[0])
            if 0 <= off < s.shape[0]:
                toks[i, 0], positions[i] = s[off], off
                live.append(i)
        feeds.append((toks, positions))
        live_at.append(live)
    for step, (jl, tl, _, _) in enumerate(
            _steps_both(models, B, feeds, _shuffled_table(B, seed=5))):
        for i in live_at[step]:
            np.testing.assert_allclose(tl[i, 0, :vocab], jl[i, 0, :vocab],
                                       err_msg=f"step {step} slot {i}",
                                       **TOL)
            if feeds[step][1][i] == streams[i].shape[0] - 1:
                np.testing.assert_allclose(tl[i, 0, :vocab], solo[i],
                                           err_msg=f"slot {i} vs solo",
                                           **TOL)


# -- (c) the engines generate the same tokens ----------------------------------

def _jobs(vocab, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, n).tolist(), m)
            for n, m in ((3, 5), (7, 3), (1, 6), (5, 4), (2, 5), (9, 7))]


def _jax_top_gaps(models, prompt, generated):
    """Top-1 minus top-2 logit of the reference at each sampled step of a
    request, replayed alone (dense models are batch-independent)."""
    japi, jparams = models[0], models[1]
    vocab = japi.cfg.vocab
    step = jax.jit(japi.paged_decode_step)
    cache = japi.init_paged_cache(jparams, 1, 1 + MAX_PAGES, PAGE)
    table = jnp.arange(1, 1 + MAX_PAGES, dtype=jnp.int32)[None]
    feed = prompt + generated[:-1]
    gaps = []
    for pos, tok in enumerate(feed):
        lg, cache = step(jparams, cache, jnp.full((1, 1), tok, jnp.int32),
                         jnp.full((1,), pos, jnp.int32), table)
        if pos >= len(prompt) - 1:
            top2 = np.sort(np.asarray(lg[0, 0, :vocab]))[-2:]
            gaps.append(float(top2[1] - top2[0]))
    return gaps


def test_engine_generates_the_reference_tokens(models):
    japi, jparams, api, params = models
    jobs = _jobs(api.cfg.vocab, ENGINE_SEED)
    jeng = JaxServeEngine(japi, jparams, n_slots=2, page_size=PAGE,
                          max_len=BUF)
    jreqs = [jeng.submit(p, m) for p, m in jobs]
    jeng.run()
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    eng.warmup()
    reqs = [eng.submit(p, m) for p, m in jobs]
    eng.run()
    want = [list(r.generated) for r in jreqs]
    assert [list(r.generated) for r in reqs] == want
    assert eng.real_steps == jeng.real_steps
    for (prompt, _), gen in zip(jobs, want):
        gaps = _jax_top_gaps(models, prompt, gen)
        assert len(gaps) == len(gen) and min(gaps) > 1e-3, gaps


# -- (d) engine behaviour ------------------------------------------------------

def _isolated(api, params, prompt, max_new):
    e = ServeEngine(api, params, n_slots=1, page_size=PAGE, max_len=BUF)
    r = e.submit(prompt, max_new)
    e.run()
    return list(r.generated)


def test_page_allocator_never_hands_out_scratch():
    a = PageAllocator(5)
    assert sorted(a.alloc() for _ in range(4)) == [1, 2, 3, 4]
    with pytest.raises(OutOfPages):
        a.alloc()
    a.free([2, 4])
    assert a.free_pages == 2 and a.alloc() in (2, 4)
    with pytest.raises(ValueError):
        a.free([0])


def test_warmup_writes_only_the_scratch_page(models):
    api, params = models[2], models[3]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    eng.warmup()
    for layer in eng.cache.values():
        for pool in layer.values():
            assert pool[:, 1:].abs().sum() == 0
            assert pool[:, 0].abs().sum() > 0


def test_engine_midflight_join_matches_isolated(models):
    api, params = models[2], models[3]
    jobs = _jobs(api.cfg.vocab, 0)[:5]
    expect = [_isolated(api, params, p, m) for p, m in jobs]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    reqs = [eng.submit(p, m) for p, m in jobs]
    eng.run()
    assert [list(r.generated) for r in reqs] == expect
    assert eng.alloc.free_pages == eng.n_pages - 1
    assert all(s.state == "free" for s in eng.slots)


def test_engine_stall_on_page_exhaustion_recovers(models):
    api, params = models[2], models[3]
    rng = np.random.default_rng(1)
    p0, p1 = (rng.integers(1, api.cfg.vocab, n).tolist() for n in (3, 7))
    expect = [_isolated(api, params, p0, 5), _isolated(api, params, p1, 3)]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF,
                      n_pages=4)   # 3 real pages < 2 + 3 needed at once
    r0, r1 = eng.submit(p0, 5), eng.submit(p1, 3)
    eng.run()
    assert eng.stall_events > 0
    assert [list(r0.generated), list(r1.generated)] == expect


def test_engine_all_slots_stalled_raises_out_of_pages(models):
    api, params = models[2], models[3]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF,
                      n_pages=2)            # one real page for two slots
    eng.submit([1, 2], 6)                   # each needs 2 pages to finish
    eng.submit([3, 4], 6)
    with pytest.raises(OutOfPages, match="deadlock"):
        eng.run()


def test_engine_static_admission_blocks_head_of_line(models):
    api, params = models[2], models[3]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF,
                      admission="static")
    short = eng.submit([5], 2)
    long = eng.submit([5, 6, 7], 6)
    late = eng.submit([9], 2)
    eng.run()
    assert all(r.done for r in (short, long, late))
    assert late.first_token_step > long.finish_step - 1


def test_engine_eos_evicts_early(models):
    api, params = models[2], models[3]
    prompt = [3, 1, 4]
    full = _isolated(api, params, prompt, 6)
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    r = eng.submit(prompt, 6, eos_id=full[1])
    eng.run()
    assert r.generated == full[:2] and r.done
    assert eng.alloc.free_pages == eng.n_pages - 1


def test_engine_rejects_bad_requests_and_params(models):
    api, params = models[2], models[3]
    eng = ServeEngine(api, params, n_slots=1, page_size=PAGE, max_len=BUF)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(1, BUF)), 2)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], 2)
    with pytest.raises(ValueError, match="admission"):
        ServeEngine(api, params, admission="fifo")
    eng.set_params(params)                  # hot swap: same device is fine
    with pytest.raises(ValueError, match="engine on"):
        eng.set_params(copy.deepcopy(params).to("meta"))


# -- (e) gemma2-27b in bf16: paged decode on bf16 pools -----------------------

GEMMA_BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", window=3)
GEMMA_BF16_TOL = 2e-2            # of the largest reference logit


@pytest.fixture(scope="module")
def gemma_bf16():
    jcfg = dataclasses.replace(
        jax_get_config("gemma2-27b").smoke_config(), **GEMMA_BF16)
    cfg = dataclasses.replace(get_config("gemma2-27b").smoke_config(),
                              **GEMMA_BF16)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    return japi, jparams, api, params


def test_gemma2_bf16_paged_decode_step_matches_reference(gemma_bf16):
    japi, jparams, api, params = gemma_bf16
    vocab, B = api.cfg.vocab, 3
    table = _shuffled_table(B, seed=2)
    jcache = japi.init_paged_cache(jparams, B, 1 + B * MAX_PAGES, PAGE)
    cache = api.init_paged_cache(params, B, 1 + B * MAX_PAGES, PAGE)
    assert all(pool.dtype == torch.bfloat16 for layer in cache.values()
               for pool in layer.values())
    rng = np.random.default_rng(3)
    # ragged positions: slot 0 six steps ahead of slot 2
    for step in range(8):
        toks = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        positions = np.array([step + 6, step + 3, step], np.int32)
        jl, jcache = japi.paged_decode_step(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(positions),
            jnp.asarray(table))
        tl, cache = api.paged_decode_step(
            params, cache, torch.tensor(toks), torch.tensor(positions),
            torch.tensor(table))
        assert tl.dtype == torch.bfloat16
        jl = np.asarray(jl.astype(jnp.float32))[..., :vocab]
        tl = tl.float().numpy()[..., :vocab]
        assert np.isfinite(tl).all()
        err = float(np.max(np.abs(tl - jl)))
        assert err <= GEMMA_BF16_TOL * float(np.max(np.abs(jl))), \
            f"step {step}: max |port - reference| {err}"


def test_gemma2_bf16_engine_serves_end_to_end(gemma_bf16):
    api, params = gemma_bf16[2], gemma_bf16[3]
    jobs = _jobs(api.cfg.vocab, 1)[:4]
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    eng.warmup()
    reqs = [eng.submit(p, m) for p, m in jobs]
    eng.run()
    for r, (_, m) in zip(reqs, jobs):
        assert r.done and len(r.generated) == m
        assert all(0 <= t < api.cfg.vocab for t in r.generated)
    assert eng.alloc.free_pages == eng.n_pages - 1


# -- (f) MQA with many query heads per kv head ---------------------------------

# 24 query heads on one kv head (G = 24, as granite-20b's G = 48 is): the
# decode kernel holds every query head of a kv head in one block
MQA_WIDE = dict(n_heads=24, n_kv_heads=1, head_dim=16)


@pytest.fixture(scope="module")
def mqa_models():
    return _models(**MQA_WIDE)


def test_mqa_wide_group_paged_decode_step_matches_reference(mqa_models):
    vocab, B = mqa_models[2].cfg.vocab, 3
    assert mqa_models[2].cfg.q_per_kv == 24
    rng = np.random.default_rng(5)
    feeds = [(rng.integers(0, vocab, (B, 1)).astype(np.int32),
              np.array([pos + 5, pos + 2, pos], np.int32))
             for pos in range(6)]
    for pos, (jl, tl, _, _) in enumerate(
            _steps_both(mqa_models, B, feeds, _shuffled_table(B, seed=4))):
        np.testing.assert_allclose(tl[..., :vocab], jl[..., :vocab],
                                   err_msg=f"step={pos}", **TOL)


def test_mqa_wide_group_engine_generates_the_reference_tokens(mqa_models):
    japi, jparams, api, params = mqa_models
    jobs = _jobs(api.cfg.vocab, ENGINE_SEED)[:4]
    jeng = JaxServeEngine(japi, jparams, n_slots=2, page_size=PAGE,
                          max_len=BUF)
    jreqs = [jeng.submit(p, m) for p, m in jobs]
    jeng.run()
    eng = ServeEngine(api, params, n_slots=2, page_size=PAGE, max_len=BUF)
    eng.warmup()
    reqs = [eng.submit(p, m) for p, m in jobs]
    eng.run()
    want = [list(r.generated) for r in jreqs]
    assert [list(r.generated) for r in reqs] == want
    for (prompt, _), gen in zip(jobs, want):
        gaps = _jax_top_gaps(mqa_models, prompt, gen)
        assert min(gaps) > 1e-3, gaps
