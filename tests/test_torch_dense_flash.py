"""The ``use_pallas`` flash-attention route through the port's dense model,
against the JAX reference run the same way.

gemma2-27b's smoke config (2 layers: one local/global period, window 64,
attention and final softcaps 50 / 30, tied embeddings) with ``use_pallas``
at S = 128, so the window binds, in three variants: float32; bfloat16
parameters and compute; GQA with 2 kv heads.  The reference's parameters
go to the port through ``params_from_jax``; the same tokens and labels go
through the reference's ``apply`` / ``loss_fn`` / ``jax.grad`` (its flash
kernel in interpret mode, its custom VJP) and the port's (the plain
version with autograd, on the CPU).

Tolerances:
  * float32: logits and every gradient leaf within 1e-5 of the largest
    reference magnitude in that tensor, the loss within 1e-5 relative
    (measured: 7.7e-7, 2.3e-6 and 1.5e-7 relative) — the same float32
    algebra, summed in other orders;
  * bfloat16: logits within 2e-2 of the largest reference logit (measured
    9.4e-3: about one bfloat16 ulp at 2.5), the loss within 1e-3
    relative (measured 4.0e-5), every gradient leaf within 2e-2 relative
    in the Frobenius norm (measured at most 1.7e-2).  The two frameworks
    round at other places in bfloat16: JAX's ``silu`` rounds
    ``exp``, ``1 + .``, ``1 / .`` and the product one by one where PyTorch
    rounds once, and each side's autodiff rounds its own backward ops
    (the softcap's alone moves the logits' cotangent by 3e-3).

Then one DPSGD step of ``MultiLearnerTrainer`` on transformer-100m's
smoke config with ``use_pallas`` equals the same step with the chunked
route within 1e-6 (the same algebra; only the attention's blocking
differs).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

SEQ, BATCH = 128, 2
VARIANTS = {
    "float32": dict(use_pallas=True),
    "bfloat16": dict(use_pallas=True, param_dtype="bfloat16",
                     compute_dtype="bfloat16"),
    "gqa": dict(use_pallas=True, n_kv_heads=2),
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "gqa": 1e-5}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3, "gqa": 1e-5}


@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request):
    """Both packages' logits, loss and gradients for one variant."""
    name = request.param
    kw = VARIANTS[name]
    jcfg = dataclasses.replace(jax_get_config("gemma2-27b").smoke_config(),
                               **kw)
    cfg = dataclasses.replace(get_config("gemma2-27b").smoke_config(), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jlogits = japi.apply(jparams, jbatch)
    jloss, jgrads = jax.value_and_grad(japi.loss_fn)(jparams, jbatch)

    api = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    batch = {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)}
    with torch.no_grad():
        logits = api.apply(params, batch)
    loss = api.loss_fn(params, batch)
    loss.backward()
    return dict(name=name, cfg=cfg, jlogits=jlogits, jloss=jloss,
                jgrads=jgrads, logits=logits, loss=loss, params=params)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _grad_pairs(run):
    """(name, port gradient, reference gradient) for every leaf, the
    period axis unstacked."""
    params = run["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(run["jgrads"])[0]:
        keys = [p.key for p in path]
        if keys[0] != "periods":
            yield keys[0], getattr(params, keys[0]).grad, leaf
            continue
        for p in range(leaf.shape[0]):
            obj = params.periods[p][keys[1]]
            for k in keys[2:]:
                obj = getattr(obj, k)
            yield ".".join(keys + [str(p)]), obj.grad, leaf[p]


def test_apply_logits_match_reference(run):
    got, want = _f32(run["logits"]), _f32(run["jlogits"])
    assert run["logits"].dtype == getattr(torch, run["cfg"].compute_dtype)
    assert got.shape == want.shape == (BATCH, SEQ, run["cfg"].padded_vocab)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=TOL[run["name"]] * scale,
                               rtol=0)


def test_loss_matches_reference(run):
    got, want = run["loss"].item(), float(run["jloss"])
    assert np.isfinite(got)
    assert abs(got - want) <= LOSS_RTOL[run["name"]] * abs(want)


def test_gradients_match_reference(run):
    tol = TOL[run["name"]]
    seen = 0
    for name, got, want in _grad_pairs(run):
        got, want = _f32(got), _f32(want)
        assert np.isfinite(got).all(), name
        if run["name"] == "bfloat16":
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= tol, f"{name}: relative error {rel}"
        else:
            np.testing.assert_allclose(got, want,
                                       atol=tol * np.abs(want).max(),
                                       rtol=0, err_msg=name)
        seen += 1
    assert seen == 2 * 9 + 2          # 2 layers x 9 leaves, embed, norm


def test_dpsgd_step_with_flash_route_equals_chunked_route():
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    from repro_torch.optim import sgd
    base = get_config("transformer-100m").smoke_config()
    loader = ShardedLoader(SyntheticTokenStream(vocab=base.vocab),
                           n_learners=4, local_batch=2, extra_args=(64,),
                           seed=0, device="cpu")
    batch = loader.batch(0)
    tree = build_model(base, device="cpu").param_tree(
        build_model(base, device="cpu").init(0))
    out = {}
    for use_pallas in (False, True):
        cfg = dataclasses.replace(base, use_pallas=use_pallas)
        api = build_model(cfg, device="cpu")
        tr = MultiLearnerTrainer(api.loss_fn, sgd(0.5, momentum=0.9),
                                 AlgoConfig(algo="dpsgd",
                                            topology="random_pair",
                                            n_learners=4),
                                 params_from_tree=api.params_from_tree,
                                 device="cpu")
        state, m = tr.train_step(tr.init(0, tree), batch)
        out[use_pallas] = (state.params.clone(), float(m.loss))
    (p0, l0), (p1, l1) = out[False], out[True]
    assert np.isfinite(l1) and abs(l1 - l0) <= 1e-6 * abs(l0)
    torch.testing.assert_close(p1, p0, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_cuda_float32_flash_training_step_at_a_ragged_length():
    """S 100 (no multiple of the float32 kernel's 64-row tile), float32,
    ``use_pallas``: one DPSGD step through the flash and gossip kernels on
    the card equals the step through the plain versions (the chunked
    route, ``kernel_backend="ref"``) within 1e-5, with one flash forward
    and one backward launch per layer and learner."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.optim import sgd
    # the chunked route's block must divide the length: 2 x 50
    base = dataclasses.replace(
        get_config("transformer-100m").smoke_config(), attn_chunk=50)
    loader = ShardedLoader(SyntheticTokenStream(vocab=base.vocab),
                           n_learners=4, local_batch=2, extra_args=(100,),
                           seed=0, device="cuda")
    batch = loader.batch(0)
    tree = build_model(base).param_tree(build_model(base).init(0))
    out = {}
    for use_pallas, backend in ((True, "auto"), (False, "ref")):
        api = build_model(dataclasses.replace(base, use_pallas=use_pallas))
        tr = MultiLearnerTrainer(api.loss_fn, sgd(0.5, momentum=0.9),
                                 AlgoConfig(algo="dpsgd",
                                            topology="random_pair",
                                            n_learners=4),
                                 params_from_tree=api.params_from_tree,
                                 kernel_backend=backend)
        before = (flash_attention_fwd.launches,
                  flash_attention_bwd.launches)
        state, m = tr.train_step(tr.init(0, tree), batch)
        torch.cuda.synchronize()
        out[use_pallas] = (state.params.clone(), float(m.loss),
                           (flash_attention_fwd.launches - before[0],
                            flash_attention_bwd.launches - before[1]))
    (p0, l0, n0), (p1, l1, n1) = out[False], out[True]
    assert (n0, n1) == ((0, 0), (4 * base.n_layers, 4 * base.n_layers))
    assert np.isfinite(l1) and abs(l1 - l0) <= 1e-5 * abs(l0)
    torch.testing.assert_close(p1, p0, atol=1e-5, rtol=0)
