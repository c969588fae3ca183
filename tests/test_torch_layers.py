"""The port's model building blocks against the JAX reference on the same
numpy inputs (float32, CPU)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ATOL = 1e-6


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("transformer-100m").smoke_config()
    jcfg = jax_get_config("transformer-100m").smoke_config()
    jparams = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    return cfg, jcfg, jparams


def _jax_leaves(jparams):
    """{dotted port name: array} for the reference tree, with the period
    axis unstacked into ``periods.<p>.``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [p.key for p in path]
        if keys[0] == "periods":
            for p in range(leaf.shape[0]):
                out[".".join(["periods", str(p)] + keys[1:])] = leaf[p]
        else:
            out[".".join(keys)] = leaf
    return out


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 256), dtype=np.float32) * 3
    scale = rng.standard_normal((256,), dtype=np.float32) * 0.1
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = tl.rms_norm(torch.tensor(x), torch.tensor(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,positions", [
    ((5, 1, 4, 64), np.array([[0], [3], [17], [40], [63]])),   # decode
    ((2, 8, 4, 64), np.arange(8)),                             # prefill
])
def test_apply_rope_matches_reference(shape, positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape, dtype=np.float32)
    pos = positions.astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = tl.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rope_is_half_split_rotation():
    """Lane i pairs with lane i + hd/2 (not 2i with 2i+1)."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = tl.apply_rope(x, torch.tensor([1]), 1e4)[0, 0, 0]
    assert out[0] == pytest.approx(np.cos(1.0), abs=1e-6)
    assert out[4] == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[1] == 0 and out[5] == 0


def test_softcap_matches_reference():
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    want = np.asarray(jl.softcap(jnp.asarray(x), 30.0))
    np.testing.assert_allclose(tl.softcap(torch.tensor(x), 30.0).numpy(),
                               want, atol=ATOL * 30)
    t = torch.tensor(x)
    assert tl.softcap(t, 0.0) is t          # cap 0 disables it


def test_embed_tokens_and_logits_match_reference(smoke):
    cfg, jcfg, jparams = smoke
    params = params_from_jax(jparams, cfg, "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (6, 1))
    tokens = tokens.astype(np.int32)
    want = np.asarray(jt.embed_tokens(jparams, jcfg, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = tt.embed_tokens(params, cfg, torch.tensor(tokens))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        h = np.random.default_rng(3).standard_normal(
            (6, 1, cfg.d_model), dtype=np.float32)
        want = np.asarray(jt.logits_from_hidden(jparams, jcfg,
                                                jnp.asarray(h)))
        got = tt.logits_from_hidden(params, cfg, torch.tensor(h))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_init_params_shapes_and_dtypes_match_reference(smoke):
    cfg, _, jparams = smoke
    gen = torch.Generator().manual_seed(0)
    port = dict(tt.init_params(cfg, gen).named_parameters())
    ref = _jax_leaves(jparams)
    assert sorted(port) == sorted(ref)
    for name, a in ref.items():
        assert tuple(port[name].shape) == a.shape, name
        assert str(port[name].dtype) == f"torch.{a.dtype}", name


def test_params_from_jax_carries_every_leaf_exactly(smoke):
    cfg, _, jparams = smoke
    port = dict(params_from_jax(jparams, cfg, "cpu").named_parameters())
    for name, a in _jax_leaves(jparams).items():
        np.testing.assert_array_equal(port[name].detach().numpy(), a,
                                      err_msg=name)


def test_init_draws_follow_the_reference_distributions():
    """The port's draws come from torch.Generator, not jax.random: check
    them by property (seeded, so deterministic)."""
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 512, 1024, torch.float32)
    assert abs(float(w.mean())) < 1e-3
    assert float(w.std()) == pytest.approx(512 ** -0.5, rel=0.02)
    e = tl.embed_init(gen, 4096, 64, torch.float32)
    assert float(e.std()) == pytest.approx(0.02, rel=0.02)
    again = tl.dense_init(torch.Generator().manual_seed(0), 512, 1024,
                          torch.float32)
    torch.testing.assert_close(w, again, rtol=0, atol=0)
