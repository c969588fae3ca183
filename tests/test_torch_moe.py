"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU.

The reference draws the parameters (``init_moe_params``) and both packages
take the same numpy inputs.  Routing is a discrete decision, so it is held
exactly: the expert ids, the rank-based keep mask and the dropped fraction
equal the reference's routing recomputed in jax (softmax, ``lax.top_k``,
the token-major cumsum).  The outputs are then held in float32 to 1e-5
(absolute and relative: the two frameworks sum the expert products in
other orders), and so are the aux losses and the gradients to the router,
the experts and the input.  The settings cover capacity above demand, drops
(capacity below demand), k == E and granite-moe's 40 experts top-8.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import tree_from_jax  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
D, F = 32, 48

# (n_experts, top_k, capacity_factor, tokens B x S)
CASES = {
    "roomy": (4, 2, 2.0, (2, 8)),
    "drops": (8, 2, 0.5, (2, 12)),            # capacity below demand
    "k_equals_e": (4, 4, 1.0, (1, 10)),
    "granite_40x8": (40, 8, 1.25, (1, 8)),    # decode shape: C = 2
    "jamba_decode_c1": (16, 2, 1.25, (8, 1)),  # C = 1 at 8 slots
}


def _setup(case, seed=0):
    E, k, cf, (B, S) = CASES[case]
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, F, E, jnp.float32)
    tp = tree_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    params = moe.MoEParams(tp["router"], tp["w1"], tp["w3"], tp["w2"])
    x = np.random.default_rng(seed).standard_normal(
        (B, S, D), dtype=np.float32)
    return jp, params, x, dict(n_experts=E, top_k=k, capacity_factor=cf)


def _jax_routing(jp, x, n_experts, top_k, capacity_factor):
    """The reference's routing lines, in jax: (expert ids, keep)."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, ids = jax.lax.top_k(probs, top_k)
    T = xt.shape[0]
    C = max(1, int(capacity_factor * top_k * T / n_experts))
    flat = ids.reshape(-1)
    ranks = jnp.cumsum(jax.nn.one_hot(flat, n_experts, dtype=jnp.int32),
                       axis=0) - 1
    rank = jnp.take_along_axis(ranks, flat[:, None], axis=1)[:, 0]
    return np.asarray(ids), np.asarray(rank < C), C


@pytest.mark.parametrize("case", list(CASES))
def test_routing_matches_reference_exactly(case):
    jp, params, x, kw = _setup(case)
    ids_j, keep_j, C = _jax_routing(jp, x, **kw)
    xt = torch.tensor(x).reshape(-1, D)
    _, _, ids = moe.route(xt @ params.router.detach(), kw["top_k"])
    _, _, keep = moe.dispatch(ids, kw["n_experts"], C)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    if case == "drops":
        assert not keep_j.all(), "the drop case dropped nothing"
    if case in ("roomy", "k_equals_e"):
        assert keep_j.all()


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_and_aux_match_reference(case):
    jp, params, x, kw = _setup(case)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), return_aux=True, **kw)
    with torch.no_grad():
        y, aux = moe.moe_forward(params, torch.tensor(x), return_aux=True,
                                 **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name in ("load_balance", "dropped_frac"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   err_msg=name, **TOL)
    # without aux, the same output
    with torch.no_grad():
        y2 = moe.moe_forward(params, torch.tensor(x), **kw)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("case", ["roomy", "drops", "k_equals_e"])
def test_gradients_match_reference(case):
    """d/d(router, w1, w2, w3, x) of <y, r> + load_balance: the router's
    gradient flows through the renormalized top-k gates and the aux loss."""
    jp, params, x, kw = _setup(case)
    r = np.random.default_rng(9).standard_normal(x.shape, dtype=np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_forward(p, xx, return_aux=True, **kw)
        return jnp.sum(y * r) + aux["load_balance"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_forward(params, xt, return_aux=True, **kw)
    (torch.sum(y * torch.tensor(r)) + aux["load_balance"]).backward()
    for name in ("router", "w1", "w2", "w3"):
        got = getattr(params, name).grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jg[name]), err_msg=name,
                                   **TOL)
    assert np.abs(params.router.grad.numpy()).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)


def test_router_stays_float32_in_a_bf16_layer():
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(gen, D, F, 4, torch.bfloat16)
    assert p.router.dtype == torch.float32
    assert {p.w1.dtype, p.w2.dtype, p.w3.dtype} == {torch.bfloat16}
    assert p.w1.shape == (4, D, F) and p.w2.shape == (4, F, D)
    x = torch.randn((2, 5, D), generator=gen).to(torch.bfloat16)
    y = moe.moe_forward(p, x, n_experts=4, top_k=2)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
