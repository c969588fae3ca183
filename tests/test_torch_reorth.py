"""The port's Lanczos reorthogonalization against the JAX reference.

The same numpy inputs (an orthonormal basis from a QR of seeded normals, a
seeded candidate) go through the port's plain version
(``repro_torch.kernels.ref.reorth_ref``), its dispatcher
(``ops.reorthogonalize``), the reference's jnp oracle and the reference's
Pallas kernels in interpret mode (``reorth_pass``), on the cases of
tests/test_landscape.py::test_reorth_pallas_vs_ref — a dead basis suffix
and a row count that is no multiple of the TPU block.

Tolerances (the reference test's own): dots rtol 1e-6 / atol 1e-5 and w
atol 1e-5 against interpret mode, whose dots are per-lane partial sums
(another summation order than a plain ``torch.sum``); against the jnp
oracle, which sums the same products, 1e-5 on the dots (T * 128 = 65,536
float32 terms in two libraries' reduction orders) and 1e-6 on w.  CGS2
leaves a residual below 1e-4 * ||w|| against the live prefix.  On the card
(``cuda`` marker, skipped here) the kernels must give dots within 1e-5 *
||v_k|| * ||w|| of the plain version and, fed the same dots, an axpy equal
to it bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import reorth_pass as jax_reorth_pass  # noqa: E402
from repro.kernels import reorthogonalize as jax_reorthogonalize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.reorth import (MAX_VECTORS, reorth_axpy,  # noqa: E402
                                        reorth_dots)

CASES = [(2, 4, 4), (512, 6, 3), (331, 8, 8)]
IDS = [f"T{t}-M{m}-live{live}" for t, m, live in CASES]


def _operands(T, M, live, seed=None):
    rng = np.random.default_rng(T + M if seed is None else seed)
    q, _ = np.linalg.qr(rng.standard_normal((T * 128, M)))
    basis = np.ascontiguousarray(q.T.reshape(M, T, 128), np.float32)
    w = rng.standard_normal((T, 128), dtype=np.float32)
    mask = (np.arange(M) < live).astype(np.float32)
    return basis, w, mask


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.mark.parametrize("T,M,live", CASES, ids=IDS)
def test_one_sweep_matches_reference_kernel_and_oracle(T, M, live):
    basis, w, mask = _operands(T, M, live)
    w_p, d_p = ref.reorth_ref(*_t(basis, w, mask))
    w_k, d_k = jax_reorth_pass(jnp.asarray(basis), jnp.asarray(w),
                               jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_k), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_k), atol=1e-5)
    w_r, d_r = jax_ref.reorth_ref(jnp.asarray(basis), jnp.asarray(w),
                                  jnp.asarray(mask))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_r), atol=1e-6)
    # the dead suffix gets no weight
    assert np.all(d_p.numpy()[live:] == 0.0)


@pytest.mark.parametrize("T,M,live", CASES, ids=IDS)
def test_cgs2_matches_reference_and_is_orthogonal(T, M, live):
    basis, w, mask = _operands(T, M, live)
    tb, tw, tm = _t(basis, w, mask)
    w_before = tw.clone()
    w2 = ops.reorthogonalize(tb, tw, tm)
    assert torch.equal(tw, w_before)                  # w itself untouched
    assert torch.equal(w2, ops.reorthogonalize(tb, tw, tm, backend="ref"))
    want = jax_reorthogonalize(jnp.asarray(basis), jnp.asarray(w),
                               jnp.asarray(mask), backend="ref")
    np.testing.assert_allclose(w2.numpy(), np.asarray(want), atol=1e-5)
    resid = torch.einsum("mtl,tl->m", tb, w2) * tm
    assert float(resid.abs().max()) < 1e-4 * float(torch.linalg.norm(w2))


def test_axpy_plain_version_repeats_the_sweep_given_its_dots():
    basis, w, mask = _operands(64, 5, 3)
    tb, tw, tm = _t(basis, w, mask)
    w_new, dots = ref.reorth_ref(tb, tw, tm)
    assert torch.equal(ref.reorth_axpy_ref(tw, tb, dots), w_new)


def test_wrappers_refuse_cpu_tensors_and_dispatch_cuda_to_the_kernel():
    basis, w, mask = _t(*_operands(8, 3, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        reorth_dots(basis, w, mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        reorth_axpy(w, basis, mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.reorthogonalize(basis, w, mask, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.reorthogonalize(basis, w, mask, backend="pallas")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [(2, 4, 4), (331, 8, 8), (1000, 1, 1), (777, 6, 3),
              (4096, 9, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,live", CUDA_CASES,
                         ids=[f"T{t}-M{m}-live{v}" for t, m, v in CUDA_CASES])
def test_cuda_kernels_equal_plain_version(cuda_device, T, M, live):
    basis, w, mask = _t(*_operands(T, M, live), device=cuda_device)
    before = (reorth_dots.launches, reorth_axpy.launches)
    d_k = reorth_dots(basis, w, mask)
    _, d_p = ref.reorth_ref(basis, w, mask)
    # same dots in -> the axpy equals the plain version bitwise
    w_k = reorth_axpy(w, basis, d_p)
    w_p = ref.reorth_axpy_ref(w, basis, d_p)
    torch.cuda.synchronize()
    assert (reorth_dots.launches, reorth_axpy.launches) == (
        before[0] + 1, before[1] + 1)
    scale = torch.linalg.norm(basis.reshape(M, -1), dim=1) * \
        torch.linalg.norm(w)
    assert float(((d_k - d_p).abs() / scale).max()) <= 1e-5
    assert torch.equal(w_k, w_p)
    # in place into w, as the second CGS sweep does
    w_in = w.clone()
    assert reorth_axpy(w_in, basis, d_p, out=w_in) is w_in
    assert torch.equal(w_in, w_p)
    w2 = ops.reorthogonalize(basis, w, mask)
    resid = torch.einsum("mtl,tl->m", basis, w2) * mask
    assert float(resid.abs().max()) < 1e-4 * float(torch.linalg.norm(w2))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    basis, w, mask = _t(*_operands(16, 3, 2), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        reorth_dots(basis.double(), w.double(), mask.double())
    with pytest.raises(ValueError, match="must be"):
        reorth_dots(basis, w[:8], mask)
    with pytest.raises(ValueError, match="contiguous"):
        reorth_dots(basis, w.t().contiguous().t(), mask)
    with pytest.raises(ValueError, match="must be"):
        reorth_dots(basis, w, mask[:2])
    with pytest.raises(ValueError, match="overlaps"):
        reorth_axpy(w, basis, mask, out=basis[0])
    big = torch.zeros((MAX_VECTORS + 1, 16, 128), device=cuda_device)
    with pytest.raises(ValueError, match="basis vectors"):
        reorth_dots(big, w, torch.ones(MAX_VECTORS + 1, device=cuda_device))
