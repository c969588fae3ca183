"""The port's paged decode attention against the JAX reference.

Same inputs (numpy, seeded) into both packages: the port's plain version
(``repro_torch.kernels.ref``) must match the reference's Pallas kernel run
in interpret mode and its jnp oracle on the grid of
tests/test_kernels.py::test_paged_decode_attention_kernel_vs_oracle.  The
CUDA kernel itself runs only on a card (``cuda`` marker, skipped here).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention_fwd as jax_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    paged_decode_attention_fwd  # noqa: E402

GRID_LENGTHS = [1, 5, 12, 0]              # ragged; slot 3 is length-0
KW = [dict(), dict(attn_softcap=30.0), dict(window=6)]


def _operands(S, hd, H, KV, page, max_pages, lengths, seed=0):
    """Random pools + a shuffled (non-identity) page table, as numpy."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + S * max_pages            # page 0 = scratch, never mapped
    q = rng.standard_normal((S, H, hd), dtype=np.float32)
    kp = rng.standard_normal((n_pages, page, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pages, page, KV, hd), dtype=np.float32)
    table = rng.permutation(np.arange(1, n_pages)).reshape(S, max_pages)
    return (q, kp, vp, table.astype(np.int32),
            np.asarray(lengths, np.int32))


def _torch(arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("kw", KW, ids=["plain", "softcap", "window"])
def test_plain_version_matches_pallas_interpret_and_oracle(H, KV, kw):
    arrays = _operands(len(GRID_LENGTHS), 16, H, KV, 4, 4, GRID_LENGTHS)
    port = ref.paged_decode_attention_ref(*_torch(arrays), **kw).numpy()
    jargs = [jnp.asarray(a) for a in arrays]
    pallas = np.asarray(jax_kernel(*jargs, interpret=True, **kw))
    oracle = np.asarray(jax_ref.paged_decode_attention_ref(*jargs, **kw))
    live = np.array(GRID_LENGTHS) > 0
    np.testing.assert_allclose(port[live], pallas[live], atol=1e-5)
    np.testing.assert_allclose(port[live], oracle[live], atol=1e-5)
    # length-0 slot: the same finite filler as the reference's oracle
    np.testing.assert_allclose(port, oracle, atol=1e-5)
    assert np.isfinite(port).all()


def test_dispatcher_takes_plain_version_for_cpu_tensors():
    args = _torch(_operands(2, 8, 4, 2, 4, 2, [3, 7], seed=4))
    before = paged_decode_attention_fwd.launches
    got = ops.paged_decode_attention(*args, window=5)
    want = ref.paged_decode_attention_ref(*args, window=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert paged_decode_attention_fwd.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _torch(_operands(2, 16, 4, 2, 4, 2, [3, 7]))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_fwd(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,page,max_pages,lengths", [
    (4, 4, 16, 4, 4, GRID_LENGTHS),
    (4, 1, 16, 4, 4, GRID_LENGTHS),
    (12, 12, 64, 16, 16, [1, 37, 73, 110, 146, 183, 219, 256]),
    (32, 2, 256, 16, 8, [128, 3, 77]),       # G=16, hd=256: >48 KB smem
])
@pytest.mark.parametrize("kw", KW, ids=["plain", "softcap", "window"])
def test_cuda_kernel_matches_plain_version(cuda_device, H, KV, hd, page,
                                           max_pages, lengths, kw):
    args = _torch(_operands(len(lengths), hd, H, KV, page, max_pages,
                            lengths), cuda_device)
    before = paged_decode_attention_fwd.launches
    got = ops.paged_decode_attention(*args, **kw)
    want = ref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_fwd.launches == before + 1
    live = args[4] > 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_wrapper_rejects_unsupported_shapes(cuda_device):
    q, kp, vp, table, ln = _torch(_operands(2, 24, 4, 2, 4, 2, [3, 7]),
                                  cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention_fwd(q, kp, vp, table, ln)
    q, kp, vp, table, ln = _torch(_operands(2, 16, 4, 2, 4, 2, [3, 7]),
                                  cuda_device)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention_fwd(q, kp, vp, table.long(), ln)
    with pytest.raises(ValueError, match="float32"):
        paged_decode_attention_fwd(q.double(), kp, vp, table, ln)
