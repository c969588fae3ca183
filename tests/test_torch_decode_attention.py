"""The port's paged decode attention against the JAX reference.

Same inputs (numpy, seeded) into both packages: the port's plain version
(``repro_torch.kernels.ref``) must match the reference's Pallas kernel run
in interpret mode and its jnp oracle on the grid of
tests/test_kernels.py::test_paged_decode_attention_kernel_vs_oracle
(float32, 1e-5), and on bf16 pools with gemma2-27b's heads (G = 2, hd 128,
softcap, window).  bf16 is held per element to one bf16 ulp of the value,
2^-7 |want|, plus 1e-3 of the output's rms: each side sums in float32 and
rounds its result to bf16 once, so a value near a rounding boundary may
land one ulp apart and no further.  The split plan that cuts a slot's
history for the CUDA kernel is checked on the CPU: it covers every token
once, in page-aligned ranges, from integers alone; so is the plan that
keeps every query head of a kv head in one block (MQA's G = 48 of
granite-20b included) and cuts them into tiles only past a block's
registers or shared memory.  The CUDA kernel itself
runs only on a card (``cuda`` marker, skipped here): float32 within 1e-5
of its plain version, bf16 within the bf16 tier, at split boundaries,
lengths 0 / 1 / max and windows that start inside a split, at G = 24
and 48 (256 threads a block), and with its
scratch (the partials and the merge's ticket counters) shared by calls of
other shapes and kept per stream; how the wrapper keeps that scratch is
checked on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention_fwd as jax_kernel  # noqa: E402
from repro_torch.kernels import decode_attention, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    BLOCKS_PER_SM, MAX_BLOCK_ELEMS, MAX_SPLIT_TOKENS, SMEM_LIMIT,
    check_shapes, kernel_for,
    group_tiles, launch_plan, paged_decode_attention_fwd, smem_bytes,
    split_plan)

GRID_LENGTHS = [1, 5, 12, 0]              # ragged; slot 3 is length-0
KW = [dict(), dict(attn_softcap=30.0), dict(window=6)]
BF16_ULP, BF16_RMS = 2.0 ** -7, 1e-3


def _operands(S, hd, H, KV, page, max_pages, lengths, seed=0,
              dtype="float32"):
    """Random pools + a shuffled (non-identity) page table, as numpy; with
    ``dtype="bfloat16"`` q and the pools hold bf16-exact float32 values."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + S * max_pages            # page 0 = scratch, never mapped
    q = rng.standard_normal((S, H, hd), dtype=np.float32)
    kp = rng.standard_normal((n_pages, page, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pages, page, KV, hd), dtype=np.float32)
    if dtype == "bfloat16":
        q, kp, vp = (np.asarray(jnp.asarray(a, jnp.bfloat16)
                                .astype(jnp.float32)) for a in (q, kp, vp))
    table = rng.permutation(np.arange(1, n_pages)).reshape(S, max_pages)
    return (q, kp, vp, table.astype(np.int32),
            np.asarray(lengths, np.int32))


def _torch(arrays, device="cpu", dtype="float32"):
    out = [torch.tensor(a, device=device) for a in arrays]
    for i in range(3):
        out[i] = out[i].to(getattr(torch, dtype))
    return out


def _assert_bf16_tier(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    tol = BF16_ULP * np.abs(w) + BF16_RMS * np.sqrt(np.mean(w ** 2))
    ratio = float(np.max(np.abs(g - w) / tol))
    assert ratio <= 1.0, f"|got - want| reaches {ratio} x the bf16 tier"


# the last two: G = 48 (granite-20b's MQA) and 24, whole in the
# reference's block
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1), (48, 1), (48, 2)])
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


# gemma2-27b's heads per kv head and head width, its softcap and a window
# that binds at these lengths
GEMMA_KW = [dict(attn_softcap=50.0), dict(window=7, attn_softcap=50.0)]


@pytest.mark.parametrize("kw", GEMMA_KW, ids=["global", "local"])
def test_bf16_pools_match_pallas_interpret_and_oracle(kw):
    arrays = _operands(len(GRID_LENGTHS), 128, 4, 2, 4, 4, GRID_LENGTHS,
                       seed=7, dtype="bfloat16")
    port = ops.paged_decode_attention(*_torch(arrays, dtype="bfloat16"),
                                      **kw)
    assert port.dtype == torch.bfloat16
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]] + \
        [jnp.asarray(a) for a in arrays[3:]]
    pallas = jax_kernel(*jargs, interpret=True, **kw)
    oracle = jax_ref.paged_decode_attention_ref(*jargs, **kw)
    assert pallas.dtype == jnp.bfloat16
    port = port.float().numpy()
    # every slot, the length-0 one's uniform-average filler included
    _assert_bf16_tier(port, np.asarray(pallas.astype(jnp.float32)))
    _assert_bf16_tier(port, np.asarray(oracle.astype(jnp.float32)))
    # and the bf16 result is the float32 one, rounded once
    f32 = ref.paged_decode_attention_ref(*_torch(arrays), **kw).numpy()
    _assert_bf16_tier(port, f32)


@pytest.mark.parametrize("H,KV,hd,dtype,gtiles", [
    (12, 12, 64, torch.float32, 1),       # transformer-100m
    (32, 16, 128, torch.bfloat16, 1),     # gemma2-27b
    (48, 1, 128, torch.bfloat16, 1),      # granite-20b: one block, 48 heads
    (96, 8, 128, torch.bfloat16, 1),      # mistral-large-123b
    (56, 8, 128, torch.bfloat16, 1),      # yi-34b
    (128, 1, 128, torch.float32, 2),      # 16,384 accumulators: 2 tiles
    (32, 1, 256, torch.float32, 2),       # hd 256 float32: shared memory
    (512, 1, 16, torch.bfloat16, 1),
    (1024, 1, 16, torch.float32, 2),
])
def test_every_group_is_taken_and_tiled_only_past_a_block(H, KV, hd, dtype,
                                                          gtiles):
    check_shapes((8, H, hd), (65, 16, KV, hd), dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    tiles, splits, pages = launch_plan(8, H, KV, hd, size, 16, 512, 132)
    assert tiles == gtiles
    heads = -(-(H // KV) // tiles)
    assert heads * hd <= MAX_BLOCK_ELEMS
    assert smem_bytes(heads, hd, size, pages * 16) <= SMEM_LIMIT
    # blocks of 256 threads (past 4,096 accumulators) aim at half as many
    # blocks an SM
    per_sm = BLOCKS_PER_SM // (2 if heads * hd > MAX_BLOCK_ELEMS // 2 else 1)
    assert (splits, pages) == split_plan(512, 16, 8, KV * tiles, 132,
                                         per_sm)
    assert group_tiles(H // KV, hd, size, pages * 16) <= tiles


def test_bf16_pools_at_large_groups_route_to_the_tensor_cores():
    bf, f32 = torch.bfloat16, torch.float32
    assert kernel_for(bf, 48, 128) == "tc"            # granite-20b
    assert kernel_for(bf, 16, 64) == kernel_for(bf, 128, 128) == "tc"
    assert kernel_for(f32, 48, 128) == "fma"          # float32 pools
    assert kernel_for(bf, 2, 128) == "fma"            # gemma2-27b
    assert kernel_for(bf, 12, 128) == "fma"           # mistral-large
    assert kernel_for(bf, 48, 256) == "fma"
    assert kernel_for(bf, 256, 64) == "fma"
    assert kernel_for(bf, 48, 128, gtiles=2) == "fma"


def test_decode_shape_rule_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        check_shapes((8, 4, 64), (9, 16, 2, 64), torch.float64)
    with pytest.raises(ValueError, match="H % KV"):
        check_shapes((8, 6, 64), (9, 16, 4, 64), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        check_shapes((8, 4, 24), (9, 16, 2, 24), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        check_shapes((8, 4, 272), (9, 16, 2, 272), torch.float32)
    with pytest.raises(ValueError, match="fit"):
        check_shapes((8, 4, 64), (9, 16, 2, 128), torch.float32)
    with pytest.raises(ValueError, match="S, H, hd"):
        check_shapes((8, 64), (9, 16, 2, 64), torch.float32)


SPLIT_SHAPES = [
    # (max_pages, page, S, KV, n_sm)
    (16, 16, 8, 12, 132),       # transformer-100m's serve shape
    (512, 16, 8, 16, 132),      # gemma2-27b's decode shape, 8,192 tokens
    (40, 16, 8, 16, 132),       # gemma2-27b served at max_len 640
    (4, 4, 4, 2, 132),
    (1, 16, 1, 1, 132),
    (7, 3, 2, 1, 8),
    (1000, 1, 64, 8, 132),
    (33, 16, 1, 1, 1),
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
def test_split_plan_covers_every_token_once_in_page_aligned_ranges(shape):
    max_pages, page, S, KV, n_sm = shape

    class NoTorch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            raise AssertionError(f"split_plan called {func}")

    with NoTorch():
        splits, pages = split_plan(max_pages, page, S, KV, n_sm)
    assert isinstance(splits, int) and isinstance(pages, int)
    assert splits >= 1 and pages >= 1
    W = max_pages * page
    tokens = pages * page                     # page-aligned by construction
    covered = np.zeros(W, np.int64)
    for i in range(splits):
        lo, hi = i * tokens, min((i + 1) * tokens, W)
        assert lo < hi, f"split {i} of {splits} covers nothing"
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)
    assert tokens < MAX_SPLIT_TOKENS + page


def test_split_plan_at_the_serve_and_gemma2_shapes():
    # 6 splits of 48 tokens: 576 blocks for 8 slots x 12 kv heads
    assert split_plan(16, 16, 8, 12, 132) == (6, 3)
    # 16 splits of 512 tokens: 2,048 blocks for 8 slots x 16 kv heads
    assert split_plan(512, 16, 8, 16, 132) == (16, 32)


def test_scratch_is_kept_per_stream_and_only_grown(monkeypatch):
    """The wrapper's scratch: one (partials, tickets) pair per (device,
    stream), reused while it is large enough, replaced by a larger one
    when a call needs more, with the tickets zeroed on allocation."""
    monkeypatch.setattr(decode_attention, "_scratch", {})
    cpu = torch.device("cpu")
    part, tickets = decode_attention._scratch_for(cpu, 1, 100, 8)
    assert part.dtype == torch.float32 and part.numel() == 100
    assert tickets.dtype == torch.int32 and bool((tickets == 0).all())
    tickets[3] = 5                        # stands for a call in flight
    again = decode_attention._scratch_for(cpu, 1, 60, 8)
    assert again[0] is part and again[1] is tickets
    other = decode_attention._scratch_for(cpu, 2, 60, 8)
    assert other[0] is not part and bool((other[1] == 0).all())
    grown = decode_attention._scratch_for(cpu, 1, 200, 16)
    assert grown[0].numel() == 200 and grown[1].numel() == 16
    assert bool((grown[1] == 0).all())
    assert len(decode_attention._scratch) == 2


def test_dispatcher_backend_argument():
    args = _torch(_operands(2, 16, 4, 2, 4, 2, [3, 7], seed=5))
    want = ref.paged_decode_attention_ref(*args, attn_softcap=20.0)
    before = paged_decode_attention_fwd.launches
    for backend in ("auto", "ref"):
        got = ops.paged_decode_attention(*args, attn_softcap=20.0,
                                         backend=backend)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert paged_decode_attention_fwd.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(*args, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.paged_decode_attention(*args, backend="pallas")


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
    (24, 1, 64, 16, 16, [1, 37, 73, 110, 146, 183, 219, 256]),   # G = 24
    (48, 1, 128, 16, 16, [1, 37, 73, 110, 146, 183, 219, 256]),  # G = 48
    (48, 2, 32, 4, 4, GRID_LENGTHS),                             # G = 24
    # two head tiles: past 8,192 accumulators, and past the shared memory
    (160, 1, 64, 16, 8, [128, 3, 77, 1]),
    (32, 1, 256, 16, 8, [128, 3, 77]),
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
    with pytest.raises(ValueError, match="one dtype"):
        paged_decode_attention_fwd(q, kp.bfloat16(), vp, table, ln)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", [(16, 1, 64), (40, 1, 64), (48, 1, 128),
                                     (96, 2, 64), (128, 1, 128)])
@pytest.mark.parametrize("kw", [dict(), dict(attn_softcap=50.0),
                                dict(window=40)],
                         ids=["plain", "softcap", "window"])
def test_cuda_tensor_core_path_for_bf16_pools_at_large_groups(cuda_device,
                                                             H, KV, hd, kw):
    """bf16 pools at 16 <= G <= 128 (hd 64, 128) take the tensor-core
    kernel: rows past G in its last 16-head tile, lengths 0 and 1, one
    split and several, and a window, within the bf16 tier."""
    assert kernel_for(torch.bfloat16, H // KV, hd) == "tc"
    lengths = [0, 1, 37, 300, 700, 1024]
    args = _torch(_operands(len(lengths), hd, H, KV, 16, 64, lengths,
                            seed=H + hd, dtype="bfloat16"), cuda_device,
                  "bfloat16")
    got = ops.paged_decode_attention(*args, **kw)
    want = ops.paged_decode_attention(*args, backend="ref", **kw)
    torch.cuda.synchronize()
    live = args[4] > 0
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert bool((got[~live] == 0).all())
    _assert_bf16_tier(got[live].float().cpu().numpy(),
                      want[live].float().cpu().numpy())


def _split_tokens(max_pages, page, S, KV):
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits, pages = split_plan(max_pages, page, S, KV, n_sm)
    return splits, pages * page


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(8, 4), (48, 1), (24, 1)],
                         ids=["G2", "G48", "G24"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(attn_softcap=50.0),
                                dict(window=40), dict(window=37,
                                                      attn_softcap=50.0)],
                         ids=["plain", "softcap", "window", "local"])
def test_cuda_kernel_at_split_boundaries_and_edge_lengths(cuda_device,
                                                          dtype, kw, heads):
    """gemma2's heads (G = 2, hd 128) and granite-20b's (G = 48, KV 1);
    lengths 0, 1, max, and one token either side of each split boundary;
    the windows start inside splits."""
    H, KV, hd, page, max_pages = heads + (128, 16, 64)
    S_probe = 12
    _, tok = _split_tokens(max_pages, page, S_probe, KV)
    W = max_pages * page
    lengths = [0, 1, W, tok, tok + 1, tok - 1, 2 * tok, 2 * tok + 1,
               W - 1, tok // 2, 3 * page + 5, W - tok + 3]
    lengths = [min(max(n, 0), W) for n in lengths]
    assert len(lengths) == S_probe
    args = _torch(_operands(S_probe, hd, H, KV, page, max_pages, lengths,
                            seed=11, dtype=dtype), cuda_device, dtype)
    before = paged_decode_attention_fwd.launches
    got = ops.paged_decode_attention(*args, **kw)
    want = ops.paged_decode_attention(*args, backend="ref", **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_fwd.launches == before + 1
    assert got.dtype == args[0].dtype and torch.isfinite(got).all()
    live = args[4] > 0
    assert bool((got[~live] == 0).all())      # length 0 writes zeros
    if dtype == "float32":
        torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-5)
    else:
        _assert_bf16_tier(got[live].float().cpu().numpy(),
                          want[live].float().cpu().numpy())


@pytest.mark.cuda
def test_cuda_kernel_shares_its_scratch_across_shapes_and_streams(
        cuda_device):
    """The ticket counters outlive a call: each call leaves them at 0, so
    calls of other shapes in turn, and on a second stream, each match the
    plain version, and every counter reads 0 afterwards."""
    shapes = [   # (H, KV, hd, page, max_pages, lengths, dtype)
        (8, 4, 128, 16, 64, [0, 1, 1024, 129, 257, 640, 33, 1000],
         "bfloat16"),
        (12, 12, 64, 16, 16, [1, 37, 73, 110, 146, 183, 219, 256],
         "float32"),
    ]
    sets = []
    for i, (H, KV, hd, page, max_pages, lengths, dtype) in enumerate(shapes):
        args = _torch(_operands(len(lengths), hd, H, KV, page, max_pages,
                                lengths, seed=20 + i, dtype=dtype),
                      cuda_device, dtype)
        kw = dict(attn_softcap=50.0) if dtype == "bfloat16" else {}
        sets.append((args, kw, ops.paged_decode_attention(
            *args, backend="ref", **kw)))
    side = torch.cuda.Stream()
    got = [paged_decode_attention_fwd(*a, **kw) for a, kw, _ in sets]
    got.append(paged_decode_attention_fwd(*sets[0][0], **sets[0][1]))
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got += [paged_decode_attention_fwd(*a, **kw) for a, kw, _ in sets]
    torch.cuda.synchronize()
    for out, (args, _, want) in zip(got, sets + sets[:1] + sets):
        live = args[4] > 0
        if out.dtype == torch.float32:
            torch.testing.assert_close(out[live], want[live], rtol=0,
                                       atol=1e-5)
        else:
            _assert_bf16_tier(out[live].float().cpu().numpy(),
                              want[live].float().cpu().numpy())
    for _, tickets in decode_attention._scratch.values():
        assert bool((tickets == 0).all())
