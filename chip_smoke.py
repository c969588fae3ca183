"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card and build: the card's name and power limit; every kernel of the
     port compiled from ``src/repro_torch/kernels/csrc`` with nvcc (one
     process per source, started together), with the build time;
  2. each kernel against its plain PyTorch version on the card, on inputs
     drawn from a seeded numpy RNG — the decode attention in float32 at
     the serve shape and at GQA shapes with softcap and window (1e-5), and
     from bf16 pools at gemma2-27b's decode shape (H 32, KV 16, hd 128, 8
     slots up to 8,192 tokens: the global and local layers, a length-0
     and a length-1 slot, windows that start inside a split) and at phase
     3b's shape (40 pages, slots up to 576 tokens and either side of its
     split boundaries, q scaled so the softcap binds) and at granite-20b's
     (MQA: H 48 on KV 1, hd 128, 8 slots up to 8,192 tokens, a length-0
     and a length-1 slot), each element within 2^-7 |plain| + 1e-3
     rms(plain), timed at the serve shape, at gemma2's global and local
     decode layers and at granite's (bound: the bytes, or the arithmetic
     of the kernel that runs: granite's bf16 pools take the tensor-core
     kernel); the gossip
     update at the training shape (n=4, T=1,056,920, K=1, momentum), on a
     ring with weight decay and an inactive NaN row, in AD-PSGD publish
     mode, and as a mixing-only round (K=3); the reorthogonalization
     kernels (Lanczos CGS2) at the transformer-100m probe shape (M = 9,
     T = 1,056,920), on a ragged T, M = 1, a partial mask and an
     orthonormal (QR) basis, on vectors drawn on the card from a seeded
     torch.Generator: dots within 1e-5 of ||v_k|| ||w||, the axpy bitwise
     given the same dots, the CGS2 residual below 1e-4 ||w|| — then each
     kernel's time beside the plain version's, one PyTorch library call's
     where one computes the same function, and the least time the card
     could take (``bound_ms``);
  3. full-width serving: transformer-100m (12 layers, d=768, vocab 32768,
     random weights from a seeded torch.Generator) behind ``ServeEngine``
     (8 slots, page 16, max_len 256) runs 16 requests to completion; every
     request must finish with its budget, every logit must be finite, the
     attention kernel must have launched 12 times per engine step, and the
     first 3 steps' logits must match the port on the CPU (plain versions,
     same weights);
  3b. gemma2-27b served the same way at full width, depth cut to one
     local/global period (2 layers, 2.31 B bf16 parameters, bf16 K/V
     pools): 8 slots, page 16, max_len 640, 16 requests of 32-512 prompt
     and 16-64 new tokens; 2 decode launches per step, the first 3 steps'
     logits within 2e-2 (relative, Frobenius) of the port on the CPU, and
     the decode kernel, on the inputs both layers gave it at steps 256,
     512 and 768, within the bf16 tier of its plain version;
  3c. granite-20b served as in 3b at full width, depth cut from 52 to 2
     layers (1.67 B bf16 parameters; 48 query heads on one kv head), with
     the same requests and checks;
  4. full-width training: transformer-100m trained with DPSGD by
     ``MultiLearnerTrainer`` (4 learners, random_pair, the
     ``examples/train_100m.py`` recipe: sgd(0.5, momentum 0.9) under a
     warm-up schedule, synthetic tokens, seq 512, local batch 2): 2 warm-up
     and 6 timed steps, then 2 profiled ones; every loss must be finite,
     the gossip kernel must have launched once per gossip round, and the
     first 2 steps with ``kernel_backend="ref"`` must give the same
     parameters;
  4b. the full-width landscape probe: after the training steps, a
     ``make_trainer_probe`` hook (Lanczos 8, Hutchinson 4) runs once
     through ``trainer.run_probes`` on a 4 x 2 x 512-token superbatch, then
     ``trainer.diagnostics``; every field finite, the sharpness equal to a
     ``reorth="ref"`` run of the same probe within 1e-4, the reorth
     kernels launched 16 / 16 times (0 / 0 in the ``ref`` run);
  5. the paper's experiment and the other modes on the FC net: the
     quickstart twin (SSGD vs DPSGD at lr 0.5, 5 x 400, 120 steps; DPSGD
     must end below SSGD), ``full`` gossip on 4 learners (two rounds, so
     the mixing-only pass runs) with momentum and weight decay, and
     AD-PSGD with a straggler, both against ``kernel_backend="ref"``;
  6. Table 1 at nB = 2000, lr = 0.5 (``repro_torch.bench``): SSGD must
     fail, DPSGD converge and SSGD+AutoLR converge below 1e-2 with the
     controller clamping below 1, through the reorth kernels; a
     ``reorth="ref"`` AutoLR run must agree on the first probe's
     sharpness within 1e-4 and end below 1e-2 too;
  2d. the flash-attention kernels against their plain version at
     gemma2-27b's shape (bf16, window 4,096, softcap 50, S = 4,608),
     transformer-100m's training shape (float32, S = 512), granite-20b's
     MQA (bf16, S = 1,024), non-causal float32 (S = 256, hd 32), rows with
     no live key (Sq 256 > Sk 128 + window 64), gemma2's heads and masks in
     float32 with q scaled so the softcap binds, ragged bf16 lengths (Sq =
     Sk = 100; Sq 100, Sk 37) and bf16 at hd 64, ragged float32 lengths
     at hd 32, 64 and 128 (the same two masks) and ragged bf16 at hd 32 —
     float32 within the reference's tiers, bf16 within one bf16 ulp of
     each value — then, at gemma2's prefill shapes (S = 8,192, global and
     local) and the training shape, the same comparison, its time, the
     plain version's, SDPA's where one call computes the same function
     and the bound (the tensor-core kernel: q.k once and P.V twice at the
     bf16 rate; the float32 kernel: the slower of q.k in float32 FMAs and
     P.V three times at the TF32 rate, beside both at the float32 rate);
  2e. the single-learner gossip kernel through ``ops.dpsgd_fused_update``
     on transformer-100m's full parameter tree with 2 neighbour trees,
     bitwise equal to ``backend="ref"``, then its time;
  7. gemma2-27b at full width, depth cut to one local/global period (2
     layers; 2.31 B bf16 parameters from a seeded torch.Generator), with
     ``use_pallas``: ``api.apply`` prefill of 8,192 tokens (2 flash
     launches, finite logits, the last 64 positions equal to the chunked
     route's within a bf16 tier), then ``loss_fn`` + backward at 4,608
     tokens (2 launches, finite gradients, both layers' ``wq`` gradients
     equal to the chunked route's within the tier);
  8. transformer-100m trained as in phase 4 with ``use_pallas``: 48 flash
     launches per step, the first 2 losses equal to phase 4's within 1e-5
     relative, step time, idle share and kernels per step beside phase
     4's.
Each path runs with every kernel's launch count set to 0 just before it
and read just after.  The last lines are the serve (100m, gemma2,
granite), train, probe, FC, Table-1, gemma2 and flash-training numbers,
the card, the kernels record and ``{"ok": true, "device": {...}}``.
Without CUDA the script exits 1 before printing any result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_SLOTS, PAGE, MAX_LEN = 8, 16, 256
N_REQUESTS = 16
CPU_STEPS = 3
KERNEL_ATOL = 1e-5
# logits over 12 float32 layers on the card against the CPU: the sums run
# in other orders, so the two agree to ~1e-5 relative, not bitwise
LOGIT_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # float32 outside the tensor cores
TF32_FLOPS = 495e12                # TF32 in the tensor cores, dense
BF16_FLOPS = 989e12                # bf16 in the tensor cores, dense
L2_BYTES = 50 * 2 ** 20
# training (examples/train_100m.py's recipe at full width)
TRAIN_LEARNERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 2, 512, 0.5
TRAIN_ROWS = 1_056_920      # T of transformer-100m's flat store (checked)
CASE_ROWS = 131_072         # T of the other gossip cases: 64 MB per learner
WARM_STEPS, TIMED_STEPS, PROF_STEPS, REF_STEPS = 2, 6, 2, 2
# the gossip kernel rounds every operation as its plain version does, so
# the two agree bitwise; a training step recomputes its gradients, and
# cuBLAS or the embedding backward may sum in another order run to run
GOSSIP_ATOL = 0.0
TRAIN_REF_ATOL = 1e-5
# reorthogonalization: the dots sum T * 128 float32 products in another
# order than torch.sum (1.35e8 terms at the probe shape), so they are held
# relative to ||v_k|| ||w||; the axpy rounds as its plain version does
REORTH_M = 9                # Lanczos 8 steps -> a 9-vector basis
REORTH_DOTS_RTOL = 1e-5
REORTH_AXPY_ATOL = 0.0
REORTH_RESIDUAL = 1e-4      # of ||w||: tests/test_landscape.py's bound
# the full-width probe and Table 1
PROBE_ITERS, PROBE_SAMPLES = 8, 4
PROBE_RTOL = 1e-4
TABLE1_SCALE, TABLE1_STEPS = 4, 120     # nB = 2000, lr = 0.5
# flash attention. float32: the reference's own sweep tiers
# (tests/test_kernels.py) — the sums run in another order than the plain
# version's einsum, so 2e-6 holds to S = 256 and 1e-5 above. bf16: both
# sides round one float32 result once, so they may land one bf16 ulp apart
# (at most 2^-7 of the value) and no further; each element is held to
# 2^-7 |plain| + 1e-3 rms(plain), the second term for sums near 0
FLASH_ATOL_F32_SHORT, FLASH_ATOL_F32 = 2e-6, 1e-5
FLASH_BF16_ULP, FLASH_BF16_RMS = 2.0 ** -7, 1e-3
_BF16, _F32 = torch.bfloat16, torch.float32
FLASH_CASES = [   # (name, B, H, KV, hd, Sq, dtype, mask, Sk or None, q scale)
    ("a_gemma2", 1, 32, 16, 128, 4608, _BF16,
     dict(causal=True, window=4096, attn_softcap=50.0), None, 1.0),
    ("b_train_100m", 2, 12, 12, 64, 512, _F32, dict(causal=True), None, 1.0),
    ("c_granite_mqa", 1, 48, 1, 128, 1024, _BF16, dict(causal=True), None,
     1.0),
    ("d_full_f32", 1, 4, 2, 32, 256, _F32, dict(causal=False), None, 1.0),
    ("e_no_live_key_rows", 1, 4, 2, 32, 256, _F32,
     dict(causal=False, window=64), 128, 1.0),
    # gemma2's heads and masks in float32, q scaled by 8 so scores reach
    # tens and the cap at 50 changes them by whole units: a kernel that
    # dropped or misplaced the softcap fails here (checked below)
    ("f_softcap_binds_f32", 1, 32, 16, 128, 4608, _F32,
     dict(causal=True, window=4096, attn_softcap=50.0), None, 8.0),
    # the tensor-core kernel's ragged tiles (a length the reference takes
    # below its 128 block) and its hd-64 instance
    ("g_ragged_bf16", 1, 4, 2, 128, 100, _BF16,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("h_ragged_sk_bf16", 1, 4, 2, 128, 100, _BF16, dict(causal=False), 37,
     1.0),
    ("i_hd64_bf16", 1, 8, 4, 64, 512, _BF16,
     dict(causal=True, attn_softcap=50.0), None, 1.0),
    # the float32 kernel's ragged tiles at each head width (Sq = Sk = 100
    # with window and softcap; Sq 100 against Sk 37), and bf16 at hd 32
    ("j_ragged_f32_hd32", 1, 4, 2, 32, 100, _F32,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("k_ragged_f32_hd64", 1, 4, 2, 64, 100, _F32,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("l_ragged_f32_hd128", 1, 4, 2, 128, 100, _F32,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
    ("m_ragged_sk_f32_hd32", 1, 4, 2, 32, 100, _F32, dict(causal=False),
     37, 1.0),
    ("n_ragged_sk_f32_hd64", 1, 4, 2, 64, 100, _F32, dict(causal=False),
     37, 1.0),
    ("o_ragged_sk_f32_hd128", 1, 4, 2, 128, 100, _F32, dict(causal=False),
     37, 1.0),
    ("p_ragged_bf16_hd32", 1, 4, 2, 32, 100, _BF16,
     dict(causal=True, window=32, attn_softcap=50.0), None, 1.0),
]
# the cap's effect on case f's plain output, in units of its tolerance
FLASH_CAP_EFFECT_MIN = 100.0
# single-learner gossip: every operation rounded as the plain version
GOSSIP_SINGLE_K, GOSSIP_SINGLE_LR, GOSSIP_SINGLE_BETA = 2, 0.1, 0.9
# gemma2-27b at full width, 2 layers (one local/global period)
GEMMA_LAYERS, GEMMA_PREFILL_SEQ, GEMMA_TRAIN_SEQ = 2, 8192, 4608
GEMMA_LAST = 64             # prefill positions compared with the chunked route
GEMMA_CHUNK = 512           # the chunked route's block at S = 4,608 (9 x 512)
# the flash and chunked routes round the attention output to bf16 from
# float32 sums taken in other orders, and two bf16 layers and the tied head
# carry the difference on: held as ||a - b|| / ||b||
GEMMA_BF16_RTOL = 2e-2
GEMMA_LOSS_RTOL = 1e-3
# gemma2-27b's decode shape in phase 2: 8 slots, lengths up to 8,192
GEMMA_DECODE_LEN = 8192
# phase 3b: gemma2-27b served (8 slots, page 16) from bf16 pools
GEMMA_SERVE_MAX_LEN, GEMMA_SERVE_REQUESTS = 640, 16
GEMMA_SERVE_PROMPT, GEMMA_SERVE_NEW = (32, 512), (16, 64)
GEMMA_SERVE_KEEP_STEPS = (256, 512, 768)    # of 1,040 engine steps
# granite-20b (arXiv:2405.04324: MQA, 48 query heads on one kv head, hd
# 128): its decode shape in phase 2 (8 slots up to 8,192 tokens, bf16
# pools) and phase 3c, served at full width with 2 of its 52 layers, as
# phase 3b serves gemma2
GRANITE_LAYERS = 2
FLASH_TIMED = {   # (B, H, KV, hd, S, dtype, mask, library call or None)
    "gemma2_prefill_global": (1, 32, 16, 128, GEMMA_PREFILL_SEQ, _BF16,
                              dict(causal=True, attn_softcap=50.0), None),
    "gemma2_prefill_local": (1, 32, 16, 128, GEMMA_PREFILL_SEQ, _BF16,
                             dict(causal=True, window=4096,
                                  attn_softcap=50.0), None),
    "train_100m": (TRAIN_BATCH, 12, 12, 64, TRAIN_SEQ, _F32,
                   dict(causal=True), "sdpa"),
}
# transformer-100m with use_pallas against phase 4's chunked route
FLASH_TRAIN_WARM, FLASH_TRAIN_TIMED, FLASH_TRAIN_PROF = 2, 4, 2
FLASH_TRAIN_LOSS_RTOL = 1e-5


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters=200) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``arg_sets``
    (copies large enough together to miss the L2, as the serve path's 12
    layers of pools do), timed with CUDA events after a warm-up."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_times(run):
    """Run ``run()`` under torch.profiler; returns ({event name: [device
    us, count]} over the device's events, the same over the host's launch
    and copy API calls, wall seconds, {host op name: [self us, count]}).
    The profiler's own host cost inflates the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out, api, host = {}, {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = out.setdefault(e.name, [0.0, 0])
        elif e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy")):
            acc = api.setdefault(e.name, [0.0, 0])
        else:
            acc = host.setdefault(e.name, [0.0, 0])
            acc[0] += e.self_cpu_time_total
            acc[1] += 1
            continue
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    return out, api, wall, host


def per_event_ms(times, kernel_name):
    """(device ms per call, fewest events kept) of the kernels whose name
    holds ``kernel_name`` in a ``device_times`` result: the profiler may
    drop events from a short window, and not evenly across kernels, so
    each kernel's time is divided by its own events, and a call of two
    stages adds the two per-event times."""
    kept = [(v[0] / v[1], v[1]) for k, v in times.items()
            if kernel_name in k and v[1]]
    if not kept:
        return None, 0
    return sum(t for t, _ in kept) / 1e3, min(n for _, n in kept)


# ---------------------------------------------------------------------------
# phase 2: paged decode attention against its plain version
# ---------------------------------------------------------------------------

def paged_operands(S, H, KV, hd, page, max_pages, lengths, seed,
                   dtype=torch.float32, q_scale=1.0):
    rng = np.random.default_rng(seed)
    P = 1 + S * max_pages                   # page 0 = scratch, never mapped
    q = q_scale * rng.standard_normal((S, H, hd), dtype=np.float32)
    kp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    table = rng.permutation(np.arange(1, P)).reshape(S, max_pages)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda().to(dtype)
            for a in (q, kp, vp)] + \
        [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in
         (table.astype(np.int32), np.asarray(lengths, np.int32))]


def decode_error(got, want, live):
    """(max |got - want| over live slots, max of that over its tier): 1e-5
    for float32; for bf16 the flash phase's rule, 2^-7 |plain| + 1e-3
    rms(plain) per element."""
    g, w = got[live].float(), want[live].float()
    err = (g - w).abs()
    if want.dtype == _BF16:
        tol = (FLASH_BF16_ULP * w.abs()
               + FLASH_BF16_RMS * float(w.pow(2).mean().sqrt()))
    else:
        tol = torch.full_like(w, KERNEL_ATOL)
    return float(err.max()), float((err / tol).max())


def decode_timed(kernel, label, shape, lengths, dtype, kw, seed):
    """Kernel (events and device), plain and SDPA ms at one shape, on pool
    copies that together exceed the L2, with the bound: the larger of the
    live rows' bytes in the pool's dtype and the arithmetic of the kernel
    that runs (float32 FMAs, or q.k once and P.V twice on the tensor
    cores in bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import kernel_for, launch_plan

    q, kp, vp, table, ln = paged_operands(lengths=lengths, dtype=dtype,
                                          seed=seed, **shape)
    n_copies = 1 + L2_BYTES // (2 * kp.numel() * kp.element_size())
    sets = [(q, kp, vp, table, ln)] + [
        (q, kp.clone(), vp.clone(), table, ln) for _ in range(n_copies - 1)]
    err, ratio = decode_error(kernel(*sets[0], **kw),
                              ref.paged_decode_attention_ref(*sets[0], **kw),
                              ln > 0)
    check(ratio <= 1.0, f"decode {label}: |kernel - plain| reaches {ratio} "
          f"x its tier (max abs {err})")
    kernel_ms = time_ms(lambda *a: kernel(*a, **kw), sets)
    plain_ms = time_ms(lambda *a: ref.paged_decode_attention_ref(*a, **kw),
                       sets[:1], iters=20)

    S, H, hd = q.shape
    KV, page = kp.shape[2], kp.shape[1]
    W = table.shape[1] * page
    pos = torch.arange(W, device="cuda")[None, :]
    valid = pos < ln.long()[:, None]
    if kw.get("window"):
        valid &= pos >= ln.long()[:, None] - kw["window"]

    def gathered(k, v):
        def g(pool):
            return pool[table.long()].reshape(S, W, KV, hd).transpose(1, 2)
        return q[:, :, None, :], g(k), g(v), valid[:, None, None, :]

    lib_sets = [gathered(k, v) for _, k, v, _, _ in sets[:2]]

    def sdpa(qq, kk, vv, mask):
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=H != KV)
    library_ms = time_ms(sdpa, lib_sets, iters=50)
    del lib_sets
    times, _, _, _ = device_times(lambda: [kernel(*sets[i % len(sets)], **kw)
                                           for i in range(40)])
    device_ms, n_ev = per_event_ms(times, "paged_decode")

    live = int(valid.sum())
    nbytes = (kp.element_size() * (2 * q.numel() + 2 * live * KV * hd)
              + 4 * (table.numel() + ln.numel()))
    flops = 4 * live * H * hd
    gtiles, splits, pages = launch_plan(
        S, H, KV, hd, kp.element_size(), page, table.shape[1],
        torch.cuda.get_device_properties(0).multi_processor_count)
    route = kernel_for(dtype, H // KV, hd, gtiles)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (1.5 * flops / BF16_FLOPS if route == "tc"
             else flops / F32_FLOPS)
    bound_ms = 1e3 * max(t_bytes, t_ops)
    del sets
    torch.cuda.empty_cache()
    return {
        "shape": {"S": S, "H": H, "KV": KV, "hd": hd, "page": page,
                  "max_pages": W // page, "dtype": str(dtype)[6:],
                  "lengths": lengths, **kw},
        "kernel": f"paged_decode_{route}",
        "splits": splits, "split_tokens": pages * page,
        "head_tiles": gtiles, "heads_per_block": -(-(H // KV) // gtiles),
        "max_abs_err": err, "max_err_over_tier": ratio,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
        "device_events": n_ev, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": nbytes, "bound_bytes_ms": 1e3 * t_bytes,
        "bound_flops": flops, "bound_ops_ms": 1e3 * t_ops,
        "share_of_bound": bound_ms / device_ms if device_ms else None,
        "library_ms": library_ms,
    }


def decode_attention_phase():
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_fwd as kernel
    from repro_torch.kernels.decode_attention import launch_plan, split_plan

    lengths = np.linspace(1, MAX_LEN, N_SLOTS).astype(int).tolist()
    g_shape = dict(S=N_SLOTS, H=32, KV=16, hd=128, page=PAGE,
                   max_pages=GEMMA_DECODE_LEN // PAGE)
    g_lengths = np.linspace(1, GEMMA_DECODE_LEN, N_SLOTS).astype(int).tolist()
    # a length-0 and a length-1 slot, and windows whose live range starts
    # inside a split (start = len - 4,096, split boundaries at multiples of
    # the split's tokens)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, pages = split_plan(g_shape["max_pages"], PAGE, N_SLOTS, 16, n_sm)
    tok = pages * PAGE
    edge = [0, 1, GEMMA_DECODE_LEN, 4096 + tok // 2, 4096 + tok + 3,
            2 * tok - 1, 2 * tok + 1, GEMMA_DECODE_LEN - 5]
    # phase 3b's own shape (max_len 640: 40 pages, fewer and shorter
    # splits), up to the longest slot it serves (512 prompt + 64 new
    # tokens) and either side of its split boundaries; q scaled so that the
    # cap at 50 binds (checked below)
    s_shape = dict(g_shape, max_pages=GEMMA_SERVE_MAX_LEN // PAGE)
    _, pages = split_plan(s_shape["max_pages"], PAGE, N_SLOTS, 16, n_sm)
    s_tok, s_max = pages * PAGE, sum(x[1] for x in (GEMMA_SERVE_PROMPT,
                                                     GEMMA_SERVE_NEW))
    s_lengths = np.linspace(1, s_max, N_SLOTS).astype(int).tolist()
    s_edge = [0, 1, s_tok - 1, s_tok, s_tok + 1, 2 * s_tok + 1, s_max,
              GEMMA_SERVE_MAX_LEN]
    # granite-20b's decode shape: one kv head for 48 query heads, all in
    # one block (the tensor-core kernel: bf16, 16 <= G <= 128); a
    # length-0 and a length-1 slot and one token either side of its split
    # boundaries
    gr_shape = dict(g_shape, H=48, KV=1)
    _, _, pages = launch_plan(N_SLOTS, 48, 1, 128, 2, PAGE,
                              gr_shape["max_pages"], n_sm)
    gr_tok = pages * PAGE
    gr_edge = [0, 1, gr_tok - 1, gr_tok + 1, 5 * gr_tok, 2 * tok + 1,
               GEMMA_DECODE_LEN - 3, GEMMA_DECODE_LEN]
    cases = [   # (name, shape, lengths, dtype, mask, q scale)
        ("serve", dict(S=N_SLOTS, H=12, KV=12, hd=64, page=PAGE,
                       max_pages=MAX_LEN // PAGE), lengths, _F32, {}, 1.0),
        ("gqa_softcap", dict(S=N_SLOTS, H=8, KV=2, hd=128, page=PAGE,
                             max_pages=MAX_LEN // PAGE), lengths, _F32,
         dict(attn_softcap=50.0), 1.0),
        ("gqa_window", dict(S=N_SLOTS, H=8, KV=2, hd=128, page=PAGE,
                            max_pages=MAX_LEN // PAGE), lengths, _F32,
         dict(window=64), 1.0),
        ("gemma2_global_bf16", g_shape, g_lengths, _BF16,
         dict(attn_softcap=50.0), 1.0),
        ("gemma2_local_bf16", g_shape, g_lengths, _BF16,
         dict(window=4096, attn_softcap=50.0), 1.0),
        ("gemma2_edges_local_bf16", g_shape, edge, _BF16,
         dict(window=4096, attn_softcap=50.0), 1.0),
        ("gemma2_edges_global_bf16", g_shape, edge, _BF16,
         dict(attn_softcap=50.0), 1.0),
        ("gemma2_serve_global_bf16", s_shape, s_lengths, _BF16,
         dict(attn_softcap=50.0), 8.0),
        ("gemma2_serve_local_bf16", s_shape, s_lengths, _BF16,
         dict(window=4096, attn_softcap=50.0), 8.0),
        ("gemma2_serve_edges_global_bf16", s_shape, s_edge, _BF16,
         dict(attn_softcap=50.0), 8.0),
        ("gemma2_serve_edges_local_bf16", s_shape, s_edge, _BF16,
         dict(window=4096, attn_softcap=50.0), 8.0),
        ("granite_mqa_bf16", gr_shape, g_lengths, _BF16, {}, 1.0),
        ("granite_mqa_edges_bf16", gr_shape, gr_edge, _BF16, {}, 1.0),
    ]
    errs = {}
    for i, (name, shape, lens, dt, kw, q_scale) in enumerate(cases):
        ops = paged_operands(lengths=lens, dtype=dt, seed=SEED + i,
                             q_scale=q_scale, **shape)
        got = kernel(*ops, **kw)
        want = ref.paged_decode_attention_ref(*ops, **kw)
        torch.cuda.synchronize()
        live = ops[4] > 0
        err, ratio = decode_error(got, want, live)
        errs[name] = {"max_abs_err": err, "max_err_over_tier": ratio}
        check(got.dtype == dt, f"{name}: output {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(bool((got[~live] == 0).all()), f"{name}: a length-0 slot is "
              "not 0")
        check(ratio <= 1.0, f"{name}: |kernel - plain| reaches {ratio} x "
              f"its tier (max abs {err})")
        if q_scale != 1.0:
            # the cap's effect on the plain output in units of the tier:
            # a kernel that dropped the cap would miss it by this much
            uncapped = ref.paged_decode_attention_ref(
                *ops, **{**kw, "attn_softcap": 0.0})
            _, effect = decode_error(uncapped, want, live)
            errs[name]["softcap_effect_over_tier"] = effect
            check(effect >= FLASH_CAP_EFFECT_MIN,
                  f"{name}: the softcap moves the output by only {effect} "
                  "x the tier")
            del uncapped
        del ops, got, want
    print(f"decode_attention error per case {json.dumps(errs)}", flush=True)

    timed = {
        "serve_100m_f32": decode_timed(
            kernel, "serve", cases[0][1], lengths, _F32, {}, SEED),
        "gemma2_global_bf16": decode_timed(
            kernel, "gemma2 global", g_shape, g_lengths, _BF16,
            dict(attn_softcap=50.0), SEED + 20),
        "gemma2_local_bf16": decode_timed(
            kernel, "gemma2 local", g_shape, g_lengths, _BF16,
            dict(window=4096, attn_softcap=50.0), SEED + 21),
        "granite_mqa_bf16": decode_timed(
            kernel, "granite", gr_shape, g_lengths, _BF16, {}, SEED + 22),
    }
    main = timed["serve_100m_f32"]
    return {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:99",
        "tpu_kernel": ("src/repro/kernels/decode_attention.py::"
                       "paged_decode_attention_fwd"),
        "launches": None,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "error_per_case": errs,
        "ms": main["ms"], "kernel_ms": main["kernel_ms"],
        "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": ("torch.nn.functional.scaled_dot_product_attention on "
                    "the already-gathered K/V with the length (and window) "
                    "mask, no softcap (gather excluded)"),
        "ms_is": ("CUDA events over back-to-back wrapper calls (host "
                  "wrapper included); device_ms: the kernel from "
                  "torch.profiler, per call"),
        "shape": main["shape"],
        "per_shape": timed,
    }


# ---------------------------------------------------------------------------
# phase 3: full-width serving
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps ``paged_decode_step``: keeps the first ``keep`` steps' logits
    (once ``on``) and a device-side all-finite flag, read after the run."""

    def __init__(self, step_fn, keep):
        self.step_fn, self.keep = step_fn, keep
        self.on, self.logits, self.finite = False, [], None

    def __call__(self, *args, **kw):
        logits, cache = self.step_fn(*args, **kw)
        if self.on:
            if len(self.logits) < self.keep:
                self.logits.append(logits.clone())
            ok = torch.isfinite(logits).all()
            self.finite = ok if self.finite is None else self.finite & ok
        return logits, cache


class DecodeCapture:
    """Wraps the model's decode-attention entry point: counts its calls and
    keeps a copy of the inputs (the pools as they are at that call) of the
    calls numbered in ``at``."""

    def __init__(self, fn, at):
        self.fn, self.at, self.calls, self.kept = fn, set(at), 0, []

    def __call__(self, q, k_pages, v_pages, page_table, lengths, **kw):
        if self.calls in self.at:
            self.kept.append(([t.clone() for t in (q, k_pages, v_pages,
                                                   page_table, lengths)], kw))
        self.calls += 1
        return self.fn(q, k_pages, v_pages, page_table, lengths, **kw)


def requests(vocab, n_requests=N_REQUESTS, prompt=(8, 128), new=(16, 64)):
    """(prompt tokens, max_new_tokens) per request from numpy seed SEED:
    prompt lengths and budgets uniform over the closed ranges given."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(n_requests):
        n = int(rng.integers(prompt[0], prompt[1] + 1))
        out.append((rng.integers(1, vocab, n).tolist(),
                    int(rng.integers(new[0], new[1] + 1))))
    return out


def serve_model(cfg, jobs, n_slots, page, max_len, compare, n_prof,
                capture_at=()):
    """Serve ``jobs`` through ``ServeEngine`` on the card, then the same
    weights and requests for CPU_STEPS steps on the CPU (plain versions);
    ``compare(card logits, cpu logits)`` returns the step's error and
    raises past its tier.  The decode-attention calls numbered in
    ``capture_at`` keep their inputs, on which the kernel is then held
    against its plain version (decode_error's tier).  Returns (record,
    decode kernel launches)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_fwd as kernel
    from repro_torch.kernels.decode_attention import launch_plan
    from repro_torch.models import attention, build_model
    from repro_torch.serve import ServeEngine

    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rec = Recorder(api.paged_decode_step, CPU_STEPS)
    eng = ServeEngine(api._replace(paged_decode_step=rec), params,
                      n_slots=n_slots, page_size=page, max_len=max_len)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    kernel.launches = 0
    rec.on = True
    cap = DecodeCapture(attention.paged_decode_attention, capture_at)
    attention.paged_decode_attention = cap
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        reqs = [eng.submit(p, m) for p, m in jobs]
        ends = []               # host clock after each step (ends in a sync)
        while eng.has_work:
            eng.step()
            ends.append(time.perf_counter() - t0)
            check(len(ends) < 10 * max_len * len(jobs),
                  "serve engine wedged")
        torch.cuda.synchronize()
    finally:
        attention.paged_decode_attention = cap.fn
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = np.diff([0.0] + ends) * 1e3
    ttft_ms = sorted(1e3 * ends[r.first_token_step] for r in reqs)
    launches = kernel.launches
    steps, generated = eng.real_steps, eng.generated_total

    check(all(r.done and len(r.generated) == m
              for r, (_, m) in zip(reqs, jobs)),
          f"{cfg.name}: a request did not finish with its token budget")
    check(bool(rec.finite), f"{cfg.name}: non-finite logits in the serve run")
    check(launches == steps * cfg.n_layers,
          f"{cfg.name}: kernel launches {launches} != {steps} steps x "
          f"{cfg.n_layers} layers")

    # the kernel on the kept inputs of the run; these launches compare and
    # do not count
    check(len(cap.kept) == len(capture_at), f"{cfg.name}: kept "
          f"{len(cap.kept)} of {len(capture_at)} decode calls")
    decode_checks = []
    for inputs, kw in cap.kept:
        got = kernel(*inputs, **kw)
        want = ops.paged_decode_attention(*inputs, backend="ref", **kw)
        err, ratio = decode_error(got, want, inputs[4] > 0)
        max_len_kept = int(inputs[4].max())
        check(ratio <= 1.0, f"{cfg.name}: on the inputs of serve call with "
              f"lengths up to {max_len_kept}, |kernel - plain| reaches "
              f"{ratio} x its tier (max abs {err})")
        decode_checks.append({"max_length": max_len_kept,
                              "max_abs_err": err,
                              "max_err_over_tier": ratio, **kw})
    kernel.launches = launches
    if decode_checks:
        q, k_pool, _, table, _ = cap.kept[0][0]
        _, _, pages = launch_plan(
            q.shape[0], q.shape[1], k_pool.shape[2], q.shape[2],
            q.element_size(), page, table.shape[1],
            torch.cuda.get_device_properties(0).multi_processor_count)
        check(max(c["max_length"] for c in decode_checks) > 2 * pages * page,
              f"{cfg.name}: no kept call fills three splits of "
              f"{pages * page} tokens")
    del cap

    # the same weights and requests through the port on the CPU
    cpu_api = build_model(cfg, device="cpu")
    cpu_params = copy.deepcopy(params).to("cpu")
    cpu_rec = Recorder(cpu_api.paged_decode_step, CPU_STEPS)
    cpu_eng = ServeEngine(cpu_api._replace(paged_decode_step=cpu_rec),
                          cpu_params, n_slots=n_slots, page_size=page,
                          max_len=max_len)
    cpu_rec.on = True
    for p, m in jobs:
        cpu_eng.submit(p, m)
    for _ in range(CPU_STEPS):
        cpu_eng.step()
    check(len(cpu_rec.logits) == CPU_STEPS == len(rec.logits),
          "fewer recorded steps than compared")
    logit_err = max(compare(i, g.cpu(), c) for i, (g, c) in
                    enumerate(zip(rec.logits, cpu_rec.logits)))
    del cpu_eng, cpu_params, cpu_api, cpu_rec

    # where a steady serve step's time goes: n_prof steps of fresh requests
    rec.on = False
    for p, m in jobs[:n_slots]:
        eng.submit(p, m)
    for _ in range(5):
        eng.step()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        times, api_calls, wall, _ = device_times(
            lambda: [eng.step() for _ in range(n_prof)])
    finally:
        smi.terminate()
        samples = smi.communicate()[0].split("\n")
    clocks = sorted(float(x.split(",")[0]) for x in samples if "," in x)
    busy_us = sum(v[0] for v in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    profile = {
        "steps": n_prof,
        "wall_ms_per_step_profiled": 1e3 * wall / n_prof,
        "device_busy_ms_per_step": busy_us / 1e3 / n_prof,
        "device_idle_share": (1 - busy_us / 1e6 / wall) if busy_us else None,
        "attention_kernel_ms_per_step": sum(
            v[0] for k, v in times.items()
            if "paged_decode" in k) / 1e3 / n_prof,
        "host_api_ms_per_step": {
            k: [v[0] / 1e3 / n_prof, v[1] / n_prof]
            for k, v in api_calls.items()},
        "sm_clock_mhz_median": (clocks[len(clocks) // 2] if clocks
                                else None),
        "top_device_ms_per_step": [
            [k[:90], v[0] / 1e3 / n_prof, v[1] / n_prof] for k, v in top],
    }
    del eng, params
    torch.cuda.empty_cache()

    prompt_tokens = sum(len(p) for p, _ in jobs)
    return {
        "model": cfg.name, "n_layers": cfg.n_layers, "n_params": n_params,
        "dtype": cfg.param_dtype, "init_s": init_s, "n_slots": n_slots,
        "page_size": page, "max_len": max_len, "requests": len(jobs),
        "prompt_tokens": prompt_tokens, "generated_tokens": generated,
        "real_steps": steps, "warmup_s": warmup_s, "run_s": run_s,
        "ms_per_step": 1e3 * run_s / steps,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p95": float(np.percentile(step_ms, 95)),
        "step_samples": len(step_ms),
        "ttft_ms_median": float(np.median(ttft_ms)),
        "ttft_ms_max": ttft_ms[-1],
        "tokens_per_s": generated / run_s,
        "fed_tokens_per_s": (prompt_tokens + generated) / run_s,
        "max_memory_allocated_gb": peak_gb,
        f"cpu_logit_err_first_{CPU_STEPS}_steps": logit_err,
        "decode_kernel_on_kept_serve_calls": decode_checks,
        "profile": profile,
    }, launches


def serve_phase():
    from repro_torch.configs import get_config

    def compare(i, g, c):
        err = float((g - c).abs().max())
        check(torch.allclose(g, c, atol=LOGIT_TOL, rtol=LOGIT_TOL),
              f"step {i}: card logits differ from the CPU's by {err}")
        return err

    cfg = get_config("transformer-100m")
    return serve_model(cfg, requests(cfg.vocab), N_SLOTS, PAGE, MAX_LEN,
                       compare, n_prof=20)


def cut_serve_phase(name, n_layers, why):
    """Phases 3b and 3c: ``name`` at full width, depth cut to
    ``n_layers``, served from pools in its own dtype (bf16) with phase
    3b's requests; card logits held to the CPU's in the Frobenius norm,
    and the decode kernel on the inputs of both layers at three steps
    spread over the run."""
    from repro_torch.configs import get_config

    def compare(i, g, c):
        rel = _rel(g, c)
        check(rel <= GEMMA_BF16_RTOL,
              f"{name} serve step {i}: card logits differ from the CPU's "
              f"by {rel} relative (Frobenius)")
        return rel

    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    jobs = requests(cfg.vocab, GEMMA_SERVE_REQUESTS, GEMMA_SERVE_PROMPT,
                    GEMMA_SERVE_NEW)
    at = [n_layers * step + layer for step in GEMMA_SERVE_KEEP_STEPS
          for layer in range(n_layers)]
    record, launches = serve_model(cfg, jobs, N_SLOTS, PAGE,
                                   GEMMA_SERVE_MAX_LEN, compare, n_prof=10,
                                   capture_at=at)
    record["reduced"] = {"n_layers": f"{full.n_layers} -> {n_layers} "
                                     f"({why}; every width kept)"}
    record["heads"] = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "head_dim": cfg.head_dim_}
    record["window"] = cfg.window
    record["logit_tier"] = ("||card - cpu|| / ||cpu|| <= "
                            f"{GEMMA_BF16_RTOL}")
    return record, launches


# ---------------------------------------------------------------------------
# phase 2b: the gossip update against its plain version
# ---------------------------------------------------------------------------

def _cuda_arrays(*arrays):
    return [None if a is None else
            torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def _bits_equal(a, b) -> bool:
    """Bitwise equality, NaN payloads included."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _max_err(a, b) -> float:
    d = (a - b).abs()
    both_nan = torch.isnan(a) & torch.isnan(b)
    return float(torch.where(both_nan, 0.0, d).nan_to_num(nan=float("inf"))
                 .max())


def gossip_cases():
    """The four cases of the gossip kernel's check, as (name, kwargs of
    ops.flat_gossip_update, rows that must come back bitwise unchanged)."""
    rng = np.random.default_rng(SEED)
    T_train, T = TRAIN_ROWS, CASE_ROWS

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    out = []
    # (a) the training shape: sync DPSGD, remote = w, a random matching
    n = TRAIN_LEARNERS
    w, g, mu = normal(n, T_train, 128), normal(n, T_train, 128), \
        normal(n, T_train, 128)
    partner = np.array([2, 3, 0, 1])
    coefs = np.tile([0.5, 0.5, 1.0, 1.0], (n, 1)).astype(np.float32)
    w, g, mu, p, c = _cuda_arrays(w, g, mu, partner[None].astype(np.int32),
                                  coefs)
    out.append(("a_train_shape", dict(w=w, remote=w, grads=g, momentum=mu,
                                      partners=p, coefs=c, lr=TRAIN_LR,
                                      beta=0.9), []))
    # (b) ring K=2, no momentum, weight decay; learner 4 inactive, its
    # weights and gradient NaN (its ring neighbours 3 and 5 read it)
    n = 8
    w, g = normal(n, T, 128), normal(n, T, 128)
    w[4], g[4] = np.nan, np.nan
    idx = np.arange(n)
    partners = np.stack([(idx + 1) % n, (idx - 1) % n]).astype(np.int32)
    active = np.ones(n)
    active[4] = 0.0
    coefs = np.concatenate([np.full((n, 3), 1.0 / 3.0),
                            np.linspace(0.5, 1.5, n)[:, None],
                            active[:, None]], axis=1).astype(np.float32)
    w, g, p, c = _cuda_arrays(w, g, partners, coefs)
    out.append(("b_ring_wd_nan", dict(w=w, remote=w, grads=g, momentum=None,
                                      partners=p, coefs=c, lr=0.1,
                                      weight_decay=1e-4), [4]))
    # (c) AD-PSGD publish mode, K=1, active / nbr_fresh / publish mixed
    n = 8
    w, g, mu, buf = (normal(n, T, 128) for _ in range(4))
    partner = np.array([1, 0, 3, 2, 5, 4, 7, 6])
    active = np.array([0, 1, 1, 1, 0, 1, 1, 1], np.float32)
    fresh = np.array([0, 1, 1, 0, 0, 0, 1, 1], np.float32)
    coefs = np.concatenate(
        [np.tile([0.5, 0.5], (n, 1)), np.ones((n, 1)), active[:, None],
         fresh[partner][:, None], np.maximum(active, fresh)[:, None]],
        axis=1).astype(np.float32)
    w, g, mu, buf, p, c = _cuda_arrays(w, g, mu, buf,
                                       partner[None].astype(np.int32), coefs)
    out.append(("c_publish", dict(w=w, remote=w, grads=g, momentum=mu,
                                  partners=p, coefs=c, lr=0.1, beta=0.9,
                                  buffer=buf), [0, 4]))
    # (d) a mixing-only round: lr = 0, K = 3 (the exponential graph, n=8)
    from repro_torch.core.schedule import make_schedule
    sched = make_schedule("exp", n)
    (partners, mix), = sched.step_rounds(None, 0)
    w = normal(n, T, 128)
    coefs = np.concatenate([mix.numpy(), np.ones((n, 2))],
                           axis=1).astype(np.float32)
    w, p, c = _cuda_arrays(w, partners.numpy(), coefs)
    out.append(("d_mix_only_exp", dict(w=w, remote=w, grads=w, momentum=None,
                                       partners=p, coefs=c, lr=0.0), []))
    return out


def gossip_phase():
    from repro_torch.kernels import ops
    from repro_torch.kernels.gossip_mix import gossip_mix_update_flat

    errs, cases = {}, gossip_cases()
    for name, kw, frozen in cases:
        mu = kw["momentum"]
        buf = kw.get("buffer")
        plain_kw = dict(kw, momentum=None if mu is None else mu.clone())
        want = ops.flat_gossip_update(**plain_kw, backend="ref")
        before = gossip_mix_update_flat.launches
        got = ops.flat_gossip_update(**dict(kw, momentum=None if mu is None
                                            else mu.clone()), backend="cuda")
        torch.cuda.synchronize()
        check(gossip_mix_update_flat.launches == before + 1,
              f"{name}: the kernel did not launch")
        err = 0.0
        for a, b in zip(got, want):
            if a is None:
                continue
            err = max(err, _max_err(a, b))
            check(_bits_equal(a, b) or err <= GOSSIP_ATOL,
                  f"{name}: max |kernel - plain| {err} > {GOSSIP_ATOL}")
        for r in frozen:             # inactive rows come back unchanged
            check(_bits_equal(got[0][r], kw["w"][r]),
                  f"{name}: inactive learner {r} changed")
            if buf is not None and not bool(kw["coefs"][r, -1] > 0.5):
                check(_bits_equal(got[2][r], buf[r]),
                      f"{name}: learner {r} published")
        if name == "b_ring_wd_nan":
            far = [i for i in range(8) if i not in (3, 4, 5)]
            check(bool(torch.isfinite(got[0][far]).all()),
                  f"{name}: NaN leaked past the ring neighbours")
        errs[name] = err
    print(f"gossip_mix max_abs_err per case {json.dumps(errs)}", flush=True)

    # timing at the training shape: each buffer alone is 43x the L2
    _, kw, _ = cases[0]
    del cases
    out = torch.empty_like(kw["w"])

    def kernel(**k):
        return gossip_mix_update_flat(
            k["w"], k["remote"], k["grads"], k["momentum"], k["partners"],
            k["coefs"], lr=k["lr"], beta=k["beta"], out=out)

    def plain(**k):
        from repro_torch.kernels import ref
        return ref.gossip_mix_update_flat_ref(
            k["w"], k["remote"], k["grads"], k["momentum"], k["partners"],
            k["coefs"], lr=k["lr"], beta=k["beta"])

    kernel_ms = time_ms(lambda: kernel(**kw), [()], iters=50)
    plain_ms = time_ms(lambda: plain(**kw), [()], iters=5)
    times, _, _, _ = device_times(lambda: [kernel(**kw)
                                           for _ in range(20)])
    dev = [v for k, v in times.items() if "gossip_mix_kernel" in k]
    device_ms = dev[0][0] / dev[0][1] / 1e3 if dev else None

    w = kw["w"]
    # distinct tensors the function must read once and write once: w (also
    # the remote), g and mu in; w' and mu out
    nbytes = 5 * w.numel() * 4 + kw["partners"].numel() * 4 + \
        kw["coefs"].numel() * 4
    flops = 6 * w.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    n, T, _ = w.shape
    return {
        "name": "gossip_mix_update_flat",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:252",
        "tpu_kernel": "src/repro/kernels/gossip_mix.py::"
                      "gossip_mix_update_flat",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": nbytes,
        "library_ms": None,
        "library": ("none: no single PyTorch call computes a neighbour "
                    "gather, a momentum update and a masked select in one "
                    "pass"),
        "shape": {"n": n, "T": T, "K": 1, "momentum": True,
                  "remote": "w"},
    }


# ---------------------------------------------------------------------------
# phase 2c: the reorthogonalization kernels against their plain versions
# ---------------------------------------------------------------------------

def reorth_operands(M, T, live, seed, orthonormal=False):
    """(basis, w, mask) on the card: unit basis rows (a QR's orthonormal
    rows when asked; random rows are orthogonal to ~1/sqrt(T * 128)), and a
    candidate w with large components along the live rows, as a Lanczos
    candidate has."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if orthonormal:
        q, _ = torch.linalg.qr(torch.randn((T * 128, M), device="cuda",
                                           generator=gen))
        basis = q.t().contiguous().view(M, T, 128)
    else:
        basis = torch.randn((M, T, 128), device="cuda", generator=gen)
        basis /= torch.linalg.norm(basis.view(M, -1), dim=1)[:, None, None]
    w = torch.randn((T, 128), device="cuda", generator=gen)
    coef = torch.linalg.norm(w) * torch.linspace(1.0, 3.0, M, device="cuda")
    w += torch.einsum("m,mtl->tl", coef, basis)
    mask = (torch.arange(M, device="cuda") < live).float()
    return basis, w, mask


def reorth_phase():
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.reorth import reorth_axpy, reorth_dots

    cases = [("probe_100m", REORTH_M, TRAIN_ROWS, REORTH_M, False),
             ("ragged_T", 5, 100_003, 5, False),
             ("m1", 1, CASE_ROWS, 1, False),
             ("partial_mask", 6, CASE_ROWS, 3, False),
             ("orthonormal_qr", 8, 8_191, 8, True)]
    errs = {}
    for i, (name, M, T, live, ortho) in enumerate(cases):
        basis, w, mask = reorth_operands(M, T, live, SEED + i, ortho)
        before = (reorth_dots.launches, reorth_axpy.launches)
        d_k = reorth_dots(basis, w, mask)
        d_p = ref.reorth_dots_ref(basis, w, mask)
        w_k = reorth_axpy(w, basis, d_p)
        w_p = ref.reorth_axpy_ref(w, basis, d_p)
        w2 = ops.reorthogonalize(basis, w, mask)
        torch.cuda.synchronize()
        check((reorth_dots.launches, reorth_axpy.launches)
              == (before[0] + 3, before[1] + 3),
              f"{name}: the reorth kernels did not launch")
        scale = torch.linalg.norm(basis.view(M, -1), dim=1) * \
            torch.linalg.norm(w)
        dots_err = float(((d_k - d_p).abs() / scale).max())
        axpy_err = _max_err(w_k, w_p)
        resid = float((torch.einsum("mtl,tl->m", basis, w2) * mask)
                      .abs().max() / torch.linalg.norm(w2))
        errs[name] = {"M": M, "T": T, "live": live,
                      "dots_err_rel_to_norms": dots_err,
                      "axpy_max_abs_diff": axpy_err,
                      "cgs2_residual_rel": resid}
        check(bool(torch.isfinite(w2).all()), f"{name}: non-finite CGS2")
        check(dots_err <= REORTH_DOTS_RTOL,
              f"{name}: dots differ by {dots_err} of ||v|| ||w|| > "
              f"{REORTH_DOTS_RTOL}")
        check(_bits_equal(w_k, w_p) and axpy_err <= REORTH_AXPY_ATOL,
              f"{name}: axpy differs from its plain version by {axpy_err}")
        check(resid < REORTH_RESIDUAL,
              f"{name}: CGS2 residual {resid} of ||w|| >= {REORTH_RESIDUAL}")
        if name != "probe_100m":
            del basis, w, mask, d_k, d_p, w_k, w_p, w2
    print(f"reorth per case {json.dumps(errs)}", flush=True)

    # timing at the probe shape: each vector (541 MB) is 10x the L2
    basis, w, mask = reorth_operands(REORTH_M, TRAIN_ROWS, REORTH_M, SEED)
    M, T, _ = basis.shape
    dots = ref.reorth_dots_ref(basis, w, mask)
    out = torch.empty_like(w)
    flat_b, flat_w = basis.view(M, -1), w.view(-1)
    timed = {
        "reorth_dots": (lambda: reorth_dots(basis, w, mask),
                        lambda: ref.reorth_dots_ref(basis, w, mask),
                        lambda: torch.mv(flat_b, flat_w)),
        "reorth_axpy": (lambda: reorth_axpy(w, basis, dots, out=out),
                        lambda: ref.reorth_axpy_ref(w, basis, dots),
                        lambda: torch.addmv(flat_w, flat_b.t(), dots,
                                            alpha=-1)),
    }
    times, _, _, _ = device_times(lambda: [
        (reorth_dots(basis, w, mask), reorth_axpy(w, basis, dots, out=out))
        for _ in range(20)])
    # per call: both stages of the dots, each over its own events
    dev = {name: per_event_ms(times, name)
           for name in ("reorth_dots", "reorth_axpy")}
    vec = T * 128 * 4
    need = {   # bytes each function must move, flops it must do
        "reorth_dots": ((M + 1) * vec + 2 * M * 4, 2 * M * T * 128),
        "reorth_axpy": ((M + 2) * vec + M * 4, 2 * M * T * 128),
    }
    library = {
        "reorth_dots": "torch.mv(basis.view(M, -1), w.view(-1)) (cuBLAS; "
                       "no mask)",
        "reorth_axpy": "torch.addmv(w.view(-1), basis.view(M, -1).t(), "
                       "dots, alpha=-1) (cuBLAS)",
    }
    records = []
    for name, (kern, plain, lib) in timed.items():
        nbytes, flops = need[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        kernel_ms = time_ms(kern, [()], iters=20)
        records.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/reorth.cu",
            "replaces": ("src/repro/kernels/reorth.py:90" if name ==
                         "reorth_dots" else
                         "src/repro/kernels/reorth.py:118"),
            "tpu_kernel": f"src/repro/kernels/reorth.py::{name}",
            "launches": None,
            "max_abs_err": max(
                e["dots_err_rel_to_norms"] if name == "reorth_dots"
                else e["axpy_max_abs_diff"] for e in errs.values()),
            "max_abs_err_is": ("max |kernel - plain| / (||v_k|| ||w||)"
                               if name == "reorth_dots" else
                               "max |kernel - plain| given the same dots"),
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "device_ms": dev[name][0],
            "device_events": dev[name][1],
            "plain_ms": time_ms(plain, [()], iters=5),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes,
            "library_ms": time_ms(lib, [()], iters=20),
            "library": library[name],
            "shape": {"M": M, "T": T, "live": REORTH_M},
        })
    return records


# ---------------------------------------------------------------------------
# phase 4: full-width training
# ---------------------------------------------------------------------------

def _train_100m_trainer(api, backend):
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.optim import scale_by_schedule, sgd, warmup_linear_scale
    opt = scale_by_schedule(sgd(TRAIN_LR, momentum=0.9),
                            warmup_linear_scale(10, 1.0))
    return MultiLearnerTrainer(
        api.loss_fn, opt,
        AlgoConfig(algo="dpsgd", topology="random_pair",
                   n_learners=TRAIN_LEARNERS),
        alpha_for_diag=TRAIN_LR, kernel_backend=backend,
        params_from_tree=api.params_from_tree)


def train_100m(kernels, warm, timed, prof, use_pallas=False,
               keep_after_warm=False):
    """Train transformer-100m with phase 4's recipe for ``warm`` warm-up,
    ``timed`` timed and ``prof`` profiled steps, every launch count set to
    0 just before the first; checks that every loss is finite and that the
    gossip kernel launched once per round.  Returns the run's pieces, with
    a copy of the store after the warm-up when ``keep_after_warm``."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("transformer-100m"),
                              use_pallas=use_pallas)
    api = build_model(cfg)
    tree = api.param_tree(api.init(SEED))
    steps = warm + timed + prof
    loader = ShardedLoader(SyntheticTokenStream(vocab=cfg.vocab),
                           n_learners=TRAIN_LEARNERS,
                           local_batch=TRAIN_BATCH, extra_args=(TRAIN_SEQ,),
                           seed=SEED)
    t0 = time.perf_counter()
    batches = [loader.batch(i) for i in range(steps)]     # set-up, not timed
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0

    trainer = _train_100m_trainer(api, "auto")
    state = trainer.init(SEED, tree)
    check(state.params.shape[1] == TRAIN_ROWS,
          f"the flat store has {state.params.shape[1]} rows, the gossip "
          f"check ran at {TRAIN_ROWS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    metrics = []

    def run(lo, hi):
        nonlocal state
        for i in range(lo, hi):
            state, m = trainer.train_step(state, batches[i])
            metrics.append(m)

    run(0, warm)
    after_warm = state.params.clone() if keep_after_warm else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(warm, warm + timed)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / timed
    times, api_calls, wall, host = device_times(
        lambda: run(warm + timed, steps))
    launches = {k.__name__: k.launches for k in kernels}

    losses = torch.stack([m.loss for m in metrics]).tolist()
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(launches["gossip_mix_update_flat"] == steps
          * trainer.rounds_per_step,
          f"gossip kernel launches {launches['gossip_mix_update_flat']} != "
          f"{steps} steps x {trainer.rounds_per_step} rounds")
    tokens = TRAIN_LEARNERS * TRAIN_BATCH * TRAIN_SEQ
    return SimpleNamespace(
        cfg=cfg, api=api, tree=tree, loader=loader, batches=batches,
        trainer=trainer, state=state, metrics=metrics, losses=losses,
        after_warm=after_warm, steps=steps, data_s=data_s,
        step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
        launches=launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=train_profile(times, api_calls, wall, host, prof))


def train_profile(times, api_calls, wall, host, n):
    """Per-step figures of ``n`` profiled steps from ``device_times``."""
    busy_us = sum(v[0] for v in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:10]
    out = {
        "steps": n,
        "wall_ms_per_step_profiled": 1e3 * wall / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": (1 - busy_us / 1e6 / wall) if busy_us
        else None,
        "top_device_ms_per_step": [
            [k[:90], v[0] / 1e3 / n, v[1] / n] for k, v in top],
        "device_kernels_per_step": sum(v[1] for v in times.values()) / n,
        "host_api_ms_per_step": {
            k: [v[0] / 1e3 / n, v[1] / n] for k, v in api_calls.items()},
        "top_host_self_ms_per_step": [
            [k[:60], v[0] / 1e3 / n, v[1] / n] for k, v in top_host],
    }
    for label, name in (("gossip_kernel", "gossip_mix_kernel"),
                        ("flash_kernel", "flash_attention")):
        k_us = sum(v[0] for k, v in times.items() if name in k)
        out[f"{label}_ms_per_step"] = k_us / 1e3 / n
        out[f"{label}_share_of_device"] = k_us / busy_us if busy_us else None
    return out


def train_phase(kernels):
    run = train_100m(kernels, WARM_STEPS, TIMED_STEPS, PROF_STEPS,
                     keep_after_warm=True)
    launches = run.launches
    check(all(v == 0 for k, v in launches.items()
              if k != "gossip_mix_update_flat"),
          f"the training path launched another path's kernel: {launches}")
    n_params = sum(t.numel() for t in _leaves(run.tree))
    sigma = float(run.metrics[-1].sigma_w_sq)
    probe, probe_launches = probe_phase(run.trainer, run.state, run.api,
                                        run.loader, kernels)
    del run.trainer, run.state, run.metrics
    torch.cuda.empty_cache()

    # the same first steps through the plain version on the card
    ref_trainer = _train_100m_trainer(run.api, "ref")
    ref_state = ref_trainer.init(SEED, run.tree)
    for i in range(REF_STEPS):
        ref_state, _ = ref_trainer.train_step(ref_state, run.batches[i])
    ref_err = float((ref_state.params - run.after_warm).abs().max())
    check(ref_err <= TRAIN_REF_ATOL,
          f"kernel and plain training differ by {ref_err} after "
          f"{REF_STEPS} steps")
    del ref_trainer, ref_state, run.after_warm
    torch.cuda.empty_cache()

    return {
        "model": run.cfg.name, "n_params": n_params,
        "learners": TRAIN_LEARNERS, "local_batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "algo": "dpsgd", "topology": "random_pair",
        "lr": TRAIN_LR, "steps": run.steps, "data_setup_s": run.data_s,
        "ms_per_step": run.step_ms, "timed_steps": TIMED_STEPS,
        "tokens_per_s": run.tokens_per_s,
        "profile": run.profile,
        "max_memory_allocated_gb": run.peak_gb,
        "losses": run.losses, "sigma_w_sq": sigma,
        "kernel_launches": launches,
        "ref_backend_max_abs_diff_after_2_steps": ref_err,
    }, launches["gossip_mix_update_flat"], probe, probe_launches


def probe_phase(trainer, state, api, loader, kernels):
    """The full-width landscape probe on the trained state, through the
    trainer's probe seam, then the same probe with the plain reorth and
    ``trainer.diagnostics``.  Returns (record, {kernel: launches})."""
    from repro_torch.kernels.reorth import reorth_axpy, reorth_dots
    from repro_torch.landscape import ProbeSchedule, make_trainer_probe

    def probe_fn(reorth):
        return make_trainer_probe(
            api.loss_fn, alpha=TRAIN_LR, lanczos_iters=PROBE_ITERS,
            hutchinson_samples=PROBE_SAMPLES, seed=SEED, reorth=reorth,
            params_from_tree=api.params_from_tree)

    batch = loader.batch(10_000)        # the superbatch, 4 x 2 x 512 tokens
    trainer.add_probe("landscape", ProbeSchedule(every=1), probe_fn("auto"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu,clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        state, results = trainer.run_probes(state, batch, step=state.step)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
    finally:
        smi.terminate()
        samples = smi.communicate()[0].split("\n")
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.hooks.clear()
    res = results["landscape"]
    util = [float(x.split(",")[0]) for x in samples if "," in x]
    clocks = sorted(float(x.split(",")[1]) for x in samples if "," in x)

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    ref_res = probe_fn("ref")(trainer.state_view(state), batch)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_launches = {k.__name__: k.launches for k in kernels}

    t0 = time.perf_counter()
    diag = trainer.diagnostics(state, batch)
    torch.cuda.synchronize()
    diag_s = time.perf_counter() - t0

    fields = {f: float(v) for f, v in res._asdict().items()}
    ref_fields = {f: float(v) for f, v in ref_res._asdict().items()}
    diag_fields = {f: float(v) for f, v in diag._asdict().items()}
    check(all(np.isfinite(list(fields.values()))),
          f"non-finite probe result {fields}")
    check(all(np.isfinite(list(diag_fields.values()))),
          f"non-finite diagnostics {diag_fields}")
    rel = abs(fields["sharpness"] - ref_fields["sharpness"]) / abs(
        ref_fields["sharpness"])
    check(rel <= PROBE_RTOL,
          f"probe sharpness {fields['sharpness']} differs from the plain "
          f"reorth run's {ref_fields['sharpness']} by {rel} relative")
    want = 2 * PROBE_ITERS          # two CGS sweeps per Lanczos step
    check(launches["reorth_dots"] == want == launches["reorth_axpy"],
          f"reorth launches in the probe {launches}, want {want} each")
    check(ref_launches["reorth_dots"] == 0 == ref_launches["reorth_axpy"],
          f"the reorth='ref' probe launched a kernel: {ref_launches}")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("reorth_dots", "reorth_axpy")),
          f"the probe launched another path's kernel: {launches}")
    busy = float(np.mean(util)) / 100 if util else None
    return {
        "model": api.cfg.name, "superbatch": [TRAIN_LEARNERS, TRAIN_BATCH,
                                              TRAIN_SEQ],
        "lanczos_iters": PROBE_ITERS, "hutchinson_samples": PROBE_SAMPLES,
        "step": state.step,
        "wall_s_per_probe": probe_s,
        "device_busy_share": busy,
        "device_idle_share": None if busy is None else 1 - busy,
        "busy_from": "nvidia-smi utilization.gpu, 100 ms samples over the "
                     "probe",
        "busy_samples": len(util),
        "sm_clock_mhz_median": clocks[len(clocks) // 2] if clocks else None,
        "max_memory_allocated_gb": peak_gb,
        "result": fields,
        "ref_reorth_result": ref_fields, "ref_reorth_wall_s": ref_s,
        "sharpness_rel_diff_vs_ref_reorth": rel,
        "diagnostics": diag_fields, "diagnostics_wall_s": diag_s,
        "kernel_launches": launches,
        "ref_reorth_kernel_launches": ref_launches,
    }, launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# phase 5: the FC net — the paper's experiment and the other modes
# ---------------------------------------------------------------------------

def _fc_pair(algo, topology, opt_fn, steps, n, **kw):
    """The same FC-net run with the kernel and with the plain version;
    returns (max |param diff|, max |buffer diff| or None, final loss)."""
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.data import ShardedLoader, TemplateImages
    from repro_torch.models import fcnet

    loader = ShardedLoader(TemplateImages(), n_learners=n, local_batch=64,
                           seed=SEED)
    init = fcnet.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    out = {}
    for backend in ("cuda", "ref"):
        tr = MultiLearnerTrainer(fcnet.loss_fn, opt_fn(),
                                 AlgoConfig(algo=algo, topology=topology,
                                            n_learners=n, **kw),
                                 kernel_backend=backend)
        st = tr.init(SEED, init)
        for i in range(steps):
            st, m = tr.train_step(st, loader.batch(i))
        out[backend] = (st.params.clone(),
                        None if st.buffer is None else st.buffer.clone(),
                        float(m.loss))
    (pk, bk, loss), (pr, br, _) = out["cuda"], out["ref"]
    perr = float((pk - pr).abs().max())
    berr = None if bk is None else float((bk - br).abs().max())
    return perr, berr, loss


def fc_phase(kernels):
    from repro_torch import quickstart
    from repro_torch.optim import sgd

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    ssgd = quickstart.train("ssgd", log_every=0)
    dpsgd = quickstart.train("dpsgd", log_every=0)
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    check(np.isfinite(dpsgd).all(), "non-finite DPSGD loss in the "
          "quickstart twin")
    check(dpsgd[-1] < ssgd[-1],
          f"quickstart twin: DPSGD {dpsgd[-1]} did not end below SSGD "
          f"{ssgd[-1]} (paper Fig. 2a)")
    full_err, _, full_loss = _fc_pair(
        "dpsgd", "full",
        lambda: sgd(0.1, momentum=0.9, weight_decay=1e-3), 5, 4)
    ad_err, ad_buf_err, ad_loss = _fc_pair(
        "adpsgd", "random_pair", lambda: sgd(0.1, momentum=0.9), 6, 4,
        slow_learner=0, slow_factor=2, max_staleness=1)
    for name, err in (("full", full_err), ("adpsgd", ad_err),
                      ("adpsgd buffer", ad_buf_err)):
        check(err <= TRAIN_REF_ATOL,
              f"FC net {name}: kernel and plain differ by {err}")
    return {
        "quickstart": {"ssgd_final_loss": ssgd[-1],
                       "dpsgd_final_loss": dpsgd[-1],
                       "ssgd_loss_every_20": ssgd[::20],
                       "dpsgd_loss_every_20": dpsgd[::20],
                       "wall_s_both": quick_s},
        "full_n4_momentum_wd": {"max_abs_diff_vs_ref": full_err,
                                "final_loss": full_loss},
        "adpsgd_straggler": {"max_abs_diff_vs_ref": ad_err,
                             "buffer_max_abs_diff_vs_ref": ad_buf_err,
                             "final_loss": ad_loss},
        "kernel_launches": {k.__name__: k.launches for k in kernels},
    }


# ---------------------------------------------------------------------------
# phase 6: Table 1 at the largest batch — SSGD, DPSGD, SSGD+AutoLR
# ---------------------------------------------------------------------------

def table1_phase(kernels):
    from repro_torch.bench.table1_large_batch import run_cell
    from repro_torch.kernels.reorth import reorth_axpy, reorth_dots

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    cells = {a: run_cell(a, TABLE1_SCALE, steps=TABLE1_STEPS)
             for a in ("ssgd", "dpsgd", "ssgd_autolr")}
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    n_probes = len(cells["ssgd_autolr"]["probes"])
    for k in kernels:
        k.launches = 0
    ref = run_cell("ssgd_autolr", TABLE1_SCALE, steps=TABLE1_STEPS,
                   probe_kwargs={"reorth": "ref"})
    ref_launches = {k.__name__: k.launches for k in kernels}

    final = {a: c["final_loss"] for a, c in cells.items()}
    auto = cells["ssgd_autolr"]
    scales = [s for _, s in auto["scales"]]
    sharp = [float(r.sharpness) for _, r in auto["probes"]]
    ref_sharp = [float(r.sharpness) for _, r in ref["probes"]]
    first_rel = abs(sharp[0] - ref_sharp[0]) / abs(ref_sharp[0])
    check(np.isfinite(final["ssgd_autolr"]) and final["ssgd_autolr"] < 1e-2,
          f"SSGD+AutoLR final loss {final['ssgd_autolr']} is not below 1e-2")
    check(not np.isfinite(final["ssgd"]) or final["ssgd"] > 1.0,
          f"SSGD final loss {final['ssgd']} did not fail (> 1)")
    check(np.isfinite(final["dpsgd"]) and final["dpsgd"] < 1e-2,
          f"DPSGD final loss {final['dpsgd']} did not converge")
    check(min(scales) < 1.0, f"the controller never clamped: {scales}")
    check(launches["reorth_dots"] == 2 * 8 * n_probes
          == launches["reorth_axpy"] > 0,
          f"reorth launches {launches} for {n_probes} probes")
    check(ref_launches["reorth_dots"] == 0 == ref_launches["reorth_axpy"],
          f"the reorth='ref' run launched a kernel: {ref_launches}")
    check(first_rel <= PROBE_RTOL,
          f"first probe sharpness {sharp[0]} (kernels) vs {ref_sharp[0]} "
          f"(plain): {first_rel} relative")
    check(np.isfinite(ref["final_loss"]) and ref["final_loss"] < 1e-2,
          f"SSGD+AutoLR with reorth='ref' ended at {ref['final_loss']}")
    return {
        "nB": auto["nB"], "lr": auto["lr"], "steps": TABLE1_STEPS,
        "landscape_every": 10,
        "final_loss": final,
        "ssgd_autolr_scales": auto["scales"],
        "ssgd_autolr_sharpness": sharp,
        "ref_reorth": {"final_loss": ref["final_loss"],
                       "scales": ref["scales"], "sharpness": ref_sharp,
                       "kernel_launches": ref_launches},
        "first_probe_sharpness_rel_diff": first_rel,
        "us_per_step": {a: c["us_per_step"] for a, c in cells.items()},
        "wall_s_three_cells": wall_s,
        "kernel_launches": launches,
    }


# ---------------------------------------------------------------------------
# phase 2d: flash attention against its plain version
# ---------------------------------------------------------------------------

def flash_operands(B, H, KV, hd, Sq, dtype, seed, Sk=None, q_scale=1.0):
    """q (B, H, Sq, hd), k, v (B, KV, Sk, hd) on the card, as the model
    passes them: ``transpose(1, 2)`` views of (B, S, heads, hd) tensors
    drawn from a seeded numpy RNG, q times ``q_scale``."""
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    out = []
    for S, n, c in ((Sq, H, q_scale), (Sk, KV, 1.0), (Sk, KV, 1.0)):
        a = c * rng.standard_normal((B, S, n, hd), dtype=np.float32)
        out.append(torch.from_numpy(a).cuda().to(dtype).transpose(1, 2))
    return out


def flash_error(got, want, Sq):
    """(max |got - want|, max of |got - want| over its tolerance): the
    float32 tiers by length, or one bf16 ulp of the plain value plus
    1e-3 rms of the plain output; the kernel is within tier when the
    second is <= 1."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == _BF16:
        tol = (FLASH_BF16_ULP * w.abs()
               + FLASH_BF16_RMS * float(w.pow(2).mean().sqrt()))
    else:
        tol = FLASH_ATOL_F32_SHORT if Sq <= 256 else FLASH_ATOL_F32
    return float(err.max()), float((err / tol).max())


def live_pairs(Sq, Sk, causal, window) -> int:
    """(q, k) pairs the masks leave live, positions contiguous from 0."""
    qpos = np.arange(Sq)[:, None]
    lo = np.zeros((Sq, 1), np.int64)
    hi = np.full((Sq, 1), Sk - 1)
    if causal:
        hi = np.minimum(hi, qpos)
    if window:
        lo = np.maximum(lo, qpos - window + 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_phase():
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import \
        flash_attention_fwd as kernel
    from repro_torch.kernels.flash_attention import kernel_for

    errs = {}
    for i, (name, B, H, KV, hd, Sq, dt, kw, Sk, q_scale) in enumerate(
            FLASH_CASES):
        q, k, v = flash_operands(B, H, KV, hd, Sq, dt, SEED + i, Sk, q_scale)
        before = kernel.launches
        got = kernel(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{name}: no launch")
        check(got.dtype == dt and got.shape == q.shape,
              f"{name}: output {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err, ratio = flash_error(got, want, Sq)
        errs[name] = {"max_abs_err": err, "max_err_over_tol": ratio}
        check(ratio <= 1.0, f"{name}: |kernel - plain| reaches {ratio} x "
              f"its tolerance (max abs {err})")
        if kw.get("attn_softcap") and dt == _F32 and q_scale != 1.0:
            uncapped = ref.flash_attention_ref(
                q, k, v, **{**kw, "attn_softcap": 0.0})
            effect = float((uncapped - want).abs().max()) / (
                FLASH_ATOL_F32_SHORT if Sq <= 256 else FLASH_ATOL_F32)
            errs[name]["softcap_effect_over_tol"] = effect
            check(effect >= FLASH_CAP_EFFECT_MIN,
                  f"{name}: the softcap moves the output by only {effect} "
                  f"x the tolerance")
            del uncapped
        del q, k, v, got, want
    torch.cuda.empty_cache()
    print(f"flash_attention error per case {json.dumps(errs)}", flush=True)

    timed = {}
    for j, (label, (B, H, KV, hd, S, dt, kw, lib)) in enumerate(
            FLASH_TIMED.items()):
        q, k, v = flash_operands(B, H, KV, hd, S, dt, SEED + 10 + j)
        per_set = 4 * q.element_size() * q.numel()      # q, k, v, out
        sets = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                              for _ in range(L2_BYTES // per_set)]
        big = S > 1024
        kernel_ms = time_ms(lambda a, b, c: kernel(a, b, c, **kw), sets,
                            iters=10 if big else 100)
        plain_ms = time_ms(lambda a, b, c: ref.flash_attention_ref(
            a, b, c, **kw), sets[:1], iters=2 if big else 20)
        err, ratio = flash_error(kernel(q, k, v, **kw),
                                 ref.flash_attention_ref(q, k, v, **kw), S)
        check(ratio <= 1.0, f"{label}: |kernel - plain| reaches {ratio} x "
              f"its tolerance (max abs {err})")
        errs[label] = {"max_abs_err": err, "max_err_over_tol": ratio}
        library_ms = None
        if lib:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = time_ms(lambda a, b, c: sdpa(a, b, c, is_causal=True),
                                 sets, iters=100)
        times, _, _, _ = device_times(
            lambda: [kernel(*sets[i % len(sets)], **kw) for i in range(10)])
        device_ms, n_ev = per_event_ms(times, "flash_attention")
        pairs = live_pairs(S, S, kw.get("causal", True), kw.get("window", 0))
        # the tensor-core kernel (bf16 at hd 64 / 128): q.k one bf16 pass,
        # P.V two (P = hi + lo in bf16), all at the tensor cores' bf16
        # rate; the float32 kernel: q.k in float32 FMAs, P.V in three TF32
        # passes (two for bf16 V), on the tensor cores at the same time as
        # the FMAs, so the slower of the two; beside it, both halves at
        # the float32 rate (the bound of the FMA kernel it replaced)
        half = 2 * hd * pairs * B * H
        flops = 2 * half
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        t_bytes = nbytes / HBM_BYTES_PER_S
        route = kernel_for(dt, hd)
        parts = ({"qk_pv_bf16_tensor_cores": 3 * half / BF16_FLOPS}
                 if route == "tc" else
                 {"qk_f32_fma": half / F32_FLOPS,
                  "pv_tf32_tensor_cores":
                      (2 if dt == _BF16 else 3) * half / TF32_FLOPS})
        t_ops = max(parts.values())
        timed[label] = {
            "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "S": S,
                      "dtype": str(dt).replace("torch.", ""), **kw},
            "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
            "device_events": n_ev, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "live_pairs_per_head": pairs,
            "bound_parts_ms": {"bytes": 1e3 * t_bytes,
                               **{k: 1e3 * t for k, t in parts.items()}},
            "bound_f32_rate_ms": 1e3 * max(t_bytes, 2 * half / F32_FLOPS),
            "kernel": f"flash_attention_{route}_kernel",
            "share_of_bound": 1e3 * max(t_bytes, t_ops) / kernel_ms,
            "library_ms": library_ms,
            "library": ("torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True)" if lib else
                        "none: scaled_dot_product_attention has no logit "
                        "softcap"),
        }
        del q, k, v, sets
        torch.cuda.empty_cache()
    main = timed["gemma2_prefill_global"]
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:100",
        "tpu_kernel": "src/repro/kernels/flash_attention.py::"
                      "flash_attention_fwd",
        "launches": None,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "error_per_case_and_timed_shape": errs,
        "ms": main["ms"], "kernel_ms": main["kernel_ms"],
        "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "library": main["library"],
        "shape": main["shape"],
        "per_shape": timed,
    }


# ---------------------------------------------------------------------------
# phase 2e: the single-learner gossip kernel through dpsgd_fused_update
# ---------------------------------------------------------------------------

def gossip_single_phase(kernels):
    from repro_torch.configs import get_config
    from repro_torch.core.flatstate import flatten_for_kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gossip_mix import gossip_mix_update
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    api = build_model(get_config("transformer-100m"))
    tree = api.param_tree(api.init(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def draw(t):
        return torch.randn(t.shape, generator=gen, device="cuda")

    nbrs = [tree_map(draw, tree) for _ in range(GOSSIP_SINGLE_K)]
    grads, mom = tree_map(draw, tree), tree_map(draw, tree)
    coefs = [1.0 / (GOSSIP_SINGLE_K + 1)] * (GOSSIP_SINGLE_K + 1)
    kw = dict(lr=GOSSIP_SINGLE_LR, beta=GOSSIP_SINGLE_BETA)
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    got = ops.dpsgd_fused_update(tree, nbrs, grads, mom, coefs, **kw)
    torch.cuda.synchronize()
    tree_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    check(launches["gossip_mix_update"] == 1 and sum(launches.values()) == 1,
          f"dpsgd_fused_update launches {launches}")
    want = ops.dpsgd_fused_update(tree, nbrs, grads, mom, coefs,
                                  backend="ref", **kw)
    err = 0.0
    for g_tree, w_tree in zip(got, want):
        for a, b in zip(_leaves(g_tree), _leaves(w_tree)):
            err = max(err, _max_err(a, b))
            check(_bits_equal(a, b),
                  f"dpsgd_fused_update: kernel and plain differ by {err}")
    print(f"gossip_mix_update (dpsgd_fused_update, 100m tree, K="
          f"{GOSSIP_SINGLE_K}) max_abs_err {err}", flush=True)

    w, _ = flatten_for_kernel(tree)
    T = w.shape[0]
    check(T == TRAIN_ROWS, f"the 100m tree flattens to {T} rows, not "
          f"{TRAIN_ROWS}")
    nb = torch.stack([flatten_for_kernel(t)[0] for t in nbrs])
    g, mu = flatten_for_kernel(grads)[0], flatten_for_kernel(mom)[0]
    c = torch.tensor(coefs, dtype=torch.float32, device="cuda")
    del nbrs, grads, mom, got, want
    kernel_ms = time_ms(lambda: gossip_mix_update(w, nb, g, mu, c, **kw),
                        [()], iters=50)
    plain_ms = time_ms(lambda: ref.gossip_mix_update_ref(w, nb, g, mu, c,
                                                         **kw),
                       [()], iters=5)
    times, _, _, _ = device_times(
        lambda: [gossip_mix_update(w, nb, g, mu, c, **kw)
                 for _ in range(20)])
    device_ms, n_ev = per_event_ms(times, "gossip_mix_single_kernel")
    vec = w.numel() * 4
    # w, the K neighbours, g and mu in; w' and mu' out
    nbytes = (3 + GOSSIP_SINGLE_K) * vec + 2 * vec + c.numel() * 4
    flops = (2 * GOSSIP_SINGLE_K + 5) * w.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {
        "name": "gossip_mix_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:74",
        "tpu_kernel": "src/repro/kernels/gossip_mix.py::gossip_mix_update",
        "launches": launches["gossip_mix_update"],
        "max_abs_err": err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
        "device_events": n_ev, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": nbytes,
        "library_ms": None,
        "library": ("none: no single PyTorch call computes the K-term mix, "
                    "the momentum update and the step in one pass"),
        "tree_level_ms_first_call": tree_ms,
        "shape": {"T": T, "K": GOSSIP_SINGLE_K, "coefs": coefs, **kw},
    }


# ---------------------------------------------------------------------------
# phase 7: gemma2-27b at full width through the flash route
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def gemma2_phase(kernels):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    full = get_config("gemma2-27b")
    cfg = dataclasses.replace(full, n_layers=GEMMA_LAYERS, use_pallas=True)
    chunked = dataclasses.replace(cfg, use_pallas=False)
    api, api_c = build_model(cfg), build_model(chunked)
    t0 = time.perf_counter()
    params = api.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, GEMMA_PREFILL_SEQ))).cuda()

    def counted(fn):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, 1e3 * (time.perf_counter() - t0),
                {k.__name__: k.launches for k in kernels},
                torch.cuda.max_memory_allocated() / 1e9)

    # (i) prefill: every logit finite, the last positions against chunked
    with torch.no_grad():
        logits, prefill_ms, launches, prefill_gb = counted(
            lambda: api.apply(params, {"tokens": tokens}))
        check(launches["flash_attention_fwd"] == GEMMA_LAYERS
              and sum(launches.values()) == GEMMA_LAYERS,
              f"gemma2 prefill launches {launches}")
        check(logits.shape == (1, GEMMA_PREFILL_SEQ, cfg.padded_vocab)
              and logits.dtype == getattr(torch, cfg.compute_dtype),
              f"gemma2 logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()),
              "non-finite gemma2 prefill logits")
        last = logits[:, -GEMMA_LAST:].clone()
        del logits
        logits_c, chunked_ms, launches_c, chunked_gb = counted(
            lambda: api_c.apply(params, {"tokens": tokens}))
        check(sum(launches_c.values()) == 0,
              f"the chunked route launched {launches_c}")
        last_c = logits_c[:, -GEMMA_LAST:].clone()
        del logits_c
    prefill_rel = _rel(last, last_c)
    prefill_max = float((last.float() - last_c.float()).abs().max())
    check(prefill_rel <= GEMMA_BF16_RTOL,
          f"gemma2 prefill: last {GEMMA_LAST} positions differ from the "
          f"chunked route by {prefill_rel} relative")
    torch.cuda.empty_cache()

    # (ii) loss + backward; the chunked route at a 512 block (4,608 = 9 x
    # 512; its default 1,024 does not divide the length)
    labels = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, GEMMA_TRAIN_SEQ))).cuda()
    batch = {"tokens": tokens[:, :GEMMA_TRAIN_SEQ].contiguous(),
             "labels": labels}
    api_c2 = build_model(dataclasses.replace(chunked,
                                             attn_chunk=GEMMA_CHUNK))

    def loss_and_grad(a):
        params.zero_grad(set_to_none=True)
        loss = a.loss_fn(params, batch)
        loss.backward()
        return loss.detach()

    loss, train_ms, launches_t, train_gb = counted(
        lambda: loss_and_grad(api))
    check(launches_t["flash_attention_fwd"] == GEMMA_LAYERS
          and sum(launches_t.values()) == GEMMA_LAYERS,
          f"gemma2 loss/backward launches {launches_t}")
    check(all(bool(torch.isfinite(p.grad).all())
               for p in params.parameters()),
          "non-finite gemma2 gradients")
    wq = [params.periods[0][f"l{i}"].mixer.wq.grad.clone()
          for i in range(2)]
    loss_c, train_c_ms, launches_tc, train_c_gb = counted(
        lambda: loss_and_grad(api_c2))
    check(sum(launches_tc.values()) == 0,
          f"the chunked route launched {launches_tc}")
    wq_c = [params.periods[0][f"l{i}"].mixer.wq.grad for i in range(2)]
    wq_rel = [_rel(a, b) for a, b in zip(wq, wq_c)]
    loss_rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    check(max(wq_rel) <= GEMMA_BF16_RTOL,
          f"gemma2 wq gradients differ from the chunked route by {wq_rel}")
    check(loss_rel <= GEMMA_LOSS_RTOL,
          f"gemma2 loss {float(loss)} vs chunked {float(loss_c)}")
    params.zero_grad(set_to_none=True)
    del params, wq, wq_c
    torch.cuda.empty_cache()
    return {
        "model": full.name, "n_layers": GEMMA_LAYERS,
        "reduced": {"n_layers": f"{full.n_layers} -> {GEMMA_LAYERS} (one "
                                "local/global period; every width kept)"},
        "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim_,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "window": cfg.window,
        "softcaps": [cfg.attn_softcap, cfg.final_softcap],
        "dtype": cfg.param_dtype, "n_params": n_params, "init_s": init_s,
        "prefill": {"tokens": GEMMA_PREFILL_SEQ,
                    "flash_wall_ms": prefill_ms,
                    "chunked_wall_ms": chunked_ms,
                    "flash_peak_gb": prefill_gb,
                    "chunked_peak_gb": chunked_gb,
                    "flash_launches": launches["flash_attention_fwd"],
                    "last_positions": GEMMA_LAST,
                    "last_logits_rel_diff_vs_chunked": prefill_rel,
                    "last_logits_max_abs_diff_vs_chunked": prefill_max,
                    "tier_rel": GEMMA_BF16_RTOL},
        "loss_backward": {"tokens": GEMMA_TRAIN_SEQ,
                          "loss": float(loss), "chunked_loss": float(loss_c),
                          "loss_rel_diff": loss_rel,
                          "flash_wall_ms": train_ms,
                          "chunked_wall_ms": train_c_ms,
                          "flash_peak_gb": train_gb,
                          "chunked_peak_gb": train_c_gb,
                          "chunked_block": GEMMA_CHUNK,
                          "flash_launches": launches_t["flash_attention_fwd"],
                          "wq_grad_rel_diff_vs_chunked": wq_rel,
                          "tier_rel": GEMMA_BF16_RTOL},
    }, launches["flash_attention_fwd"] + launches_t["flash_attention_fwd"]


# ---------------------------------------------------------------------------
# phase 8: transformer-100m trained through the flash route
# ---------------------------------------------------------------------------

def flash_train_phase(kernels, chunked_train):
    run = train_100m(kernels, FLASH_TRAIN_WARM, FLASH_TRAIN_TIMED,
                     FLASH_TRAIN_PROF, use_pallas=True)
    launches, losses = run.launches, run.losses
    per_step = TRAIN_LEARNERS * run.cfg.n_layers
    check(launches["flash_attention_fwd"] == run.steps * per_step,
          f"flash launches {launches['flash_attention_fwd']} != "
          f"{run.steps} steps x {per_step}")
    others = {k: v for k, v in launches.items() if k not in (
        "flash_attention_fwd", "gossip_mix_update_flat")}
    check(sum(others.values()) == 0, f"other kernels launched: {others}")
    ref = chunked_train["losses"][:2]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:2], ref)]
    check(max(rel) <= FLASH_TRAIN_LOSS_RTOL,
          f"flash-route losses {losses[:2]} vs chunked {ref}: {rel}")
    prof = chunked_train["profile"]
    del run.trainer, run.state, run.metrics
    torch.cuda.empty_cache()
    return {
        "model": run.cfg.name, "use_pallas": True, "steps": run.steps,
        "timed_steps": FLASH_TRAIN_TIMED,
        "ms_per_step": run.step_ms, "tokens_per_s": run.tokens_per_s,
        "profile": run.profile,
        "chunked_route": {
            "ms_per_step": chunked_train["ms_per_step"],
            "tokens_per_s": chunked_train["tokens_per_s"],
            "device_idle_share": prof["device_idle_share"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "device_kernels_per_step": prof["device_kernels_per_step"]},
        "max_memory_allocated_gb": run.peak_gb,
        "losses": losses, "chunked_losses_first_2": ref,
        "loss_rel_diff_first_2": rel,
        "kernel_launches": launches,
    }, launches["flash_attention_fwd"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import cuda_build
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     gossip_mix, reorth)

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in
    torch.backends.cudnn.allow_tf32 = False         # full float32

    card = card_line()
    print(f"card: {card}", flush=True)
    sources = [decode_attention.SOURCE, gossip_mix.SOURCE, reorth.SOURCE,
               flash_attention.SOURCE]
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    print(f"build: {len(sources)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    kernels = [decode_attention.paged_decode_attention_fwd,
               gossip_mix.gossip_mix_update_flat,
               reorth.reorth_dots, reorth.reorth_axpy,
               gossip_mix.gossip_mix_update,
               flash_attention.flash_attention_fwd]

    decode_record = decode_attention_phase()
    gossip_record = gossip_phase()
    torch.cuda.empty_cache()
    dots_record, axpy_record = reorth_phase()
    torch.cuda.empty_cache()
    flash_record = flash_phase()
    single_record = gossip_single_phase(kernels)
    torch.cuda.empty_cache()

    for k in kernels:
        k.launches = 0
    serve, _ = serve_phase()
    serve["kernel_launches"] = {k.__name__: k.launches for k in kernels}
    check(all(v == 0 for k, v in serve["kernel_launches"].items()
              if k != "paged_decode_attention_fwd"),
          f"the serving path launched another path's kernel: "
          f"{serve['kernel_launches']}")
    print(json.dumps({"serve": serve}), flush=True)

    serve_launches = {"transformer_100m_serving": serve["kernel_launches"][
        "paged_decode_attention_fwd"]}
    for key, name, layers, why in (
            ("serve_gemma2", "gemma2-27b", GEMMA_LAYERS,
             "one local/global period"),
            ("serve_granite", "granite-20b", GRANITE_LAYERS,
             "phase 3b's depth")):
        for k in kernels:
            k.launches = 0
        record, _ = cut_serve_phase(name, layers, why)
        record["kernel_launches"] = {k.__name__: k.launches for k in kernels}
        check(all(v == 0 for k, v in record["kernel_launches"].items()
                  if k != "paged_decode_attention_fwd"),
              f"the {name} serving path launched another path's kernel: "
              f"{record['kernel_launches']}")
        print(json.dumps({key: record}), flush=True)
        serve_launches[name.replace("-", "_") + "_serving"] = record[
            "kernel_launches"]["paged_decode_attention_fwd"]
        del record
        torch.cuda.empty_cache()
    decode_record["launches"] = sum(serve_launches.values())
    decode_record["launches_by_path"] = serve_launches

    train, gossip_record["launches"], probe, probe_launches = \
        train_phase(kernels)
    dots_record["launches"] = probe_launches["reorth_dots"]
    axpy_record["launches"] = probe_launches["reorth_axpy"]
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"probe": probe}), flush=True)
    fc = fc_phase(kernels)
    print(json.dumps({"fc": fc}), flush=True)
    table1 = table1_phase(kernels)
    print(json.dumps({"table1": table1}), flush=True)
    gemma, gemma_launches = gemma2_phase(kernels)
    print(json.dumps({"gemma2": gemma}), flush=True)
    flash_train, train_launches = flash_train_phase(kernels, train)
    print(json.dumps({"flash_train": flash_train}), flush=True)
    flash_record["launches"] = gemma_launches + train_launches
    flash_record["launches_by_path"] = {
        "gemma2_prefill_and_loss_backward": gemma_launches,
        "transformer_100m_use_pallas_training": train_launches}

    print(card, flush=True)
    print(json.dumps({"kernels": [decode_record, gossip_record, dots_record,
                                  axpy_record, single_record,
                                  flash_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
