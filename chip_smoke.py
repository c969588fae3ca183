"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card and build: the card's name and power limit; every kernel of the
     port compiled from ``src/repro_torch/kernels/csrc`` with nvcc (one
     process per source, started together), with the build time;
  2. each kernel against its plain PyTorch version on the card, on float32
     inputs drawn from a seeded numpy RNG — the decode attention at the
     serve shape and at GQA shapes with softcap and window; the gossip
     update at the training shape (n=4, T=1,056,920, K=1, momentum), on a
     ring with weight decay and an inactive NaN row, in AD-PSGD publish
     mode, and as a mixing-only round (K=3) — then each kernel's time
     beside the plain version's, one PyTorch library call's where one
     computes the same function, and the least time the card could take
     (``bound_ms``);
  3. full-width serving: transformer-100m (12 layers, d=768, vocab 32768,
     random weights from a seeded torch.Generator) behind ``ServeEngine``
     (8 slots, page 16, max_len 256) runs 16 requests to completion; every
     request must finish with its budget, every logit must be finite, the
     attention kernel must have launched 12 times per engine step, and the
     first 3 steps' logits must match the port on the CPU (plain versions,
     same weights);
  4. full-width training: transformer-100m trained with DPSGD by
     ``MultiLearnerTrainer`` (4 learners, random_pair, the
     ``examples/train_100m.py`` recipe: sgd(0.5, momentum 0.9) under a
     warm-up schedule, synthetic tokens, seq 512, local batch 2): 2 warm-up
     and 6 timed steps, then 2 profiled ones; every loss must be finite,
     the gossip kernel must have launched once per gossip round, and the
     first 2 steps with ``kernel_backend="ref"`` must give the same
     parameters;
  5. the paper's experiment and the other modes on the FC net: the
     quickstart twin (SSGD vs DPSGD at lr 0.5, 5 x 400, 120 steps; DPSGD
     must end below SSGD), ``full`` gossip on 4 learners (two rounds, so
     the mixing-only pass runs) with momentum and weight decay, and
     AD-PSGD with a straggler, both against ``kernel_backend="ref"``.
Each path runs with every kernel's launch count set to 0 just before it
and read just after.  The last lines are the serve, train and FC numbers,
the card, the kernels record and ``{"ok": true, "device": {...}}``.
Without CUDA the script exits 1 before printing any result.
"""
from __future__ import annotations

import copy
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


# ---------------------------------------------------------------------------
# phase 2: paged decode attention against its plain version
# ---------------------------------------------------------------------------

def paged_operands(S, H, KV, hd, page, max_pages, lengths, seed):
    rng = np.random.default_rng(seed)
    P = 1 + S * max_pages                   # page 0 = scratch, never mapped
    q = rng.standard_normal((S, H, hd), dtype=np.float32)
    kp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((P, page, KV, hd), dtype=np.float32)
    table = rng.permutation(np.arange(1, P)).reshape(S, max_pages)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in
            (q, kp, vp, table.astype(np.int32),
             np.asarray(lengths, np.int32))]


def decode_attention_phase():
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_fwd as kernel

    lengths = np.linspace(1, MAX_LEN, N_SLOTS).astype(int).tolist()
    cases = [
        ("serve", dict(S=N_SLOTS, H=12, KV=12, hd=64), {}),
        ("gqa_softcap", dict(S=N_SLOTS, H=8, KV=2, hd=128),
         dict(attn_softcap=50.0)),
        ("gqa_window", dict(S=N_SLOTS, H=8, KV=2, hd=128), dict(window=64)),
    ]
    errs = {}
    for i, (name, shape, kw) in enumerate(cases):
        ops = paged_operands(page=PAGE, max_pages=MAX_LEN // PAGE,
                             lengths=lengths, seed=SEED + i, **shape)
        got = kernel(*ops, **kw)
        want = ref.paged_decode_attention_ref(*ops, **kw)
        torch.cuda.synchronize()
        live = ops[4] > 0
        errs[name] = float((got - want)[live].abs().max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(errs[name] <= KERNEL_ATOL,
              f"{name}: max |kernel - plain| {errs[name]} > {KERNEL_ATOL}")
    print(f"decode_attention max_abs_err per case {json.dumps(errs)}",
          flush=True)

    # timing at the serve shape, on copies that together exceed the L2
    q, kp, vp, table, ln = paged_operands(
        N_SLOTS, 12, 12, 64, PAGE, MAX_LEN // PAGE, lengths, SEED)
    n_copies = 1 + L2_BYTES // (2 * kp.numel() * 4)
    sets = [(q, kp.clone(), vp.clone(), table, ln) for _ in range(n_copies)]
    kernel_ms = time_ms(kernel, sets)
    plain_ms = time_ms(ref.paged_decode_attention_ref, sets)

    S, H, hd = q.shape
    KV = kp.shape[2]
    W = table.shape[1] * PAGE
    valid = torch.arange(W, device="cuda")[None, :] < ln.long()[:, None]

    def gathered(k, v):
        def g(pool):
            return pool[table.long()].reshape(S, W, KV, hd).transpose(1, 2)
        return q[:, :, None, :], g(k), g(v), valid[:, None, None, :]

    lib_sets = [gathered(k, v) for _, k, v, _, _ in sets]

    def sdpa(qq, kk, vv, mask):
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=H != KV)
    library_ms = time_ms(sdpa, lib_sets)
    times, _, _, _ = device_times(lambda: [kernel(*sets[i % len(sets)])
                                        for i in range(50)])
    dev = [v for k, v in times.items() if "paged_decode_kernel" in k]
    device_ms = dev[0][0] / dev[0][1] / 1e3 if dev else None

    live = ln.clamp(0, W).long()
    n_live = int(live.sum())
    nbytes = 4 * (2 * q.numel() + table.numel() + ln.numel()
                  + 2 * n_live * KV * hd)
    flops = 4 * n_live * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:99",
        "tpu_kernel": ("src/repro/kernels/decode_attention.py::"
                       "paged_decode_attention_fwd"),
        "launches": None,
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "library": ("torch.nn.functional.scaled_dot_product_attention on "
                    "the already-gathered K/V with the length mask "
                    "(gather excluded)"),
        "shape": {"S": S, "H": H, "KV": KV, "hd": hd, "page": PAGE,
                  "max_pages": W // PAGE, "lengths": lengths},
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


def requests(vocab):
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(N_REQUESTS):
        n = int(rng.integers(8, 129))
        out.append((rng.integers(1, vocab, n).tolist(),
                    int(rng.integers(16, 65))))
    return out


def serve_phase():
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_fwd as kernel
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    params = api.init(SEED)
    n_params = sum(p.numel() for p in params.parameters())
    rec = Recorder(api.paged_decode_step, CPU_STEPS)
    eng = ServeEngine(api._replace(paged_decode_step=rec), params,
                      n_slots=N_SLOTS, page_size=PAGE, max_len=MAX_LEN)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    jobs = requests(cfg.vocab)
    kernel.launches = 0
    rec.on = True
    t0 = time.perf_counter()
    reqs = [eng.submit(p, m) for p, m in jobs]
    ends = []                   # host clock after each step (ends in a sync)
    while eng.has_work:
        eng.step()
        ends.append(time.perf_counter() - t0)
        check(len(ends) < 10 * MAX_LEN * N_REQUESTS, "serve engine wedged")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    step_ms = np.diff([0.0] + ends) * 1e3
    ttft_ms = sorted(1e3 * ends[r.first_token_step] for r in reqs)
    launches = kernel.launches
    steps, generated = eng.real_steps, eng.generated_total

    check(all(r.done and len(r.generated) == m
              for r, (_, m) in zip(reqs, jobs)),
          "a request did not finish with its token budget")
    check(bool(rec.finite), "non-finite logits in the serve run")
    check(launches == steps * cfg.n_layers,
          f"kernel launches {launches} != {steps} steps x "
          f"{cfg.n_layers} layers")

    # the same weights and requests through the port on the CPU
    cpu_api = build_model(cfg, device="cpu")
    cpu_params = copy.deepcopy(params).to("cpu")
    cpu_rec = Recorder(cpu_api.paged_decode_step, CPU_STEPS)
    cpu_eng = ServeEngine(cpu_api._replace(paged_decode_step=cpu_rec),
                          cpu_params, n_slots=N_SLOTS, page_size=PAGE,
                          max_len=MAX_LEN)
    cpu_rec.on = True
    for p, m in jobs:
        cpu_eng.submit(p, m)
    for _ in range(CPU_STEPS):
        cpu_eng.step()
    logit_err = 0.0
    for i, (g, c) in enumerate(zip(rec.logits, cpu_rec.logits)):
        g = g.cpu()
        logit_err = max(logit_err, float((g - c).abs().max()))
        check(torch.allclose(g, c, atol=LOGIT_TOL, rtol=LOGIT_TOL),
              f"step {i}: card logits differ from the CPU's by "
              f"{float((g - c).abs().max())}")
    check(len(cpu_rec.logits) == CPU_STEPS == len(rec.logits),
          "fewer recorded steps than compared")

    # where a steady serve step's time goes: 20 steps of 8 fresh requests
    rec.on = False
    for p, m in jobs[:N_SLOTS]:
        eng.submit(p, m)
    for _ in range(5):
        eng.step()
    n_prof = 20
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
            if "paged_decode_kernel" in k) / 1e3 / n_prof,
        "host_api_ms_per_step": {
            k: [v[0] / 1e3 / n_prof, v[1] / n_prof]
            for k, v in api_calls.items()},
        "sm_clock_mhz_median": (clocks[len(clocks) // 2] if clocks
                                else None),
        "top_device_ms_per_step": [
            [k[:90], v[0] / 1e3 / n_prof, v[1] / n_prof] for k, v in top],
    }

    prompt_tokens = sum(len(p) for p, _ in jobs)
    return {
        "model": cfg.name, "n_params": n_params, "n_slots": N_SLOTS,
        "page_size": PAGE, "max_len": MAX_LEN, "requests": N_REQUESTS,
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
        "cpu_logit_max_abs_diff_first_3_steps": logit_err,
        "profile": profile,
    }, launches


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
        kernel_backend=backend, params_from_tree=api.params_from_tree)


def train_phase(kernels):
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticTokenStream
    from repro_torch.models import build_model

    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    tree = api.param_tree(api.init(SEED))
    n_params = sum(t.numel() for t in _leaves(tree))
    steps = WARM_STEPS + TIMED_STEPS + PROF_STEPS
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
    for i in range(WARM_STEPS):
        state, m = trainer.train_step(state, batches[i])
        metrics.append(m)
    after_warm = state.params.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARM_STEPS, WARM_STEPS + TIMED_STEPS):
        state, m = trainer.train_step(state, batches[i])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS

    def prof_steps():
        nonlocal state
        for i in range(WARM_STEPS + TIMED_STEPS, steps):
            state, m = trainer.train_step(state, batches[i])
            metrics.append(m)
    times, api_calls, wall, host = device_times(prof_steps)
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = torch.stack([m.loss for m in metrics]).tolist()
    sigma = float(metrics[-1].sigma_w_sq)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    want = steps * trainer.rounds_per_step
    check(launches["gossip_mix_update_flat"] == want,
          f"gossip kernel launches {launches['gossip_mix_update_flat']} != "
          f"{steps} steps x {trainer.rounds_per_step} rounds")
    check(launches["paged_decode_attention_fwd"] == 0,
          "the training path launched the decode kernel")
    busy_us = sum(v[0] for v in times.values())
    gossip_us = sum(v[0] for k, v in times.items() if "gossip_mix_kernel" in k)
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:10]
    del trainer, state, metrics
    torch.cuda.empty_cache()

    # the same first steps through the plain version on the card
    ref_trainer = _train_100m_trainer(api, "ref")
    ref_state = ref_trainer.init(SEED, tree)
    for i in range(REF_STEPS):
        ref_state, _ = ref_trainer.train_step(ref_state, batches[i])
    ref_err = float((ref_state.params - after_warm).abs().max())
    check(ref_err <= TRAIN_REF_ATOL,
          f"kernel and plain training differ by {ref_err} after "
          f"{REF_STEPS} steps")
    del ref_trainer, ref_state, after_warm
    torch.cuda.empty_cache()

    tokens = TRAIN_LEARNERS * TRAIN_BATCH * TRAIN_SEQ
    return {
        "model": cfg.name, "n_params": n_params,
        "learners": TRAIN_LEARNERS, "local_batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "algo": "dpsgd", "topology": "random_pair",
        "lr": TRAIN_LR, "steps": steps, "data_setup_s": data_s,
        "ms_per_step": step_ms, "timed_steps": TIMED_STEPS,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "profile": {
            "steps": PROF_STEPS,
            "wall_ms_per_step_profiled": 1e3 * wall / PROF_STEPS,
            "device_busy_ms_per_step": busy_us / 1e3 / PROF_STEPS,
            "device_idle_share": (1 - busy_us / 1e6 / wall) if busy_us
            else None,
            "gossip_kernel_ms_per_step": gossip_us / 1e3 / PROF_STEPS,
            "gossip_kernel_share_of_device": (gossip_us / busy_us
                                              if busy_us else None),
            "top_device_ms_per_step": [
                [k[:90], v[0] / 1e3 / PROF_STEPS, v[1] / PROF_STEPS]
                for k, v in top],
            "device_kernels_per_step": sum(v[1] for v in times.values())
            / PROF_STEPS,
            "host_api_ms_per_step": {
                k: [v[0] / 1e3 / PROF_STEPS, v[1] / PROF_STEPS]
                for k, v in api_calls.items()},
            "top_host_self_ms_per_step": [
                [k[:60], v[0] / 1e3 / PROF_STEPS, v[1] / PROF_STEPS]
                for k, v in top_host],
        },
        "max_memory_allocated_gb": peak_gb,
        "losses": losses, "sigma_w_sq": sigma,
        "kernel_launches": launches,
        "ref_backend_max_abs_diff_after_2_steps": ref_err,
    }, launches["gossip_mix_update_flat"]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import cuda_build
    from repro_torch.kernels import decode_attention, gossip_mix

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in
    torch.backends.cudnn.allow_tf32 = False         # full float32

    card = card_line()
    print(f"card: {card}", flush=True)
    sources = [decode_attention.SOURCE, gossip_mix.SOURCE]
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    print(f"build: {len(sources)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    kernels = [decode_attention.paged_decode_attention_fwd,
               gossip_mix.gossip_mix_update_flat]

    decode_record = decode_attention_phase()
    gossip_record = gossip_phase()
    torch.cuda.empty_cache()

    for k in kernels:
        k.launches = 0
    serve, _ = serve_phase()
    serve["kernel_launches"] = {k.__name__: k.launches for k in kernels}
    check(serve["kernel_launches"]["gossip_mix_update_flat"] == 0,
          "the serving path launched the gossip kernel")
    decode_record["launches"] = serve["kernel_launches"][
        "paged_decode_attention_fwd"]
    print(json.dumps({"serve": serve}), flush=True)

    train, gossip_record["launches"] = train_phase(kernels)
    print(json.dumps({"train": train}), flush=True)
    fc = fc_phase(kernels)
    print(json.dumps({"fc": fc}), flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [decode_record, gossip_record]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
