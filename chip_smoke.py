"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card and build: the card's name and power limit; every kernel of the
     serving path compiled from ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, started together), with the build time;
  2. each kernel against its plain PyTorch version on the card, on float32
     inputs drawn from a seeded numpy RNG, at the serve shape and at GQA
     shapes with softcap and window; then its time beside the plain
     version's, one PyTorch library call's and the least time the card
     could take (``bound_ms``);
  3. full-width serving: transformer-100m (12 layers, d=768, vocab 32768,
     random weights from a seeded torch.Generator) behind ``ServeEngine``
     (8 slots, page 16, max_len 256) runs 16 requests to completion; every
     request must finish with its budget, every logit must be finite, the
     kernel must have launched 12 times per engine step, and the first 3
     steps' logits must match the port on the CPU (plain versions, same
     weights).
The last lines are the serve numbers, the card, the kernels record and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1 before
printing any result.
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
    and copy API calls, wall seconds).  The profiler's own host cost
    inflates the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out, api = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = out.setdefault(e.name, [0.0, 0])
        elif e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy")):
            acc = api.setdefault(e.name, [0.0, 0])
        else:
            continue
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    return out, api, wall


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
    times, _, _ = device_times(lambda: [kernel(*sets[i % len(sets)])
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
        times, api_calls, wall = device_times(
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import cuda_build
    from repro_torch.kernels import decode_attention

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in
    torch.backends.cudnn.allow_tf32 = False         # full float32

    card = card_line()
    print(f"card: {card}", flush=True)
    sources = [decode_attention.SOURCE]
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    print(f"build: {len(sources)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    record = decode_attention_phase()
    serve, launches = serve_phase()
    record["launches"] = launches
    print(json.dumps({"serve": serve}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
