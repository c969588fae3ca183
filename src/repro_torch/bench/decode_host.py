"""Host cost of the paged decode-attention wrapper, and the serve step it
runs in, on the card.

    PYTHONPATH=src python src/repro_torch/bench/decode_host.py [--pieces]

Serves transformer-100m (full width and depth, random weights from seed
0) through ``ServeEngine`` with ``chip_smoke.py``'s phase-3 traffic (8
slots, page 16, max_len 256, 16 requests from numpy seed 0) three times
over, and prints the engine's ms per step and the device's busy share
over 20 steady steps.  Then it times the wrapper alone at that serve
shape (float32, 12 heads, hd 64, lengths 1-256): host us per call over
back-to-back calls, CUDA-event ms per call and the device kernels' ms
per call.  ``--pieces`` also times each step of the wrapper by itself
(checks, split plan, library lookup, stream, scratch, output, device
context, the ctypes launch), so the sum can be set against the whole.

The script uses only the port's public entry points (and, with
``--pieces``, the wrapper module's helpers), run by path so that
``PYTHONPATH`` picks the tree under test: two trees are compared on one
card by running it under each in turn.  The last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SEED = 0
N_SLOTS, PAGE, MAX_LEN, N_REQUESTS = 8, 16, 256, 16
SERVE_PASSES, PROFILE_STEPS = 3, 20
CALLS = 4000


def requests(vocab):
    """chip_smoke.py's phase-3 requests: prompts of 8-128 tokens and
    budgets of 16-64 from numpy seed 0."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(N_REQUESTS):
        n = int(rng.integers(8, 129))
        out.append((rng.integers(1, vocab, n).tolist(),
                    int(rng.integers(16, 65))))
    return out


def device_busy_us(run):
    """(device us of every kernel event, wall s) of ``run()`` under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    return per_name, wall


def serve():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("transformer-100m")
    api = build_model(cfg)
    params = api.init(SEED)
    eng = ServeEngine(api, params, n_slots=N_SLOTS, page_size=PAGE,
                      max_len=MAX_LEN)
    eng.warmup()
    jobs = requests(cfg.vocab)
    passes = []
    for _ in range(SERVE_PASSES):
        for p, m in jobs:
            eng.submit(p, m)
        torch.cuda.synchronize()
        ends, t0 = [], time.perf_counter()
        while eng.has_work:
            eng.step()              # each step ends in a host read
            ends.append(time.perf_counter() - t0)
        step_ms = np.diff([0.0] + ends) * 1e3
        passes.append({"steps": len(step_ms),
                       "ms_per_step": float(step_ms.mean()),
                       "step_ms_median": float(np.median(step_ms)),
                       "step_ms_p95": float(np.percentile(step_ms, 95))})
    for p, m in jobs[:N_SLOTS]:
        eng.submit(p, m)
    for _ in range(5):
        eng.step()
    per_name, wall = device_busy_us(
        lambda: [eng.step() for _ in range(PROFILE_STEPS)])
    busy = sum(v[0] for v in per_name.values()) / 1e3
    decode = {k[:60]: [v[0] / 1e3 / PROFILE_STEPS, v[1] / PROFILE_STEPS]
              for k, v in per_name.items() if "paged_decode" in k}
    return {"passes": passes,
            "ms_per_step_mean_of_passes": float(np.mean(
                [p["ms_per_step"] for p in passes])),
            "profiled_wall_ms_per_step": 1e3 * wall / PROFILE_STEPS,
            "device_busy_ms_per_step": busy / PROFILE_STEPS,
            "device_idle_share": 1 - busy / 1e3 / wall,
            "decode_kernels_ms_and_events_per_step": decode}


def operands():
    rng = np.random.default_rng(SEED)
    S, H, KV, hd, max_pages = N_SLOTS, 12, 12, 64, MAX_LEN // PAGE
    P = 1 + S * max_pages
    arrays = [rng.standard_normal(shape, dtype=np.float32) for shape in
              ((S, H, hd), (P, PAGE, KV, hd), (P, PAGE, KV, hd))]
    table = rng.permutation(np.arange(1, P)).reshape(S, max_pages)
    lengths = np.linspace(1, MAX_LEN, S).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in arrays + [table.astype(np.int32), lengths]]


def host_us(fn, n=CALLS):
    """Mean host us per call of ``fn()`` over ``n`` calls after a warm-up,
    with a sync every 500 calls so no launch queue fills."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // 500):
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / (500 * (n // 500))


def wrapper(pieces: bool):
    from repro_torch.kernels import decode_attention as mod

    args = operands()
    kernel = mod.paged_decode_attention_fwd
    out = {"host_us_per_call": host_us(lambda: kernel(*args))}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(1000):
        kernel(*args)
    stop.record()
    torch.cuda.synchronize()
    out["events_ms_per_call"] = start.elapsed_time(stop) / 1000
    per_name, _ = device_busy_us(lambda: [kernel(*args) for _ in range(40)])
    out["device_ms_per_call"] = sum(v[0] / v[1] / 1e3
                                    for v in per_name.values())
    out["device_kernels"] = {k[:60]: v[1] for k, v in per_name.items()}
    if not pieces:
        return out

    q, kp, vp, table, ln = args
    S, H, hd = q.shape
    _, page, KV, _ = kp.shape
    max_pages = table.shape[1]
    n_sm = mod._sm_count(q.device.index)
    splits, n_pages = mod.split_plan(max_pages, page, S, KV, n_sm)
    lib = mod.load_library(mod.SOURCE, mod.SIGNATURES)
    real = lib.paged_decode_attention
    seen = []

    def keep(*a):
        seen.append(a)
        return real(*a)
    lib.paged_decode_attention = keep
    kernel(*args)
    lib.paged_decode_attention = real
    launch_args = seen[0]
    ctx = torch.cuda.device(q.device)

    def in_ctx():
        with ctx:
            pass
    part_n = splits * S * H * (hd + 2)
    steps = {
        "_check": lambda: mod._check(q, kp, vp, table, ln),
        "_sm_count": lambda: mod._sm_count(q.device.index),
        "split_plan": lambda: mod.split_plan(max_pages, page, S, KV, n_sm),
        "load_library": lambda: mod.load_library(mod.SOURCE,
                                                 mod.SIGNATURES),
        "current_stream": lambda: torch.cuda.current_stream(
            q.device).cuda_stream,
        "torch.empty(partials)": lambda: torch.empty(
            (part_n,), dtype=torch.float32, device=q.device),
        "torch.empty_like(q)": lambda: torch.empty_like(q),
        "torch.cuda.device context": in_ctx,
        "ctypes launch (C call with the wrapper's arguments)":
            lambda: real(*launch_args),
        "ctypes call with one argument": lambda:
            lib.paged_decode_attention_error_string(0),
    }
    if hasattr(mod, "_scratch_for"):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        steps["_scratch_for (kept scratch)"] = lambda: mod._scratch_for(
            q.device, stream, part_n, S * KV)
    out["pieces_host_us"] = {k: host_us(f) for k, f in steps.items()}
    out["launch_arguments"] = len(launch_args)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pieces", action="store_true",
                    help="also time each step of the wrapper by itself")
    ap.add_argument("--label", default="", help="a name for the tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_host needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    record = {"label": args.label, "card": card.splitlines()[0],
              "wrapper": wrapper(args.pieces), "serve": serve()}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
