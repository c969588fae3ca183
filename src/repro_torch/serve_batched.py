"""Batched serving: a thin CLI over the serve engine (``ServeEngine``,
continuous batching on the paged KV cache) — the port's twin of
``examples/serve_batched.py``, same flags.

Mixed-length prompts are submitted up front; the engine prefills them one
token a step inside the same decode step, recycles slots as requests
finish, and counts every generated token, the first included.  Timing
starts after ``warmup()`` (on the card it builds and loads the decode
kernel) and each step syncs on its argmax, so the tok/s figure is honest
wall-clock.

    PYTHONPATH=src python -m repro_torch.serve_batched --arch gemma2-27b
    PYTHONPATH=src python -m repro_torch.serve_batched --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .configs import get_config
from .device import resolve_device
from .models import build_model
from .serve import ServeEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="transformer-100m")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--buf", type=int, default=64,
                    help="max tokens per request (prompt + generated)")
    ap.add_argument("--page", type=int, default=8, help="KV page size")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to serve (default: 2x slots)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Serve the smoke ``--arch``; returns the run's summary (ms a step,
    tokens/s, tokens, steps and each request's generated tokens)."""
    args = parse_args(argv)
    cfg = get_config(args.arch).smoke_config()
    api = build_model(cfg, device=resolve_device(args.device))
    if not api.has_paged:
        raise SystemExit(f"{cfg.name}: family {cfg.family} has no paged "
                         "decode path (text families only)")
    params = api.init(0)

    eng = ServeEngine(api, params, n_slots=args.batch, page_size=args.page,
                      max_len=args.buf)
    rng = np.random.default_rng(0)
    n_req = args.requests or 2 * args.batch
    max_prompt = max(1, args.buf - args.new_tokens)
    reqs = [eng.submit(rng.integers(1, cfg.vocab,
                                    rng.integers(1, max_prompt + 1)).tolist(),
                       args.new_tokens)
            for _ in range(n_req)]

    eng.warmup()                      # kernels built outside the timing
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0

    total = eng.generated_total
    ms = dt * 1e3 / eng.real_steps
    print(f"arch={cfg.name} slots={args.batch} page={args.page} "
          f"buf={args.buf} requests={n_req}")
    print(f"{ms:.1f} ms/step  ({total / dt:.1f} tok/s aggregate, {total} "
          f"tokens, {eng.real_steps} steps)")
    print("sequences:")
    for r in reqs[:4]:
        print("  ", r.generated[:16], "...")
    return {"ms_per_step": ms, "tokens_per_s": total / dt, "tokens": total,
            "steps": eng.real_steps, "requests": n_req,
            "generated": [r.generated for r in reqs]}


if __name__ == "__main__":
    main()
