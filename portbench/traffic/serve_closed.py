"""Traffic kind ``serve_closed``: closed-loop clients on the port's
``ServeEngine`` (continuous batching over the paged decode; a prompt is
fed one token a step).

The mix's parameters: ``slots``, ``page``, ``max_len``, ``clients``;
``prompt`` and ``output`` lengths, each lognormal {median, sigma, min,
max}; ``sizes`` (how many (prompt, output) length pairs the mix holds);
``ramp_steps`` (set-up steps over which the clients' first requests
arrive, staggered); ``check`` {"requests": how many finished requests
the reference reads}; ``trace_steps``.  Other keys (``source``,
``assumed``) document the mix.

Every seed serves the same ``sizes`` length pairs, taken at the
lognormals' evenly spaced quantiles; the seed shuffles them and pairs
prompt and output lengths.  Submissions take the pairs in order,
cyclically, and each draws fresh token ids (uniform over the vocabulary)
from the seed and its own index, so no prompt is sent twice.  Each
client sends a request, waits for its last token, and sends its next at
once.  No EOS: each request runs to its output length.

Times are the host clock after each step's sync (the engine's argmax
read-back).  TTFT: submission to first token, over requests whose first
token falls in the window (queue wait included).  ITL: every gap between
consecutive tokens of a request whose later token falls in the window.
Tokens per second: tokens produced in the window over its length.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench import common, weights
from portbench.model import port_config, shape
from portbench.reference import serve as ref_serve
from portbench.reference.model import strict_fp32


def _quantile_lengths(spec: dict, count: int):
    nd = statistics.NormalDist()
    out = []
    for i in range(count):
        z = nd.inv_cdf((i + 0.5) / count)
        v = spec["median"] * float(np.exp(spec["sigma"] * z))
        out.append(int(min(max(round(v), spec["min"]), spec["max"])))
    return out


def lengths(seed: int, tr: dict):
    """The seed's (prompt length, output length) pairs, in submission
    order (taken cyclically)."""
    rng = np.random.default_rng([int(seed), 0x5E4E])
    m = tr["sizes"]
    p = _quantile_lengths(tr["prompt"], m)
    o = _quantile_lengths(tr["output"], m)
    return list(zip(rng.permutation(p).tolist(), rng.permutation(o).tolist()))


def request(seed: int, pairs: list, vocab: int, k: int):
    """Submission k: (prompt ids, output length), its ids drawn from the
    seed and k."""
    n, out = pairs[k % len(pairs)]
    rng = np.random.default_rng([int(seed), 0x5E4F, int(k)])
    return rng.integers(0, vocab, int(n)).tolist(), int(out)


class Client:
    __slots__ = ("req", "t_submit", "times", "seen")

    def __init__(self, req, t):
        self.req, self.t_submit, self.times, self.seen = req, t, [], 0


class Recorder:
    """A span around the engine's calls into the model step: keeps each
    call's positions and advance mask (device tensors, no copy), to count
    FLOPs and live K/V positions after the fact."""

    def __init__(self, api):
        self.calls, self.on = [], False
        inner = api.paged_decode_step

        def wrapped(params, cache, tokens, positions, page_table,
                    advance=None):
            if self.on:
                self.calls.append((positions, advance))
            return inner(params, cache, tokens, positions, page_table,
                         advance)
        self.wrapped_api = api._replace(paged_decode_step=wrapped)

    def contexts(self):
        """Per recorded call: (context lengths of the slots that advance,
        lengths the attention kernel is handed for every slot)."""
        out = []
        for pos, adv in self.calls:
            p = pos.cpu().numpy().astype(np.int64) + 1
            a = (np.ones_like(p, bool) if adv is None
                 else adv.cpu().numpy().astype(bool))
            out.append((p[a].tolist(), p.tolist()))
        return out


def build(cell: dict, seed: int, device):
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    s, tr = shape(cell["config"]), cell["traffic"]
    cfg = port_config(s, cell["config"]["name"])
    tree = weights.make_tree(s, seed, device)
    api = build_model(cfg, device=device)
    rec = Recorder(api)
    eng = ServeEngine(rec.wrapped_api, api.params_from_tree(tree),
                      n_slots=tr["slots"], page_size=tr["page"],
                      max_len=tr["max_len"])
    return s, tree, eng, rec


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from portbench import trace as tracing

    tr = cell["traffic"]
    s, tree, eng, rec = build(cell, seed, device)
    pairs = lengths(seed, tr)
    nxt = [0]
    clients, done = [None] * tr["clients"], []

    def submit(c, t):
        prompt, out = request(seed, pairs, s["vocab"], nxt[0])
        nxt[0] += 1
        clients[c] = Client(eng.submit(prompt, out), t)

    def after_step(t):
        for c, cl in enumerate(clients):
            if cl is None:
                continue
            g = len(cl.req.generated)
            if g > cl.seen:
                cl.times += [t] * (g - cl.seen)
                cl.seen = g
            if cl.req.done:
                done.append(cl)
                submit(c, t)

    eng.warmup()
    ramp = tr["ramp_steps"]
    arrive = [c * ramp // tr["clients"] for c in range(tr["clients"])]
    for k in range(ramp):
        now = time.perf_counter()
        for c in range(tr["clients"]):
            if arrive[c] == k:
                submit(c, now)
        eng.step()
        after_step(time.perf_counter())

    # -- the window ---------------------------------------------------------
    common.open_window(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    rec.on = trace
    w_steps = 0
    while True:
        eng.step()
        w_steps += 1
        t = time.perf_counter()
        after_step(t)
        if t - t0 >= seconds:
            break
    t1 = time.perf_counter()
    common.close_window(device)
    rec.on = False
    window_s = t1 - t0

    everyone = done + [c for c in clients if c is not None]
    tokens = sum(1 for c in everyone for x in c.times if t0 <= x <= t1)
    ttft = [c.times[0] - c.t_submit for c in everyone
            if c.times and t0 <= c.times[0] <= t1]
    itl = [b - a for c in everyone for a, b in zip(c.times, c.times[1:])
           if t0 <= b <= t1]
    finished = [c for c in done if t0 <= c.times[-1] <= t1]

    record = None
    if trace:
        n_win = len(rec.calls)
        rec.on = True

        def stretch():
            for _ in range(tr["trace_steps"]):
                eng.step()
                after_step(time.perf_counter())
        prof = tracing.profile(stretch, lambda: common.sync(device))
        rec.on = False
        ctx = rec.contexts()
        record = {"kind": "serve", "shape": s, "traffic": tr,
                  "window_s": window_s, "window_steps": w_steps,
                  "window_contexts": [a for a, _ in ctx[:n_win]],
                  "prof": prof, "prof_steps": tr["trace_steps"],
                  "prof_lengths": [b for _, b in ctx[n_win:]],
                  "pool_elem": 2 if s["dtype"] == "bfloat16" else 4,
                  "max_pages": eng.max_pages}
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    short = sum(1 for c in finished
                if len(c.req.generated) != c.req.max_new_tokens)

    # -- the reference over a sample of the window's finished requests -------
    served = [(c.req.prompt, list(c.req.generated)) for c in finished]
    del eng, rec, clients
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    sample = pick(served, seed, tr["check"])
    if sample:
        with strict_fp32():
            logits = ref_serve.served_logits(tree, s, sample)
            gaps = torch.cat([ref_serve.gaps(lg, g)
                              for lg, (_, g) in zip(logits, sample)])
    else:                                # nothing finished: nothing sound
        gaps = torch.tensor([float("inf")])
    numbers = gap_numbers(gaps, cell["limits"])
    return {
        "attempted": len(finished), "failed": short,
        "e2e": {"serve_tokens_per_s": (tokens / window_s, "tokens/s"),
                "itl_ms_p95": (1e3 * float(np.percentile(itl, 95)), "ms"),
                "ttft_ms_p95": (1e3 * float(np.percentile(ttft, 95)), "ms"),
                "setup_s": (setup_s, "s")},
        "record": record, "memory_peak_bytes": peak, "numbers": numbers,
        "readings": {"served_gap_max": float(gaps.max()), "sample": [
            (len(p), len(g)) for p, g in sample],
            "ttft_n": len(ttft), "itl_n": len(itl),
            "sample_requests": sample},
    }


def gap_numbers(gaps, limits: dict) -> list:
    """The mean, over every checked token, of the gap by which a served
    token's logit lies below the reference's best.  (The widest gap is
    kept as a reading and not compared: a bf16 router input one rounding
    from a tie sends a token to another expert, so it swings from seed to
    seed as far as the fp8 control's does; PERF.md gives the readings.)"""
    return [{"name": "served_gap_mean", "value": float(gaps.mean()),
             "limit": limits["served_gap_mean"]}]


def pick(served, seed: int, check: dict):
    """A sample of the finished requests drawn from the seed: the
    longest, then ``check["requests"] - 1`` others in a seeded order."""
    if not served:
        return []
    order = sorted(range(len(served)),
                   key=lambda i: -(len(served[i][0]) + len(served[i][1])))
    rng = np.random.default_rng([int(seed), 0xC4EC])
    rest = [order[0]] + [int(i) for i in rng.permutation(order[1:])]
    return [served[i] for i in rest[:check["requests"]]]
