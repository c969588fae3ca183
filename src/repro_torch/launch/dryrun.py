"""The dry run: every (arch x input shape x mesh) built and counted on the
meta device -- the twin of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
        [--algo dpsgd|ssgd] [--gather whole|period]

The reference lowers and compiles each step against 512 forced host
devices and reads the compiled artifact.  Here nothing is allocated and
no process group is made: the spec builders (``train_state_specs``,
``train_state_shardings``, ``params_sharding``, ``batch_sharding``,
``cache_sharding``) run on ``param_shapes`` / meta caches, and a record
gives, per rank of the production mesh ((16, 16) or (2, 16, 16)):

  * ``resident_bytes``: every state part from its spec, each leaf in its
    own dtype cut as the spec cuts it -- params, optimizer state, AD-PSGD's
    buffer, the decode cache; and the port's own float32 shard store
    (``ShardLayout``: the launch step keeps a rank's shard as one (T_local,
    128) float32 store);
  * ``gather_transient_bytes``: what a rank holds full while it computes,
    ``"whole"`` (the learner's float32 store and its gradient, the (M,
    T_local, 128) stack of shards) and ``"period"`` (the non-period
    leaves' and one period's, each with its gradient and its gathered
    stack); serving holds the weights without gradients;
  * ``model_bytes_per_step`` (into a rank over the model group, the mean
    over its M ranks: the broadcast and reduce of a period's leaves cut on
    the period dim land on one rank) and ``gossip_bytes_per_slot`` (one
    shard store in the wire dtype; SSGD's all_reduce of the gradient
    shard), reckoned from the layout;
  * the closed-form flops and bytes per chip (``launch/analytic.py``), the
    model flops and ``useful_flops_ratio`` as the reference defines them;
  * ``counted_flops_per_chip``: ``torch.utils.flop_counter.FlopCounterMode``
    over the step's work on meta tensors -- a training row's forward and
    backward, a prefill row's forward, times the rows a chip takes; a
    decode step of a learner's rows over a rank's slice of the buffer --
    where it runs (the twin of the flops term of the reference's
    ``roofline_from_compiled``; the HLO parser ``roofline.py`` has no
    twin).  It counts matrix products only (no embedding gather, no
    elementwise op), and the chunked attention computes the masked half of
    a causal block too.

Time terms divide by the data-sheet peaks of the NVIDIA H100 80GB HBM3
(SXM5, 700 W; ``H100_*`` below), none a TPU constant.  Records go to
``results/dryrun_torch/`` (one JSON a combination); an error is a record
(``status: error``), as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import ASSIGNED, SHAPES, get_config
from ..core.flatstate import LANE
from ..models import build_model
from ..optim import sgd
from ..tree import tree_flatten_with_path, tree_leaves
from . import analytic
from .mesh import mesh_shape, n_learners, production_mesh_shape
from .sharding import (batch_sharding, cache_sharding, params_sharding,
                       spec_dim)
from .shardstore import ShardLayout
from .train import (decode_cache_shapes, param_shapes, train_state_shardings,
                    train_state_specs)

__all__ = ["SKIPS", "RESULTS_DIR", "decode_buf_len", "local_bytes",
           "step_memory", "build_record", "run_one", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# (arch, shape) pairs skipped by design, with the reference's reason
SKIPS = {
    ("seamless-m4t-large-v2", "long_500k"):
        "enc-dec speech model: 500k-token decode has no meaningful analogue",
}

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet: dense tensor-core bf16,
# float32 outside the tensor cores (the port's float32 products run with
# TF32 off), HBM3, NVLink 4 per direction (900 GB/s both ways)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9
AUDIO_ENC_LEN = 4096        # the reference's fixed stub audio memory


def decode_buf_len(cfg, seq_len: int) -> int:
    """The reference's ``_decode_buf_len``: long-context serving (past 64k)
    uses the sliding-window buffer; shorter decode keeps the context."""
    if seq_len > 65536:
        return min(seq_len, cfg.window)
    return seq_len


def local_bytes(leaf, spec, sizes: dict) -> int:
    """Bytes of a rank's slice of ``leaf`` under ``spec`` (each entry an
    axis name, a tuple of them or None) on a mesh of axis ``sizes``."""
    n = 1
    for d, s in enumerate(leaf.shape):
        entry = spec[d] if d < len(spec) else None
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        cut = 1
        for a in axes:
            cut *= sizes[a]
        n *= s // cut
    return n * leaf.element_size()


def _tree_bytes(tree, specs, sizes) -> int:
    return sum(local_bytes(x, s, sizes)
               for x, s in zip(tree_leaves(tree), tree_leaves(specs)))


def _layout(api, M: int) -> ShardLayout:
    """Model rank 0's ``ShardLayout`` (every rank's has the same sizes)."""
    return ShardLayout(param_shapes(api), M, 0)


def _f32(n_elem: int) -> int:
    return 4 * n_elem


def _gather_bytes(lay: ShardLayout, grads: bool) -> dict:
    """A rank's full buffers while it computes: the whole learner, or the
    non-period leaves and one period (each with its gathered stack)."""
    k = 2 if grads else 1
    whole = k * _f32(lay.full.rows * LANE) + _f32(
        lay.M * lay.local.rows * LANE)
    per = 0
    for sec in filter(None, (lay.rest, lay.period)):
        per += k * _f32(sec.meta.rows * LANE) + _f32(
            lay.M * sec.ag + sec.own)
    return {"whole": whole, "period": per if lay.n_periods else None}


def step_memory(api, model_size: int, algo: str = "dpsgd") -> dict:
    """A mesh training step's device bytes a rank, from the layout: the
    resident float32 shard stores (two parameter stores the step
    alternates, the momentum, the gradient; a receive stack of one slot
    for the gossip, two published buffers for AD-PSGD) and each gather's
    transient (``gather_transient_bytes``).  Activations are not
    counted."""
    lay = _layout(api, model_size)
    n = 4 + (algo != "ssgd") + 2 * (algo == "adpsgd")
    return {"resident": n * _f32(lay.local.rows * LANE),
            "transient": _gather_bytes(lay, grads=True)}


def _model_bytes(lay: ShardLayout, train: bool) -> dict:
    """Bytes into a rank over the model group a step (the mean over the M
    ranks), ``"whole"`` and ``"period"``."""
    M = lay.M
    if M == 1:
        return {"whole": 0, "period": 0}
    f = (M - 1) / M
    if not train:       # serving: the weights once, or a period a step
        rest = _f32((M - 1) * lay.rest.ag + f * lay.rest.own)
        per = (_f32((M - 1) * lay.period.ag + f * lay.period.own)
               if lay.n_periods else 0)
        return {"whole": 0, "period": lay.n_periods * per,
                "whole_once": rest + lay.n_periods * per}
    whole = 2 * _f32((M - 1) * lay.local.rows * LANE) + _f32(lay.n_rep + 2)
    rest = 2 * _f32((M - 1) * lay.rest.ag)
    per = 0
    if lay.n_periods:
        sec = lay.period
        # the gather twice (forward, recompute), the gradient once
        per = lay.n_periods * (3 * _f32((M - 1) * sec.ag)
                               + 3 * _f32(f * sec.own))
    return {"whole": whole, "period": rest + per + _f32(lay.n_rep + 2)}


def _count(fn) -> Optional[float]:
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def _meta_batch(api, rows: int, seq: int):
    spec = api.train_batch_spec(rows, seq)
    return {k: torch.zeros(shape, dtype=dt, device="meta")
            for k, (shape, dt) in spec.items()}


def _counted(api, kind: str, rows_per_chip: float, seq: int, cache,
             b_learner: int):
    """(counted flops per chip, None) or (None, why not)."""
    cfg = api.cfg
    if "slstm" in (cfg.block_period or ()) and kind != "decode":
        return None, (f"the sLSTM's per-position loop: {seq} Python steps "
                      "a layer on the meta device")
    # one attention block a layer: the chunked attention computes every
    # block of the (S, S) scores either way, so the count is the same and
    # the meta device runs a few ops a layer instead of (S / chunk)^2
    tree = param_shapes(api)
    api = build_model(dataclasses.replace(cfg, attn_chunk=max(
        cfg.attn_chunk, seq)), device="meta")
    params = api.params_from_tree(tree)
    if kind == "train":
        batch = _meta_batch(api, 1, seq)

        def run():
            api.loss_fn(params, batch).backward()
        return _count(run) * rows_per_chip, None
    if kind == "prefill":
        batch = _meta_batch(api, 1, seq)

        def run():
            with torch.no_grad():
                api.apply(params, batch)
        return _count(run) * rows_per_chip, None
    toks = torch.zeros((b_learner, 1), dtype=torch.int32, device="meta")

    def run():
        api.decode_step(params, cache, toks, 0)
    return _count(run), None


def _rank_cache(cache, specs, sizes):
    """What a rank's decode computes on, as a meta cache: its learner's
    rows (the batch cut over the learner axes) and, of an attention
    layer, its slice of the buffer (``slot_pos`` cut to the slice's rows
    too), of the encoder-decoder's cross K/V its slice of the encoder
    length; a recurrent state whole (the rank gathers it for the
    update)."""
    out = {}
    for layer, c in cache.items():
        out[layer] = {}
        for n, x in c.items():
            spec = specs[layer][n]
            shape = list(x.shape)
            for d, entry in enumerate(spec):
                axes = entry if isinstance(entry, tuple) else (
                    () if entry is None else (entry,))
                for a in axes:
                    if a != "model" or n in ("k", "v", "xk", "xv"):
                        shape[d] //= sizes[a]
            out[layer][n] = torch.empty(shape, dtype=x.dtype,
                                        device="meta")
        if "slot_pos" in c:
            out[layer]["slot_pos"] = torch.empty(
                (c["slot_pos"].shape[0], out[layer]["k"].shape[2]),
                dtype=c["slot_pos"].dtype, device="meta")
    return out


def build_record(arch: str, shape: str, *, multi_pod: bool, algo: str,
                 gather: str = "whole", extra: Optional[dict] = None,
                 count: bool = True) -> dict:
    """The counts of one (arch, shape, mesh, algo) (``run_one``'s record
    without its name and timing); ``count=False`` leaves out the counted
    flops (the analytic count feeds the time terms)."""
    cfg = get_config(arch)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    seq, gb, kind = SHAPES[shape]
    mesh = production_mesh_shape(multi_pod=multi_pod)
    sizes = mesh_shape(mesh).shape
    n_chips = 1
    for s in sizes.values():
        n_chips *= s
    L, M = n_learners(mesh), sizes["model"]
    api = build_model(cfg, device="cpu")
    lay = _layout(api, M)
    wire = lay.full.wire_dtype().itemsize
    rec = {"arch": arch, "shape": shape, "kind": kind, "n_chips": n_chips,
           "learners": L, "model_size": M, "seq": seq, "global_batch": gb,
           "gather": gather}
    store = _f32(lay.local.rows * LANE)
    rows_per_chip = gb / n_chips
    b_learner = max(gb // L, 1)
    cache = None
    if kind == "train":
        opt = sgd(lr=0.1, momentum=0.9)
        specs = train_state_specs(api, opt, mesh, algo=algo)
        shd = train_state_shardings(specs, mesh, algo=algo)
        batch = api.train_batch_spec(gb, seq)
        batch_meta = {k: torch.empty(s, dtype=dt, device="meta")
                      for k, (s, dt) in batch.items()}
        b_specs = batch_sharding(batch_meta, mesh, stacked=False)
        res = {"params": _tree_bytes(specs.params, shd.params, sizes),
               "opt_state": _tree_bytes(specs.opt_state, shd.opt_state,
                                        sizes),
               "buffer": (_tree_bytes(specs.buffer, shd.buffer, sizes)
                          if specs.buffer is not None else 0),
               "batch": _tree_bytes(batch_meta, b_specs, sizes),
               "cache": 0}
        rec["port_store_bytes"] = {
            "params": store, "momentum": store,
            "buffer": store if algo == "adpsgd" else 0}
        rec["gather_transient_bytes"] = _gather_bytes(lay, grads=True)
        rec["model_bytes_per_step"] = _model_bytes(lay, train=True)
        rec["gossip_bytes_per_slot"] = (
            lay.local.rows * LANE * wire if algo != "ssgd"
            else _f32((lay.local.rows + 1) * LANE))
        a_flops = analytic.train_flops_per_chip(cfg, gb, seq, n_chips)
        a_bytes = analytic.train_bytes_per_chip(cfg, gb, seq, n_chips, L)
        model_flops = 6.0 * cfg.n_active_params() * gb * seq
    else:
        tree = param_shapes(api)
        p_specs = params_sharding(tree, mesh, stacked=False)
        res = {"params": _tree_bytes(tree, p_specs, sizes), "opt_state": 0,
               "buffer": 0, "cache": 0}
        rec["port_store_bytes"] = {"params": store}
        rec["gather_transient_bytes"] = _gather_bytes(lay, grads=False)
        rec["model_bytes_per_step"] = _model_bytes(lay, train=False)
        if kind == "prefill":
            a_flops = analytic.prefill_flops_per_chip(cfg, gb, seq, n_chips)
            a_bytes = analytic.prefill_bytes_per_chip(cfg, gb, seq, n_chips)
            model_flops = 2.0 * cfg.n_active_params() * gb * seq
        else:
            buf = decode_buf_len(cfg, seq)
            full = decode_cache_shapes(api, gb, buf, AUDIO_ENC_LEN)
            c_specs = cache_sharding(full, mesh)
            res["cache"] = _tree_bytes(full, c_specs, sizes)
            cache = _rank_cache(full, c_specs, sizes)
            rec["buf_len"] = buf
            rec["decode_merge_bytes_per_step"] = _merge_bytes(
                api, full, c_specs, sizes, b_learner, M)
            capped = seq > 65536
            a_flops = analytic.decode_flops_per_chip(
                cfg, gb, seq, n_chips, window_capped=capped)
            a_bytes = analytic.decode_bytes_per_chip(
                cfg, gb, seq, n_chips, window_capped=capped)
            model_flops = 2.0 * cfg.n_active_params() * gb
    res["total"] = sum(res.values())
    rec["resident_bytes"] = res
    counted, why = (_counted(api, kind, rows_per_chip, seq, cache,
                             b_learner) if count else (None, "not asked"))
    rec["counted_flops_per_chip"] = counted
    if why:
        rec["counted_flops_skipped"] = why
    flops = counted if counted is not None else a_flops
    link = rec["model_bytes_per_step"][gather] + (
        rec.get("gossip_bytes_per_slot", 0)) + rec.get(
        "decode_merge_bytes_per_step", 0)
    peak = H100_PEAK_FLOPS["bfloat16" if cfg.compute_dtype == "bfloat16"
                           else "float32"]
    times = {"compute_s": flops / peak,
             "memory_s": a_bytes / H100_HBM_BYTES_PER_S,
             "collective_s": link / H100_NVLINK_BYTES_PER_S}
    rec["roofline"] = {
        "flops": flops, "flops_source": "counted" if counted is not None
        else "analytic", "bytes": a_bytes, "link_bytes": link, **times,
        "bound": max(times, key=times.get)[:-2],
        "peaks": "NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet"}
    rec["analytic"] = {"flops_per_chip": a_flops, "bytes_per_chip": a_bytes}
    rec["model_flops_total"] = model_flops
    rec["model_flops_per_chip"] = model_flops / n_chips
    rec["useful_flops_ratio"] = (model_flops / n_chips) / max(flops, 1.0)
    return rec


def _merge_bytes(api, cache, specs, sizes, b_learner: int, M: int) -> int:
    """Bytes into a rank a decode step: each attention's all_gather of (M
    - 1) ranks' B/L x H x (hd + 2) float32 partials (an encoder-decoder
    layer's self- and cross-attention each), each recurrent layer's of (M
    - 1) ranks' slices of its cut state (float32 on the wire)."""
    cfg = api.cfg
    if M == 1:
        return 0
    total = 0
    for (path, x), spec in zip(tree_flatten_with_path(cache),
                               tree_leaves(specs)):
        name, Np = path[-1], x.shape[0]
        if name in ("k", "xk"):
            total += Np * (M - 1) * b_learner * cfg.n_heads * (
                cfg.head_dim_ + 2) * 4
        elif name not in ("v", "slot_pos", "xk", "xv") \
                and spec_dim(spec) is not None:
            elems = local_bytes(x, spec, sizes) // x.element_size()
            total += (M - 1) * elems * 4
    return total


def run_one(arch: str, shape: str, *, multi_pod: bool, algo: str = "dpsgd",
            gather: str = "whole", outdir: str = RESULTS_DIR, tag: str = "",
            extra: Optional[dict] = None, quiet: bool = False) -> dict:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    name = f"{arch}__{shape}__{mesh_name}__{algo}__{gather}"
    if tag:
        name += f"__{tag}"
    if (arch, shape) in SKIPS:
        rec = {"name": name, "status": "skipped",
               "reason": SKIPS[(arch, shape)]}
        _write(outdir, name, rec)
        if not quiet:
            print(json.dumps(rec))
        return rec
    t0 = time.time()
    try:
        rec = {"name": name, "status": "ok", "mesh": mesh_name,
               "algo": algo, **build_record(arch, shape,
                                             multi_pod=multi_pod, algo=algo,
                                             gather=gather, extra=extra)}
        rec["build_s"] = round(time.time() - t0, 1)
    except Exception as e:  # noqa: BLE001 -- a dry-run failure is the signal
        rec = {"name": name, "status": "error", "arch": arch,
               "shape": shape, "mesh": mesh_name, "algo": algo,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    _write(outdir, name, rec)
    if not quiet:
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "traceback"}, indent=1))
    return rec


def _write(outdir, name, rec):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--algo", default="dpsgd", choices=["dpsgd", "ssgd"])
    ap.add_argument("--gather", default="whole", choices=["whole", "period"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    recs = [run_one(arch, shape, multi_pod=args.mesh == "multi",
                    algo=args.algo, gather=args.gather, outdir=args.outdir,
                    tag=args.tag)
            for arch, shape in combos]
    return 0 if all(r["status"] != "error" for r in recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
