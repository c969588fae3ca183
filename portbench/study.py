"""The readings a cell's limits are set from, on the card, in one process:

- the program's numbers on each of ``--seeds`` (sound runs: the lower
  readings are their largest);
- the control on the first ``--control`` seeds: the plain reference in the
  nearest precision below the configuration's, in the program's place
  (training, float32 -> TF32 products; serving, bf16 -> fp8 e4m3
  operands, the token it puts first at each position of the same prompts
  and served tokens, its gap read in the float32 reference);
- each fault of ``faults.py`` the cell can have, on the first ``--faults``
  seeds.

    python3 -m portbench.study --workload <cell> --seeds 1,2,3 \
        --control 3 --faults 3 --seconds <s> [--fault-seconds <s>] \
        --out <file.jsonl>

Each reading is one JSON line in ``--out``; the last line sums them up:
per number, the largest sound reading and the smallest control and fault
readings.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def control_train(cell, seed, readings, device):
    """The TF32 reference against the float32 one, as the program would
    be compared."""
    from portbench import weights
    from portbench.model import shape
    from portbench.reference import dpsgd
    from portbench.reference.model import strict_fp32
    from portbench.traffic import train
    import torch

    s, tr = shape(cell["config"]), cell["traffic"]
    K = tr["check_steps"]
    tree = weights.make_tree(s, seed, device)
    pool = train.batches(seed, tr, s["vocab"], device)[:K]
    tables = [tuple(torch.as_tensor(x, device=device) for x in r)
              for r in train.matchings(seed, tr["learners"], K)]
    recipe = {k: tr[k] for k in ("lr", "momentum", "warmup_steps",
                                 "lr_scale")}
    with strict_fp32(tf32=True):
        low = dpsgd.run(tree, s, pool, tables, recipe, steps=K)
    return train.compare(low, readings["reference"], cell["limits"])


def control_serve(cell, seed, readings, device):
    """fp8 operands in the reference's place: at each position of the
    sampled prompts and served tokens, the token it puts first, read in
    the float32 reference."""
    from portbench import weights
    from portbench.model import shape
    from portbench.reference import model as ref
    from portbench.reference import serve
    from portbench.traffic import serve_closed
    import torch

    s = shape(cell["config"])
    tree = weights.make_tree(s, seed, device)
    sample = readings["sample_requests"]
    with ref.strict_fp32():
        f32 = serve.served_logits(tree, s, sample)
        low = serve.served_logits(tree, s, sample, ref.Ops(fp8=True))
    gaps = torch.cat([serve.gaps(a, b.argmax(-1).tolist())
                      for a, b in zip(f32, low)])
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(f32, low))
    del tree
    return serve_closed.gap_numbers(gaps, cell["limits"]) + [
        {"name": "served_gap_max", "value": float(gaps.max()),
         "limit": None},
        {"name": "top1_agreement", "value": agree / len(gaps),
         "limit": None}]


def look_serve(cell, seed, readings, device, near: float = 0.02):
    """Where the widest gaps come from: the float32 reference over the
    sampled requests with each MoE layer's router margins kept (the logit
    of the last expert chosen minus the first left out).  Among the
    served positions, and among those whose gap passes 0.2, the share
    with a near tie (a margin under ``near``) in some MoE layer at that
    position."""
    from portbench import weights
    from portbench.model import shape
    from portbench.reference import model as ref
    from portbench.reference import serve
    import torch

    s = shape(cell["config"])
    tree = weights.make_tree(s, seed, device)
    sample = readings["sample_requests"]
    ops = ref.Ops(margins=[])
    with ref.strict_fp32():
        f32 = serve.served_logits(tree, s, sample, ops)
    tie = torch.stack(ops.margins).min(0).values < near
    lens = [len(p) + len(g) - 1 for p, g in sample]
    every, every_tie, big, big_tie = 0, 0, 0, 0
    for (p, g), lg, t in zip(sample, f32, torch.split(tie, lens)):
        gaps = serve.gaps(lg, g)
        at = t[len(p) - 1:len(p) - 1 + len(g)]
        b = gaps > 0.2
        every, every_tie = every + len(g), every_tie + int(at.sum())
        big, big_tie = big + int(b.sum()), big_tie + int((b & at).sum())
    del tree
    return {"positions": every, "near_tie_share": every_tie / every,
            "big_gaps": big,
            "big_gaps_near_tie_share": big_tie / big if big else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--fault-seconds", type=float, default=None)
    ap.add_argument("--look", type=int, default=0,
                    help="serve: the router-margin look on the first n "
                         "seeds")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT / "src"))
    from portbench import faults, run, spec

    run.caches()
    cell = spec.cell(args.workload)
    kind = cell["traffic"]["kind"]
    seeds = [int(x) for x in args.seeds.split(",")]
    out = open(args.out, "a")

    def emit(**kw):
        out.write(json.dumps(kw) + "\n")
        out.flush()
        print(json.dumps(kw)[:400], flush=True)

    best = {"sound": {}, "control": {}, "fault": {}}

    def note(tag, numbers, label=""):
        for x in numbers:
            if x["limit"] is None:
                continue
            key = x["name"] + (f"/{label}" if label else "")
            old = best[tag].get(key)
            better = (max if tag == "sound" else min)
            best[tag][key] = x["value"] if old is None else better(
                old, x["value"])

    for i, seed in enumerate(seeds):
        res = run.execute(args.workload, seed, args.seconds, False)
        nums = [{"name": k, **v} for k, v in res["checks"].items()]
        emit(what="sound", seed=seed, numbers=nums,
             metrics=res["metrics"], device=res["device"],
             readings=_small(res["_readings"]))
        note("sound", nums)
        if i < args.control:
            ctl = (control_train if kind == "train" else control_serve)(
                cell, seed, res["_readings"], "cuda")
            emit(what="control", seed=seed, numbers=ctl)
            note("control", ctl)
        if i < args.look and kind == "serve_closed":
            emit(what="look", seed=seed, **look_serve(
                cell, seed, res["_readings"], "cuda"))
        del res
        _free()
    for name, fault in (faults.TRAIN if kind == "train"
                        else faults.SERVE).items():
        for seed in seeds[:args.faults]:
            with fault():
                res = run.execute(args.workload, seed,
                                  args.fault_seconds or args.seconds, False)
            nums = [{"name": k, **v} for k, v in res["checks"].items()]
            emit(what="fault", fault=name, seed=seed, numbers=nums,
                 correct=res["correct"])
            note("fault", nums, name)
            del res
            _free()
    emit(what="summary", **best)
    return 0


def _small(readings):
    """The readings without the served requests' token lists."""
    if not isinstance(readings, dict):
        return readings
    return {k: v for k, v in readings.items() if k != "sample_requests"}


if __name__ == "__main__":
    sys.exit(main())
