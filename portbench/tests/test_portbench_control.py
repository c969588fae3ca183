"""The controls on the card: the plain reference, in the nearest precision
below the configuration's, put in the program's place, must come out as
not correct against each cell's limits.  At the published widths, with
fewer learners and rows or fewer served tokens than a run, so that a test
run holds them.  ``study.py`` reads the same controls at the cells' own
sizes on three seeds or more.

    PYTHONPATH=src python -m pytest -q -m cuda portbench/tests
"""
from __future__ import annotations

import pytest
import torch

SEED = 2 ** 31 + 4242


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train.t100m.dpsgd",
                                  "train.t100m.flash4k"])
def test_tf32_training_control_is_not_correct(cuda, cell):
    from portbench import common, spec, weights
    from portbench.model import shape
    from portbench.reference import dpsgd
    from portbench.reference.model import strict_fp32
    from portbench.traffic import train

    c = spec.cell(cell)
    s = shape(c["config"])
    tr = dict(c["traffic"], learners=2, local_batch=2, seq=256, pool=3)
    tree = weights.make_tree(s, SEED, "cuda")
    pool = train.batches(SEED, tr, s["vocab"], "cuda")
    tables = [tuple(torch.as_tensor(x, device="cuda") for x in r)
              for r in train.matchings(SEED, 2, 3)]
    recipe = {k: tr[k] for k in ("lr", "momentum", "warmup_steps",
                                 "lr_scale")}
    with strict_fp32():
        f32 = dpsgd.run(tree, s, pool, tables, recipe, steps=3)
    with strict_fp32(tf32=True):
        low = dpsgd.run(tree, s, pool, tables, recipe, steps=3)
    numbers = train.compare(low, f32, c["limits"])
    assert not common.verdict(numbers), numbers


@pytest.mark.cuda
def test_fp8_serving_control_is_not_correct(cuda):
    from portbench import spec, weights
    from portbench.model import shape
    from portbench.reference import model as ref
    from portbench.reference import serve

    c = spec.cell("serve.jamba.closed")
    s = shape(c["config"])
    tree = weights.make_tree(s, SEED, "cuda")
    gen = torch.Generator().manual_seed(SEED)
    reqs = [(torch.randint(0, s["vocab"], (n,), generator=gen).tolist(),
             torch.randint(0, s["vocab"], (m,), generator=gen).tolist())
            for n, m in ((200, 120), (60, 100))]
    with ref.strict_fp32():
        f32 = serve.served_logits(tree, s, reqs)
        low = serve.served_logits(tree, s, reqs, ref.Ops(fp8=True))
    gaps = torch.cat([serve.gaps(a, b.argmax(-1).tolist())
                      for a, b in zip(f32, low)])
    assert float(gaps.mean()) > c["limits"]["served_gap_mean"], gaps.mean()
