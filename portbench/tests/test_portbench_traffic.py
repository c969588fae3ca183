"""Traffic is a function of the seed: the same seed gives the same inputs,
another seed other inputs over the same sizes."""
from __future__ import annotations

import collections

import torch

BIG = 2 ** 31 + 123_456_789


def _serve_mix():
    from portbench import spec
    return spec.cell("serve.jamba.closed")["traffic"]


def test_serve_requests_repeat_from_the_seed():
    from portbench.traffic import serve_closed
    tr = _serve_mix()
    m = tr["sizes"]

    def subs(seed):
        pairs = serve_closed.lengths(seed, tr)
        return [serve_closed.request(seed, pairs, 65536, k)
                for k in range(2 * m)]
    a, b, c = subs(BIG), subs(BIG), subs(BIG + 1)
    assert a == b
    assert a != c
    assert len(serve_closed.lengths(BIG, tr)) == m
    # the pairs cycle; the ids are fresh in every submission
    assert [(len(p), o) for p, o in a[:m]] == [(len(p), o) for p, o in a[m:]]
    assert len({tuple(p) for p, _ in a}) == 2 * m


def test_serve_sizes_are_the_same_set_for_every_seed():
    from portbench.traffic import serve_closed
    tr = _serve_mix()
    sizes = [collections.Counter(serve_closed.lengths(s, tr))
             for s in (1, BIG, 7)]
    prompts = [sorted(n for n, _ in serve_closed.lengths(s, tr))
               for s in (1, BIG)]
    outs = [sorted(o for _, o in serve_closed.lengths(s, tr))
            for s in (1, BIG)]
    assert prompts[0] == prompts[1] and outs[0] == outs[1]
    assert sizes[0] != sizes[1]          # paired in another order
    lo, hi = tr["prompt"]["min"], tr["prompt"]["max"]
    assert all(lo <= n <= hi for n in prompts[0])
    assert all(n + o <= tr["max_len"] for (n, o) in sizes[0])


def test_serve_median_lengths_follow_the_mix():
    """The medians are the mix's, and the means the source's that the
    mix names (ShareGPT: 161.31 and 337.99 tokens), within a token."""
    from portbench.traffic import serve_closed
    tr = _serve_mix()
    pairs = serve_closed.lengths(BIG, tr)
    p = sorted(n for n, _ in pairs)
    o = sorted(y for _, y in pairs)
    assert abs(p[len(p) // 2] - tr["prompt"]["median"]) <= 2
    assert abs(o[len(o) // 2] - tr["output"]["median"]) <= 2
    assert abs(sum(p) / len(p) - 161.31) < 1.0
    assert abs(sum(o) / len(o) - 337.99) < 1.0


def test_serve_check_samples_the_longest_then_seeded_others():
    from portbench.traffic import serve_closed
    served = [([1] * n, [2] * g) for n, g in
              ((5, 3), (40, 9), (7, 7), (2, 30), (9, 1), (3, 3))]
    a = serve_closed.pick(served, BIG, {"requests": 4})
    b = serve_closed.pick(served, BIG, {"requests": 4})
    assert a == b and len(a) == 4
    assert a[0] == served[1]             # the longest, prompt + served
    assert len({id(x) for x in a}) == 4
    assert serve_closed.pick([], BIG, {"requests": 4}) == []


def test_training_batches_and_tables_repeat_from_the_seed():
    from portbench.traffic import train
    tr = {"learners": 4, "local_batch": 2, "seq": 16, "pool": 3}
    a = train.batches(BIG, tr, 1000, "cpu")
    b = train.batches(BIG, tr, 1000, "cpu")
    c = train.batches(BIG + 1, tr, 1000, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
    assert not torch.equal(a[0]["tokens"], c[0]["tokens"])
    rows = torch.cat([x["tokens"].reshape(-1, 16) for x in a])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert torch.equal(a[0]["labels"][..., :-1], a[0]["tokens"][..., 1:])
    t1 = train.matchings(BIG, 8, 5)
    t2 = train.matchings(BIG, 8, 5)
    assert all((p1 == p2).all() and (c1 == c2).all()
               for (p1, c1), (p2, c2) in zip(t1, t2))
    for partners, coefs in t1:           # perfect matchings, halves
        p = partners[0]
        assert sorted(p.tolist()) == list(range(8))
        assert all(p[p[i]] == i and p[i] != i for i in range(8))
        assert (coefs == 0.5).all()


def test_weights_repeat_from_the_seed():
    from portbench import common, weights
    from portbench.model import shape
    from conftest import TINY_HYBRID
    s = shape(TINY_HYBRID)
    a = common.flat(weights.make_tree(s, BIG, "cpu"))
    b = common.flat(weights.make_tree(s, BIG, "cpu"))
    c = common.flat(weights.make_tree(s, BIG + 1, "cpu"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
