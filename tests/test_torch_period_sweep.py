"""``models.model.period_loss`` and ``launch.periodsweep.PeriodSweep``, one
process, on each stacked-period family's smoke config.

  * ``post(rest, body(... body(pre(rest, batch)) ...), batch)`` over the
    periods in order equals ``api.loss_fn`` on the same leaves (the same
    operations: bitwise);
  * the sweep's gradient (reverse, a period at a time) and its H v
    (``torch.func.jvp`` of ``vjp``, a period at a time) over a model group
    of two ranks, each on a thread of this process (``_ThreadComm``: the
    collectives ``LearnerGather`` and the sweep call, through shared
    slots), each rank on its own row of the batch, against
    ``core.util.value_and_grad`` and ``landscape.hvp.make_hvp_fn``
    (reverse over reverse on the whole tree) over the same rows, 1e-5
    relative: the mamba scan, the xLSTM cells, the einsum MoE and M-RoPE
    all run forward-mode.

The sweep on ``GroupComm`` across processes, and the probe built on it,
are held in ``tests/test_torch_mesh_launch.py``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

FAMILIES = ["transformer-100m", "granite-moe-3b-a800m", "jamba-v0.1-52b",
            "xlstm-350m", "qwen2-vl-7b"]
B, SEQ, M, RTOL = 2, 16, 2, 1e-5


class _ThreadComm:
    """Model rank ``rank`` of a group whose ranks are threads sharing
    ``slots``, ``barrier`` and ``lock``: ``GroupComm``'s collectives (SUM
    in rank order).  A rank computes only while it holds ``lock`` and lets
    it go only to wait in a collective, so the ranks take turns:
    ``torch.func.jvp``'s forward-AD levels are global to the process."""

    def __init__(self, rank, slots, barrier, lock):
        self.rank, self.slots = rank, slots
        self.barrier, self.lock = barrier, lock

    def _wait(self):
        self.lock.release()
        try:
            self.barrier.wait()
        finally:
            self.lock.acquire()

    def _exchange(self, t):
        self.slots[self.rank] = t.clone()
        self._wait()
        got = list(self.slots)
        self._wait()
        return got

    def all_gather(self, local, stack):
        for m, x in enumerate(self._exchange(local)):
            stack[m].copy_(x)
        return stack

    def reduce_scatter(self, stack, out):
        return out.copy_(sum(x[self.rank] for x in self._exchange(stack)))

    def all_reduce(self, buf):
        return buf.copy_(sum(self._exchange(buf)))

    def broadcast(self, buf, src):
        return buf.copy_(self._exchange(buf)[src])

    def reduce(self, buf, dst):
        got = self._exchange(buf)
        if self.rank == dst:
            buf.copy_(sum(got))
        return buf

    def release(self):
        pass


def _on_threads(fn):
    """``[fn(comm_j, j) for j in range(M)]``, each on its own thread."""
    slots, barrier = [None] * M, threading.Barrier(M, timeout=120)
    lock = threading.Lock()
    out, errors = [None] * M, []

    def run(j):
        with lock:
            try:
                out[j] = fn(_ThreadComm(j, slots, barrier, lock), j)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)
                barrier.abort()

    threads = [threading.Thread(target=run, args=(j,)) for j in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _setup(name):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import make_synthetic_batch
    cfg = get_config(name).smoke_config()
    api = build_model(cfg, device="cpu")
    tree = api.param_tree(api.init(0))
    batch = make_synthetic_batch(cfg, 1, B, SEQ, device="cpu")
    return api, tree, batch


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("name", FAMILIES)
def test_period_loss_composes_to_loss_fn(name):
    from repro_torch.models.model import period_loss
    from repro_torch.tree import tree_leaves, tree_map
    api, tree, batch = _setup(name)
    parts = period_loss(api.cfg)
    rest = {k: v for k, v in tree.items() if k != "periods"}
    n_periods = tree_leaves(tree["periods"])[0].shape[0]
    pos = parts.positions(batch)
    with torch.no_grad():
        x = parts.pre(rest, batch)
        for p in range(n_periods):
            x = parts.body(tree_map(lambda w: w[p], tree["periods"]), x,
                           pos)
        composed = parts.post(rest, x, batch)
        loss = api.loss_fn(api.params_from_tree(tree), batch)
    assert torch.equal(composed, loss), (float(composed), float(loss))


@pytest.mark.parametrize("name", FAMILIES)
def test_period_sweep_grad_and_hvp_match_the_whole_tree(name):
    from repro_torch.core.util import value_and_grad
    from repro_torch.landscape.hvp import make_hvp_fn
    from repro_torch.launch.periodsweep import PeriodSweep
    from repro_torch.launch.shardstore import ShardLayout
    from repro_torch.launch.train import _model_rows
    from repro_torch.tree import tree_map
    api, tree, batch = _setup(name)
    rng = np.random.default_rng(7)
    v_tree = tree_map(lambda x: torch.from_numpy(
        rng.standard_normal(tuple(x.shape)).astype(np.float32)), tree)

    def rank(comm, j):
        lay = ShardLayout(tree, M, j)
        assert lay.n_periods > 0
        sweep = PeriodSweep(api, lay, comm, "cpu")
        w = lay.flatten_local(tree, device="cpu")
        v = lay.flatten_local(v_tree, device="cpu")
        if j:       # the probe's convention: the replicated tail on rank 0
            lay.rep_tail(v).zero_()
        rows = _model_rows(batch, M, j)
        g = sweep(w, rows, 1.0 / M)
        hv = sweep(w, rows, 1.0 / M, v)
        sweep.release()
        return lay, g, hv, sweep.max_full_bytes

    ranks = _on_threads(rank)
    lay = ranks[0][0]

    def full(i):
        out = torch.zeros((lay.full.rows, 128))
        lay.assemble(torch.stack([r[i] for r in ranks]), out)
        return out

    # the reference: the mean over the ranks' row blocks of each block's
    # loss (an MoE's capacity depends on the rows it routes together)
    pft = api.params_from_tree
    blocks = tree_map(lambda x: x.reshape((M, B // M) + x.shape[1:]), batch)
    g_ref = sum(lay.full.flatten(value_and_grad(
        api.loss_fn, tree, tree_map(lambda x: x[j], blocks), pft)[1])
        for j in range(M)) / M
    assert _rel(full(1), g_ref) < RTOL
    hv_tree = make_hvp_fn(api.loss_fn, tree, blocks,
                          params_from_tree=pft)(v_tree)
    assert _rel(full(2), lay.full.flatten(hv_tree)) < RTOL
    period = lay.period.meta.rows * 128 * 4
    assert all(r[3] <= lay.rest.meta.rows * 128 * 4 + period
               for r in ranks)
