"""The port's crash-safe checkpoints against the reference's (DESIGN §15).

  * a writer killed mid-write leaves no visible checkpoint and no
    temporary file;
  * restore falls back past a truncated newest file, and an explicit
    corrupt step raises; a flipped byte inside a payload is caught;
  * bf16 leaves round-trip bitwise (stored as their bits, tagged);
  * files interchange with the reference's in both directions: a float32 /
    int32 / bool tree written by either package verifies and restores in
    the other, bitwise (the same keys, the same digest);
  * an elastic trainer's state, saved as its ``state_view`` mid-run under a
    supervisor, restores through ``state_from_view`` bitwise and trains on
    as the state it was saved from.
"""
import glob
import os
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import (latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.core import (AlgoConfig, FaultPlan,  # noqa: E402
                              Membership, MultiLearnerTrainer, Supervisor)
from repro_torch.data import ShardedLoader, TemplateImages  # noqa: E402
from repro_torch.models import fcnet  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TREE = {"w": torch.arange(12.0).reshape(3, 4), "t": torch.tensor(7)}


class Pair(NamedTuple):
    mask: object
    count: object = None


def _mixed_tree(lib):
    """The same tree of float32, int32 and bool leaves in both packages'
    array types, with a nested dict, a list and a NamedTuple."""
    rng = np.random.default_rng(0)
    vals = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": np.arange(6, dtype=np.int32).reshape(2, 3),
            "c": np.array([True, False, True]),
            "d": np.array(2.5, np.float32)}
    arr = torch.from_numpy if lib == "torch" else jnp.asarray
    return {"params": {"w": arr(vals["a"]), "layers": [arr(vals["b"]),
                                                      arr(vals["d"])]},
            "members": Pair(mask=arr(vals["c"]), count=arr(vals["b"][0]))}


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_kill_mid_write_leaves_no_visible_checkpoint(tmp_path, monkeypatch):
    d = str(tmp_path)
    save_checkpoint(d, 1, TREE)

    class Bomb:                 # the writer dies while converting a leaf
        def __array__(self, *a, **k):
            raise KeyboardInterrupt("killed mid-serialize")

    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(d, 2, {"w": Bomb()})

    def torn_savez(f, **arrays):            # ... or halfway through the file
        f.write(b"PK\x03\x04partial")
        raise KeyboardInterrupt("killed mid-write")
    monkeypatch.setattr(ckpt_mod.np, "savez", torn_savez)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(d, 3, TREE)
    assert latest_step(d) == 1
    assert not glob.glob(os.path.join(d, "*.tmp"))
    monkeypatch.undo()
    tree, step = restore_checkpoint(d, TREE)
    assert step == 1 and torch.equal(tree["w"], TREE["w"])
    assert tree["t"].dtype == torch.int64 and int(tree["t"]) == 7


def test_restore_falls_back_past_corrupt_latest(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 10, TREE)
    path20 = save_checkpoint(d, 20, TREE)
    data = open(path20, "rb").read()
    open(path20, "wb").write(data[:len(data) // 2])      # a torn file
    assert not verify_checkpoint(d, 20) and verify_checkpoint(d, 10)
    tree, step = restore_checkpoint(d, TREE)
    assert step == 10
    with pytest.raises(ValueError, match="corrupt"):
        restore_checkpoint(d, TREE, step=20)
    os.remove(os.path.join(d, "ckpt_10.npz"))
    with pytest.raises(FileNotFoundError, match="no uncorrupted"):
        restore_checkpoint(d, TREE)


def test_restore_detects_bit_flip(tmp_path):
    d = str(tmp_path)
    path = save_checkpoint(d, 5, TREE)
    blob = bytearray(open(path, "rb").read())
    off = blob.find(np.float32(5.0).tobytes())     # inside w's payload
    assert off > 0
    blob[off] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    assert not verify_checkpoint(d, 5)
    with pytest.raises(FileNotFoundError, match="no uncorrupted"):
        restore_checkpoint(d, TREE)
    assert not jax_ckpt.verify_checkpoint(d, 5)


def test_bf16_round_trips_bitwise(tmp_path):
    d = str(tmp_path)
    gen = torch.Generator().manual_seed(0)
    tree = {"h": torch.randn((6, 7), generator=gen).to(torch.bfloat16),
            "f": torch.randn((3,), generator=gen),
            "z": torch.tensor([-0.0, float("inf")], dtype=torch.bfloat16)}
    save_checkpoint(d, 1, tree)
    back, _ = restore_checkpoint(d, tree)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        bits = torch.int16 if tree[k].dtype == torch.bfloat16 else \
            torch.int32
        assert torch.equal(back[k].view(bits), tree[k].view(bits))
    with np.load(os.path.join(d, "ckpt_1.npz")) as data:
        assert data["h"].dtype == np.uint16
        assert bytes(data[ckpt_mod.BF16_KEY]).decode().split("\n") == [
            "h", "z"]
    assert jax_ckpt.verify_checkpoint(d, 1)     # the digest is shared


def test_reference_file_restores_in_the_port(tmp_path):
    d = str(tmp_path)
    jax_ckpt.save_checkpoint(d, 3, _mixed_tree("jax"))
    assert verify_checkpoint(d, 3) and latest_step(d) == 3
    back, step = restore_checkpoint(d, _mixed_tree("torch"))
    assert step == 3 and isinstance(back["members"], Pair)
    _assert_trees_equal(back, _mixed_tree("torch"))


def test_port_file_restores_in_the_reference(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 4, _mixed_tree("torch"))
    assert jax_ckpt.verify_checkpoint(d, 4)
    back, step = jax_ckpt.restore_checkpoint(d, _mixed_tree("jax"))
    assert step == 4
    _assert_trees_equal(back, _mixed_tree("jax"))
    # the same tree gives the same file content: keys and digest
    jax_ckpt.save_checkpoint(d, 5, _mixed_tree("jax"))
    with np.load(os.path.join(d, "ckpt_4.npz")) as a, \
            np.load(os.path.join(d, "ckpt_5.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert bytes(a["__digest__"]) == bytes(b["__digest__"])


def test_elastic_state_round_trip_under_supervisor(tmp_path):
    n = 5
    loader = ShardedLoader(TemplateImages(), n_learners=n, local_batch=32,
                           seed=0, device="cpu")
    params = fcnet.init_params(torch.Generator().manual_seed(0), in_dim=784,
                               hidden=50)

    def trainer():
        return MultiLearnerTrainer(
            fcnet.loss_fn, optim.sgd(0.1, momentum=0.9),
            AlgoConfig(algo="adpsgd", topology="random_pair", n_learners=n,
                       max_staleness=2), device="cpu")

    tr = trainer()
    mem = Membership(n)
    st = tr.set_membership(tr.init(1, params), mem)
    sup = Supervisor(tr, mem, FaultPlan.crash_rejoin(1, 2))
    st, _ = sup.run(st, loader.batch, steps=4)
    view = tr.state_view(st)
    saved = [x.clone() if isinstance(x, torch.Tensor) else x
             for x in tree_leaves(view)]
    save_checkpoint(str(tmp_path), st.step, view)

    tr2 = trainer()
    tr2.init(9, params)                     # another store, other values
    back, step = restore_checkpoint(str(tmp_path), tr2.state_view(
        tr2.set_membership(tr2.init(9, params), Membership(n))))
    assert step == 4 and back.step == 4 and back.seed == 1
    st2 = tr2.state_from_view(back)
    restored = tree_leaves(tr2.state_view(st2))
    assert len(restored) == len(saved)
    for a, b in zip(restored, saved):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    assert not bool(st2.members.active[1])
    st, m = tr.train_step(st, loader.batch(4))
    st2, m2 = tr2.train_step(st2, loader.batch(4))
    assert torch.equal(st.params, st2.params)
    assert float(m.loss) == float(m2.loss)
