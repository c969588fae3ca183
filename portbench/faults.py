"""Faults planted in the timed path, underneath the harness, to show that
the comparison catches them (``tests/test_portbench_faults.py`` on the
CPU; ``study.py`` on the card).  Each is a context manager that patches
the program while it is active.

- ``unchanged``:   a training step returns its state unchanged;
- ``half_batch``:  each learner's loss is taken over the first half of
                   its rows, the mean over those;
- ``no_exchange``: the gossip kernel's neighbour term left out (each
                   learner keeps its own weights);
- ``token``:       a served token altered where it is produced (the
                   engine's argmax read-back plus one);
- ``frozen``:      a serve step leaves the recurrent state unchanged.
"""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def unchanged():
    from repro_torch.core.trainer import MultiLearnerTrainer
    orig = MultiLearnerTrainer.train_step

    def step(self, state, *a, **k):
        _, m = orig(self, state, *a, **k)
        return state, m
    with mock.patch.object(MultiLearnerTrainer, "train_step", step):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.core import trainer as tmod
    orig = tmod.backward_into

    def half(loss_fn, bound, batch):
        rows = next(iter(batch.values())).shape[0]
        return orig(loss_fn, bound,
                    {k: v[:max(rows // 2, 1)] for k, v in batch.items()})
    with mock.patch.object(tmod, "backward_into", half):
        yield


@contextlib.contextmanager
def no_exchange():
    from repro_torch.kernels import ops
    orig = ops.flat_gossip_update

    def alone(w, remote, grads, momentum, partners, coefs, **kw):
        c = coefs.clone()
        c[:, 0] = 1.0
        c[:, 1:partners.shape[0] + 1] = 0.0
        return orig(w, remote, grads, momentum, partners, c, **kw)
    with mock.patch.object(ops, "flat_gossip_update", alone):
        yield


@contextlib.contextmanager
def token():
    from repro_torch.serve.engine import ServeEngine
    orig = ServeEngine._run

    def run(self, *a):
        best = orig(self, *a)
        return (best + 1) % self.api.cfg.vocab
    with mock.patch.object(ServeEngine, "_run", run):
        yield


@contextlib.contextmanager
def frozen():
    from repro_torch.models import transformer
    with mock.patch.object(transformer, "_write_state",
                           lambda cc, new_cc, advance=None: None):
        yield


TRAIN = {"unchanged": unchanged, "half_batch": half_batch,
         "no_exchange": no_exchange}
SERVE = {"token": token, "frozen": frozen}
