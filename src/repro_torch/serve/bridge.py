"""Consensus-view serving bridge: serve snapshots of a LIVE trainer — the
port of ``repro/serve/bridge.py``.

Decentralized learners never hold one canonical model: each learner a has
its own w_a, and the closest thing to "the model" is the consensus mean
w̄ = (1/n) Σ w_a.  ``ConsensusBridge.snapshot`` takes that mean out of a
running ``MultiLearnerTrainer`` (flat or pytree engine: ``params_tree``
takes both) as a float32 tree in the reference's layout;
``api.params_from_tree`` turns it into the params a ``ServeEngine`` serves
(``set_params`` hot-swaps them).

Because training keeps moving while a snapshot is served, the bridge
measures two gaps:

  * staleness: the trainer steps past the snapshot, and the learner spread
    sigma_w = sqrt(sigma_w^2) at snapshot time and now;
  * served-output divergence: top-1 agreement and logit deltas between the
    snapshot and the live consensus on a probe batch
    (``served_divergence``).

A state with ``members`` set (elastic membership) averages only its ACTIVE
learners, so a crashed learner's parked row never reaches the served mean.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..core.util import (learner_var, masked_learner_mean,
                         masked_learner_var)
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ConsensusSnapshot:
    params: Any               # consensus mean: float32 single-learner tree
    step: int                 # trainer step the snapshot was taken at
    consensus_dist: float     # sigma_w = sqrt(sigma_w^2) at snapshot time
    n_active: int = 0         # learners averaged into the mean


class ConsensusBridge:
    """Snapshot the consensus mean out of a live trainer for serving."""

    def __init__(self, trainer):
        self.trainer = trainer

    def _stacked(self, state):
        return self.trainer.params_tree(state)

    @staticmethod
    def _active(state):
        members = getattr(state, "members", None)
        return None if members is None else members.active

    def snapshot(self, state) -> ConsensusSnapshot:
        stacked = self._stacked(state)
        act = self._active(state)
        with torch.no_grad():
            if act is None:
                mean = tree_map(lambda x: torch.mean(x.float(), dim=0),
                                stacked)
                dist = float(torch.sqrt(learner_var(stacked)))
                n_act = tree_leaves(stacked)[0].shape[0]
            else:
                mean = tree_map(lambda x: x.float(),
                                masked_learner_mean(stacked, act))
                dist = float(torch.sqrt(masked_learner_var(stacked, act)))
                n_act = int(torch.sum(torch.as_tensor(act,
                                                      dtype=torch.bool)))
        return ConsensusSnapshot(params=mean, step=int(state.step),
                                 consensus_dist=dist, n_active=int(n_act))

    def staleness(self, state, snap: ConsensusSnapshot) -> Dict[str, float]:
        """How far the live trainer has moved past a served snapshot."""
        stacked = self._stacked(state)
        act = self._active(state)
        with torch.no_grad():
            now = (learner_var(stacked) if act is None
                   else masked_learner_var(stacked, act))
        return {
            "steps_behind": int(state.step) - snap.step,
            "consensus_dist_snapshot": snap.consensus_dist,
            "consensus_dist_now": float(torch.sqrt(now)),
        }


def served_divergence(api, params_served, params_live,
                      tokens) -> Dict[str, float]:
    """Logit-level gap between a served snapshot and the live consensus.

    ``params_served`` / ``params_live``: the params ``api.apply`` takes, or
    a tree in the reference's layout (a snapshot's ``params``), which
    ``api.params_from_tree`` converts.  tokens: (B, S) int probe prompts.
    Both run the same prefill forward; returns top-1 agreement over all
    positions and the mean / max absolute logit deltas over the logical
    vocab."""
    def params(p):
        return api.params_from_tree(p) if isinstance(p, dict) else p

    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                       device=api.device)}
    v = api.cfg.vocab
    with torch.no_grad():
        a = api.apply(params(params_served), batch)[..., :v].float()
        b = api.apply(params(params_live), batch)[..., :v].float()
        agree = torch.mean((a.argmax(-1) == b.argmax(-1)).float())
        diff = (a - b).abs()
        return {"top1_agreement": float(agree),
                "mean_abs_logit_diff": float(diff.mean()),
                "max_abs_logit_diff": float(diff.max())}
