"""The launch path on ``torch.distributed`` — the port of ``repro/launch``
(slice 7a): the learner group (``mesh``), the production step builders
with one learner per rank (``train``) and the closed-form FLOP and byte
counts (``analytic``).  Sharding a learner over several GPUs, the
sharded probe and the dry run are slice 7b."""
from .mesh import init_learner_group, learner_rank, n_learners

__all__ = ["init_learner_group", "learner_rank", "n_learners"]
