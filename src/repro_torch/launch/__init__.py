"""The launch path on ``torch.distributed`` — the port of ``repro/launch``:
learner groups and device meshes (``mesh``), the reference's sharding
rules (``sharding``), a learner's shard store over its model group
(``shardstore``), the production step builders, one learner a rank or a
learner spanning a mesh's model axis (its weights gathered whole or a
period at a time), the sharded probe, serving under the model axis (the
sharded prefill, the sequence-sharded decode) and the spec builders
(``train``), the closed-form FLOP and byte counts (``analytic``) and the
meta-device dry run (``dryrun``)."""
from .mesh import (MeshShape, init_learner_group, init_mesh, learner_rank,
                   make_mesh, n_learners)

__all__ = ["MeshShape", "init_learner_group", "init_mesh", "learner_rank",
           "make_mesh", "n_learners"]
