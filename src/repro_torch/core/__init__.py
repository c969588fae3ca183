"""The port's multi-learner core: the flat parameter store, gossip
topologies and schedules, the algorithms and ``MultiLearnerTrainer``."""
from .dpsgd import AlgoConfig
from .flatstate import LANE, ROW_ALIGN, FlatMeta, flat_meta
from .schedule import GossipSchedule, make_schedule
from .trainer import MultiLearnerTrainer, StepMetrics, TrainState

__all__ = ["AlgoConfig", "FlatMeta", "GossipSchedule", "LANE",
           "MultiLearnerTrainer", "ROW_ALIGN", "StepMetrics", "TrainState",
           "flat_meta", "make_schedule"]
