"""The port's multi-learner core: the flat parameter store, gossip
topologies and schedules, the algorithms, ``MultiLearnerTrainer`` with its
probe seam, and the paper's instruments (diagnostics, smoothing)."""
from .diagnostics import DiagStats, compute_diagnostics
from .dpsgd import AlgoConfig
from .flatstate import LANE, ROW_ALIGN, FlatMeta, flat_meta
from .schedule import GossipSchedule, make_schedule
from .smoothing import estimate_smoothness, smoothed_grad, smoothed_loss
from .trainer import MultiLearnerTrainer, ProbeHook, StepMetrics, TrainState

__all__ = ["AlgoConfig", "DiagStats", "FlatMeta", "GossipSchedule", "LANE",
           "MultiLearnerTrainer", "ProbeHook", "ROW_ALIGN", "StepMetrics",
           "TrainState", "compute_diagnostics", "estimate_smoothness",
           "flat_meta", "make_schedule", "smoothed_grad", "smoothed_loss"]
