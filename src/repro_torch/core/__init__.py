"""The port's multi-learner core: the flat parameter store, gossip
topologies and schedules, the algorithms, ``MultiLearnerTrainer`` with its
probe seam, and the paper's instruments (diagnostics, smoothing)."""
from .diagnostics import DiagStats, compute_diagnostics
from .dpsgd import AlgoConfig, perturb_weights
from .flatstate import LANE, ROW_ALIGN, FlatMeta, flat_meta
from .schedule import GossipSchedule, make_schedule, spectral_gap_profile
from .smoothing import estimate_smoothness, smoothed_grad, smoothed_loss
from .trainer import MultiLearnerTrainer, ProbeHook, StepMetrics, TrainState

__all__ = ["AlgoConfig", "DiagStats", "FlatMeta", "GossipSchedule", "LANE",
           "MultiLearnerTrainer", "ProbeHook", "ROW_ALIGN", "StepMetrics",
           "TrainState", "compute_diagnostics", "estimate_smoothness",
           "flat_meta", "make_schedule", "perturb_weights", "smoothed_grad",
           "smoothed_loss", "spectral_gap_profile"]
