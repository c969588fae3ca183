"""The port's multi-learner core: the flat parameter store, gossip
topologies and schedules, the algorithms, ``MultiLearnerTrainer`` with its
probe seam, elastic membership with its fault harness, and the paper's
instruments (diagnostics, smoothing)."""
from .diagnostics import DiagStats, compute_diagnostics
from .dpsgd import AlgoConfig, perturb_weights
from .faults import FaultEvent, FaultPlan, FaultReport, Supervisor, apply_plan
from .flatstate import LANE, ROW_ALIGN, FlatMeta, flat_meta
from .membership import Membership, MemberState, admit
from .schedule import (GossipSchedule, make_schedule, reschedule,
                       spectral_gap_profile)
from .smoothing import estimate_smoothness, smoothed_grad, smoothed_loss
from .topology import make_mixing_fn
from .trainer import MultiLearnerTrainer, ProbeHook, StepMetrics, TrainState

__all__ = ["AlgoConfig", "DiagStats", "FaultEvent", "FaultPlan",
           "FaultReport", "FlatMeta", "GossipSchedule", "LANE", "MemberState",
           "Membership", "MultiLearnerTrainer", "ProbeHook", "ROW_ALIGN",
           "StepMetrics", "Supervisor", "TrainState", "admit", "apply_plan",
           "compute_diagnostics", "estimate_smoothness", "flat_meta",
           "make_mixing_fn", "make_schedule", "perturb_weights",
           "reschedule", "smoothed_grad", "smoothed_loss",
           "spectral_gap_profile"]
