"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
module and function names and never imports it (nor ``jax``).  Entry points
run on ``cuda`` unless the caller asks for ``device="cpu"``
(``repro_torch.device.resolve_device``); on the CPU every kernel wrapper
takes its plain PyTorch version, on a CUDA tensor it launches the
hand-written kernel or raises.

Ported so far (ROADMAP slices 1-6 and 7a): ``configs`` (the reference's
registry), ``models`` (every family, paged decode, the FC net),
``serve`` (``ServeEngine``, the consensus bridge), ``core``
(``MultiLearnerTrainer``'s two engines, elastic membership, fault plans,
diagnostics, smoothing), ``optim``, ``data``, ``landscape`` (probes,
AutoLR), ``checkpoint``, ``launch`` (one learner per rank on
``torch.distributed``), ``bench`` (the paper twins) and ``kernels``:
paged decode attention, flash attention, the fused gossip +
momentum-SGD updates and the Lanczos reorthogonalization, in CUDA C++.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
