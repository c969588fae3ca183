"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
module and function names and never imports it (nor ``jax``).  Entry points
run on ``cuda`` unless the caller asks for ``device="cpu"``
(``repro_torch.device.resolve_device``); on the CPU every kernel wrapper
takes its plain PyTorch version, on a CUDA tensor it launches the
hand-written kernel or raises.

Ported so far (ROADMAP slices 1-3): ``configs`` (transformer-100m),
``models`` (dense decoder, paged decode, the FC net), ``serve``
(``ServeEngine``), ``core`` (``MultiLearnerTrainer``'s flat engine, its
probe seam, diagnostics, smoothing), ``optim``, ``data``, ``landscape``
(probes, AutoLR), ``bench`` (Table 1) and ``kernels``: paged decode
attention, the fused gossip + momentum-SGD update and the Lanczos
reorthogonalization, in CUDA C++.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
