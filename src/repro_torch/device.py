"""Device selection for the port's entry points.

The port runs on the card.  A caller that wants the CPU (the tests, the
CPU half of a parity check) says so with ``device="cpu"``; there is no
silent fallback, so a missing card fails at the entry point instead of
turning a GPU run into a CPU one.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is unavailable); an explicit
    device is taken as given, after the same check for CUDA devices."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default and CUDA is not "
            "available here; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev
