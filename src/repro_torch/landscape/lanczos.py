"""m-step Lanczos on the HVP operator: top Hessian eigenvalues (sharpness) —
the port of ``repro/landscape/lanczos.py``.

The iteration lives on the (T, 128) flat parameter layout of
``core/flatstate.py::FlatMeta`` (the reference's ``flatten_for_kernel``
layout: the same leaf order, offsets and padded row count), so the basis
is one stacked (m + 1, T, 128) float32 tensor and full
reorthogonalization — the memory-bound dot/axpy inner loop — runs through
the CUDA kernels of ``kernels/reorth.py`` (``reorth="ref"`` runs their
plain version; a CPU tensor always does).

Padding: the flat layout zero-pads the last row.  The start vector is
drawn as a tree and flattened (pads zero), and the HVP writes its result
into the leaves' views of a zeroed buffer (pads stay zero), so the
iteration never leaves the zero-pad subspace and the spectrum is H's.

``m`` steps cost m HVPs + 2m reorthogonalization sweeps (CGS2); the
eigenvalues come from the (m, m) tridiagonal eigensolve.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.flatstate import flat_meta
from ..core.util import tree_gaussian_like
from ..kernels.ops import reorthogonalize
from ..tree import tree_leaves
from .hvp import make_hvp_fn

__all__ = ["LanczosResult", "lanczos", "lanczos_pytree", "sharpness"]

_EPS = 1e-30


class LanczosResult(NamedTuple):
    eigenvalues: torch.Tensor   # (m,) Ritz values, ascending
    alphas: torch.Tensor        # (m,) tridiagonal diagonal
    betas: torch.Tensor         # (m-1,) tridiagonal off-diagonal
    basis: torch.Tensor         # (m+1, T, 128) Lanczos vectors (flat view)


def _tridiag_eigvals(alphas, betas):
    t = torch.diag(alphas)
    if betas.numel():
        t = t + torch.diag(betas, 1) + torch.diag(betas, -1)
    return torch.linalg.eigvalsh(t)


def lanczos(matvec_flat: Callable, q0: torch.Tensor, m: int, *,
            reorth: str = "auto") -> LanczosResult:
    """m-step Lanczos for a symmetric operator on the (T, 128) flat view.

    matvec_flat: (T, 128) -> (T, 128); q0: start vector (need not be
    normalized).  Makes no host sync until the eigensolve."""
    T, lane = q0.shape
    q0 = q0.float()
    basis = torch.zeros((m + 1, T, lane), dtype=torch.float32,
                        device=q0.device)
    torch.div(q0, torch.clamp_min(torch.sqrt(torch.sum(q0 * q0)), _EPS),
              out=basis[0])
    live = torch.arange(m + 1, device=q0.device)
    alphas, betas = [], []
    for j in range(m):
        w = matvec_flat(basis[j]).float()
        alphas.append(torch.sum(w * basis[j]))
        # full reorthogonalization against ALL previous vectors (CGS2) —
        # subsumes the textbook alpha/beta subtraction
        mask = (live <= j).float()
        w = reorthogonalize(basis, w, mask, backend=reorth)
        beta_j = torch.sqrt(torch.sum(w * w))
        if j < m - 1:
            betas.append(beta_j)
        # on breakdown (beta ~ 0: an invariant subspace) the normalized
        # vector is junk but its coupling beta is ~0, so Ritz values stand
        torch.div(w, torch.clamp_min(beta_j, _EPS), out=basis[j + 1])
    alphas = torch.stack(alphas)
    betas = (torch.stack(betas) if betas
             else torch.zeros((0,), dtype=torch.float32, device=q0.device))
    return LanczosResult(_tridiag_eigvals(alphas, betas), alphas, betas,
                         basis)


def lanczos_pytree(loss_fn: Callable, params, stacked_batch, *, m: int = 8,
                   gen: Optional[torch.Generator] = None, q0=None,
                   reorth: str = "auto",
                   params_from_tree: Optional[Callable] = None
                   ) -> LanczosResult:
    """Lanczos on the Hessian of the superbatch loss at ``params``
    (``loss_fn(params, batch)``, ``stacked_batch`` leaves (n, B, ...)).
    The start vector is ``q0`` (a tree like ``params``) when given, else
    N(0, 1) drawn from ``gen`` (default: seed 0 on the parameters'
    device).  Each HVP writes into the leaves' views of a zeroed flat
    buffer, so no flatten copy is made per step."""
    meta = flat_meta(params)
    if q0 is None:
        if gen is None:
            dev = tree_leaves(params)[0].device
            gen = torch.Generator(device=dev).manual_seed(0)
        q0 = tree_gaussian_like(gen, params, 1.0)
    hv = make_hvp_fn(loss_fn, params, stacked_batch,
                     params_from_tree=params_from_tree)

    def matvec_flat(v):
        out = torch.zeros_like(v)
        hv(meta.unflatten(v), out=meta.unflatten(out))
        return out
    return lanczos(matvec_flat, meta.flatten(q0), m, reorth=reorth)


def sharpness(result: LanczosResult) -> torch.Tensor:
    """lambda_max(H) — the stability-limiting curvature
    (alpha < 2 / sharpness)."""
    return result.eigenvalues[-1]
