"""Mamba (S6) selective state-space block — the port of
``repro/models/mamba.py``.

The recurrence h_t = a_t * h_{t-1} + b_t runs as the reference's chunked
scan: inside a chunk, the log-depth odd/even doubling scan that
``jax.lax.associative_scan`` performs (the same combines in the same
order), chunks chained in sequence through the boundary state.  Decode
keeps O(1) state per sequence: the conv history in the parameter dtype and
h in float32.

Dtypes follow the reference's promotion: the projections run in the
parameter dtype; ``dt_in @ dt_proj`` plus the float32 ``dt_bias`` is
float32 before the softplus; the scan, the C read-out and the gate are
float32, cast back to the activation dtype before ``out_proj``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init

__all__ = ["MambaParams", "init_mamba_params", "mamba_forward",
           "init_mamba_cache", "mamba_decode"]


class MambaParams(nn.Module):
    """in_proj (d, 2di); conv_w (conv, di); conv_b (di,); x_proj (di,
    rank + 2N); dt_proj (rank, di); dt_bias (di,) float32; a_log (di, N)
    float32; d (di,) float32; out_proj (di, d)."""

    def __init__(self, a_log, conv_b, conv_w, d, dt_bias, dt_proj, in_proj,
                 out_proj, x_proj):
        super().__init__()
        self.a_log = nn.Parameter(a_log)
        self.conv_b = nn.Parameter(conv_b)
        self.conv_w = nn.Parameter(conv_w)
        self.d = nn.Parameter(d)
        self.dt_bias = nn.Parameter(dt_bias)
        self.dt_proj = nn.Parameter(dt_proj)
        self.in_proj = nn.Parameter(in_proj)
        self.out_proj = nn.Parameter(out_proj)
        self.x_proj = nn.Parameter(x_proj)


def init_mamba_params(gen: torch.Generator, d_model: int, *,
                      expand: int = 2, state: int = 16, conv: int = 4,
                      dtype=torch.float32) -> MambaParams:
    """The reference's distributions (not its draws); ``a_log``, ``d`` and
    ``dt_bias`` in float32 whatever ``dtype`` is."""
    di = expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))
    dev, f32 = gen.device, torch.float32
    in_proj = dense_init(gen, d_model, 2 * di, dtype)
    conv_w = (torch.randn((conv, di), generator=gen, device=dev)
              / math.sqrt(conv)).to(dtype)
    x_proj = dense_init(gen, di, dt_rank + 2 * state, dtype)
    dt_proj = dense_init(gen, dt_rank, di, dtype)
    u = torch.rand((di,), generator=gen, device=dev)
    dt = torch.clamp(torch.exp(u * (math.log(0.1) - math.log(0.001))
                               + math.log(0.001)), min=1e-4)
    a = torch.arange(1, state + 1, dtype=f32, device=dev)[None].repeat(di, 1)
    return MambaParams(
        a_log=torch.log(a),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        conv_w=conv_w,
        d=torch.ones((di,), dtype=f32, device=dev),
        dt_bias=torch.log(torch.expm1(dt)),
        dt_proj=dt_proj,
        in_proj=in_proj,
        out_proj=dense_init(gen, di, d_model, dtype),
        x_proj=x_proj)


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def _combine(x, y):
    """(a, b) of an earlier span x, then a later span y."""
    ax, bx = x
    ay, by = y
    return ax * ay, ay * bx + by


def _interleave(even, odd):
    """Along axis 1: even[0], odd[0], even[1], odd[1], ..."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a, b):
    """Inclusive scan of ``_combine`` over axis 1: the recursion of
    ``jax.lax.associative_scan`` (combine adjacent pairs, scan the pairs,
    fill in the even positions)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _ssm_scan_chunked(a, b, h0, chunk: int):
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, S, di, N); h0:
    (B, di, N).  Returns (hs (B, S, di, N), h_last)."""
    S = a.shape[1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"scan chunk {chunk}")
    hs, h = torch.empty_like(b), h0
    for i in range(0, S, c):
        a_, b_ = a[:, i:i + c], b[:, i:i + c]
        # fold the carried state into the chunk's first step
        b_ = torch.cat([(b_[:, 0] + a_[:, 0] * h)[:, None], b_[:, 1:]], 1)
        _, hc = _associative_scan(a_, b_)
        hs[:, i:i + c] = hc
        h = hc[:, -1]
    return hs, h


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _dt(params: MambaParams, dt_in):
    return F.softplus(dt_in @ params.dt_proj + params.dt_bias).float()


def mamba_forward(params: MambaParams, x, *, expand: int = 2,
                  state: int = 16, conv: int = 4, scan_chunk: int = 64,
                  h0=None, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d) [, h_last (B, di, N)]."""
    B, S, d = x.shape
    di = expand * d
    dt_rank = params.dt_proj.shape[0]

    xin, z = torch.chunk(x @ params.in_proj, 2, dim=-1)     # (B, S, di)

    # causal depthwise conv1d, the taps summed in order as the reference
    xp = torch.cat([xin.new_zeros((B, conv - 1, di)), xin], dim=1)
    xc = xp[:, 0:S] * params.conv_w[0]
    for i in range(1, conv):
        xc = xc + xp[:, i:i + S] * params.conv_w[i]
    xc = F.silu(xc + params.conv_b)

    proj = xc @ params.x_proj                               # (B, S, r+2N)
    dt_in, bmat, cmat = torch.split(proj, [dt_rank, state, state], dim=-1)
    dt = _dt(params, dt_in)                                 # (B, S, di)
    a = -torch.exp(params.a_log)                            # (di, N)
    abar = torch.exp(dt[..., None] * a)                     # (B, S, di, N)
    bbar = (dt[..., None] * bmat[:, :, None, :].float()
            * xc[..., None].float())
    del proj, dt_in, dt

    if h0 is None:
        h0 = torch.zeros((B, di, state), dtype=torch.float32,
                         device=x.device)
    hs, h_last = _ssm_scan_chunked(abar, bbar, h0, scan_chunk)
    del abar, bbar

    y = torch.einsum("bsdn,bsn->bsd", hs, cmat.float())
    del hs
    y = y + params.d * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params.out_proj
    if return_state:
        return out, h_last
    return out


# ---------------------------------------------------------------------------
# decode: O(1) recurrent state
# ---------------------------------------------------------------------------

def init_mamba_cache(batch: int, d_model: int, *, expand: int = 2,
                     state: int = 16, conv: int = 4, dtype=torch.float32,
                     device=None):
    di = expand * d_model
    return {"conv": torch.zeros((batch, conv - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, di, state), dtype=torch.float32,
                             device=device)}


def mamba_decode(params: MambaParams, cache, x, *, expand: int = 2,
                 state: int = 16, conv: int = 4):
    """x: (B, 1, d) -> (out (B, 1, d), new cache).  The cache passed in is
    read, not written: the new {"conv", "h"} are fresh tensors."""
    dt_rank = params.dt_proj.shape[0]

    xin, z = torch.chunk(x @ params.in_proj, 2, dim=-1)     # (B, 1, di)
    hist = torch.cat([cache["conv"], xin.to(cache["conv"].dtype)], dim=1)
    xc = torch.einsum("bcd,cd->bd", hist, params.conv_w)[:, None]
    xc = F.silu(xc + params.conv_b)

    proj = xc @ params.x_proj
    dt_in, bmat, cmat = torch.split(proj, [dt_rank, state, state], dim=-1)
    dt = _dt(params, dt_in)
    a = -torch.exp(params.a_log)
    abar = torch.exp(dt[:, 0, :, None] * a)                 # (B, di, N)
    bbar = (dt[:, 0, :, None] * bmat[:, 0, None, :].float()
            * xc[:, 0, :, None].float())
    h = abar * cache["h"] + bbar
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].float())
    y = y + params.d * xc[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = (y @ params.out_proj)[:, None]
    return out, {"conv": hist[:, 1:], "h": h}
