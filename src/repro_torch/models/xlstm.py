"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM and sLSTM — the
port of ``repro/models/xlstm.py``.

* mLSTM: the matrix memory C_t = f_t C_{t-1} + i_t v_t k_t^T in the
  reference's stabilised chunkwise-parallel form: inside a chunk a
  quadratic attention with a log-space decay matrix, the chunks chained
  in sequence through the state (C, n, m).
* sLSTM: its recurrent weights R act on h_{t-1}, so the scan is
  sequential over time, one host-loop iteration a position (the
  reference's ``lax.scan``; its remat per chunk is left to autograd).

Both gate exponentially with the paper's m stabiliser.  Decode keeps
O(1) state per sequence: mLSTM (C, n, m) in float32 and the conv history
in the parameter dtype, sLSTM (h, c, n, m) in float32.  A decode step
reads the cache it is given and returns fresh state tensors.

Dtypes follow the reference's promotion: projections run in the
parameter dtype; the gates (float32 weights), the recurrences and the
sLSTM pre-activations (a float32 bias) are float32; the mixer's output is
cast back to the activation dtype before its norm.  A Python-float scale
takes the array's dtype first (``weak_scalar``), as JAX's weak typing
does.
"""
# lint: hot-path
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init, rms_norm, weak_scalar

__all__ = ["MLSTMParams", "SLSTMParams", "init_mlstm_params",
           "mlstm_chunkwise", "mlstm_block_forward", "init_mlstm_cache",
           "mlstm_block_decode", "init_slstm_params", "slstm_scan",
           "slstm_block_forward", "init_slstm_cache", "slstm_block_decode"]

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMParams(nn.Module):
    """norm (d,) float32; up (d, 2di); conv_w (4, di); conv_b (di,); wq, wk,
    wv (di, di); w_igate, w_fgate (di, H) float32; fgate_b (H,) float32;
    head_norm (di,) float32; down (di, d)."""

    def __init__(self, conv_b, conv_w, down, fgate_b, head_norm, norm, up,
                 w_fgate, w_igate, wk, wq, wv):
        super().__init__()
        self.conv_b = nn.Parameter(conv_b)
        self.conv_w = nn.Parameter(conv_w)
        self.down = nn.Parameter(down)
        self.fgate_b = nn.Parameter(fgate_b)
        self.head_norm = nn.Parameter(head_norm)
        self.norm = nn.Parameter(norm)
        self.up = nn.Parameter(up)
        self.w_fgate = nn.Parameter(w_fgate)
        self.w_igate = nn.Parameter(w_igate)
        self.wk = nn.Parameter(wk)
        self.wq = nn.Parameter(wq)
        self.wv = nn.Parameter(wv)


def init_mlstm_params(gen: torch.Generator, d_model: int, n_heads: int,
                      dtype, expand: int = 2) -> MLSTMParams:
    """The reference's distributions (not its draws); the gates, their
    bias (3.0: open forget gates) and the norms in float32."""
    di = expand * d_model
    dev, f32 = gen.device, torch.float32
    return MLSTMParams(
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        conv_w=(torch.randn((4, di), generator=gen, device=dev)
                / 2.0).to(dtype),
        down=dense_init(gen, di, d_model, dtype),
        fgate_b=torch.full((n_heads,), 3.0, dtype=f32, device=dev),
        head_norm=torch.zeros((di,), dtype=f32, device=dev),
        norm=torch.zeros((d_model,), dtype=f32, device=dev),
        up=dense_init(gen, d_model, 2 * di, dtype),
        w_fgate=dense_init(gen, di, n_heads, f32, scale=0.01),
        w_igate=dense_init(gen, di, n_heads, f32, scale=0.01),
        wk=dense_init(gen, di, di, dtype),
        wq=dense_init(gen, di, di, dtype),
        wv=dense_init(gen, di, di, dtype))


def _causal_conv(x, w, b):
    """Depthwise causal conv of kernel size ``w.shape[0]``, then SiLU;
    x: (B, S, d).  The taps are summed in order, as the reference's."""
    K = w.shape[0]
    B, S, d = x.shape
    xp = torch.cat([x.new_zeros((B, K - 1, d)), x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out + b)


def mlstm_chunkwise(q, k, v, igate, fgate, chunk: int, state=None,
                    return_state: bool = False):
    """q, k, v: (B, S, H, dh); igate, fgate: (B, S, H) raw logits.  The
    stabilised chunkwise-parallel mLSTM; q is scaled by dh^-1/2 here.
    ``state``: {"C" (B, H, dh, dh), "n" (B, H, dh), "m" (B, H)} to start
    from (zeros by default).  Returns h (B, S, H, dh) in q's dtype [, the
    final state]."""
    B, S, H, dh = q.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"mLSTM chunk {chunk}")
    qs = q * weak_scalar(dh ** -0.5, q.dtype)
    f32, dev = torch.float32, q.device
    if state is None:
        C = torch.zeros((B, H, dh, dh), dtype=f32, device=dev)
        n = torch.zeros((B, H, dh), dtype=f32, device=dev)
        m = torch.zeros((B, H), dtype=f32, device=dev)
    else:
        C, n, m = state["C"], state["n"], state["m"]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    hs = []
    for i in range(0, S, c):
        qf, kf, vf = (t[:, i:i + c].float() for t in (qs, k, v))
        ib = igate[:, i:i + c].float()
        logf = F.logsigmoid(fgate[:, i:i + c].float())       # (B, c, H)
        cum = torch.cumsum(logf, dim=1)                       # inclusive
        # dlog[t, s] = cum_t - cum_s + i_s, valid for s <= t
        dlog = cum[:, :, None] - cum[:, None, :] + ib[:, None, :]
        dlog = torch.where(tri[None, :, :, None], dlog, NEG)  # (B, c, c, H)
        m_inter = m[:, None] + cum                            # (B, c, H)
        m_t = torch.maximum(torch.amax(dlog, dim=2), m_inter)
        d_mat = torch.exp(dlog - m_t[:, :, None])
        inter_scale = torch.exp(m_inter - m_t)
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * d_mat
        num = (torch.einsum("btsh,bshd->bthd", scores, vf)
               + inter_scale[..., None]
               * torch.einsum("bthd,bhde->bthe", qf, C))
        # n_t = inter_scale n_prev + sum_s D_ts k_s; denom = |q . n_t|
        n_t = (torch.einsum("btsh,bshd->bthd", d_mat, kf)
               + inter_scale[..., None] * n[:, None])
        denom = torch.abs(torch.einsum("bthd,bthd->bth", qf, n_t))
        hs.append(num / torch.maximum(denom, torch.exp(-m_t))[..., None])

        # the chunk-end state
        last_cum = cum[:, -1]                                 # (B, H)
        u = last_cum[:, None] - cum + ib                      # (B, c, H)
        m_new = torch.maximum(m + last_cum, torch.amax(u, dim=1))
        sc_old = torch.exp(m + last_cum - m_new)
        sc_in = torch.exp(u - m_new[:, None])
        C = (sc_old[..., None, None] * C
             + torch.einsum("bsh,bshd,bshe->bhde", sc_in, kf, vf))
        n = sc_old[..., None] * n + torch.einsum("bsh,bshd->bhd", sc_in, kf)
        m = m_new
    h = torch.cat(hs, dim=1).to(q.dtype)
    if return_state:
        return h, {"C": C, "n": n, "m": m}
    return h


def mlstm_block_forward(params: MLSTMParams, x, *, n_heads: int,
                        expand: int = 2, chunk: int = 64,
                        norm_eps: float = 1e-6):
    """The mLSTM residual block.  x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    di = expand * d
    dh = di // n_heads
    h = rms_norm(x, params.norm, norm_eps)
    xi, z = torch.chunk(h @ params.up, 2, dim=-1)
    xc = _causal_conv(xi, params.conv_w, params.conv_b)
    q = (xc @ params.wq).reshape(B, S, n_heads, dh)
    k = (xc @ params.wk).reshape(B, S, n_heads, dh)
    v = (xi @ params.wv).reshape(B, S, n_heads, dh)
    ig = xc.float() @ params.w_igate
    fg = xc.float() @ params.w_fgate + params.fgate_b
    o = mlstm_chunkwise(q, k, v, ig, fg, chunk).reshape(B, S, di)
    o = rms_norm(o, params.head_norm, norm_eps) * F.silu(z)
    return x + o @ params.down


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMParams(nn.Module):
    """norm (d,) float32; w (d, 4d) (z, i, f, o); r (H, dh, 4dh); b (4d,)
    float32; head_norm (d,) float32; up (d, 2 dff); down (dff, d)."""

    def __init__(self, b, down, head_norm, norm, r, up, w):
        super().__init__()
        self.b = nn.Parameter(b)
        self.down = nn.Parameter(down)
        self.head_norm = nn.Parameter(head_norm)
        self.norm = nn.Parameter(norm)
        self.r = nn.Parameter(r)
        self.up = nn.Parameter(up)
        self.w = nn.Parameter(w)


def init_slstm_params(gen: torch.Generator, d_model: int, n_heads: int,
                      dtype, ff_factor: float = 4.0 / 3.0) -> SLSTMParams:
    dh = d_model // n_heads
    dff = int(2 * ff_factor * d_model)
    dev, f32 = gen.device, torch.float32
    b = torch.cat([torch.zeros((2 * d_model,), device=dev),
                   torch.full((d_model,), 3.0, device=dev),
                   torch.zeros((d_model,), device=dev)])
    return SLSTMParams(
        b=b,
        down=dense_init(gen, dff, d_model, dtype),
        head_norm=torch.zeros((d_model,), dtype=f32, device=dev),
        norm=torch.zeros((d_model,), dtype=f32, device=dev),
        r=(torch.randn((n_heads, dh, 4 * dh), generator=gen, device=dev)
           / math.sqrt(dh)).to(dtype),
        up=dense_init(gen, d_model, 2 * dff, dtype),
        w=dense_init(gen, d_model, 4 * d_model, dtype))


def _slstm_cell(pre, c, n, m):
    """One sLSTM step from its float32 pre-activations (B, H, 4dh) and the
    state (c, n, m) -> (h, c, n, m)."""
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    m_new = torch.maximum(f + m, i)
    fp = torch.exp(f + m - m_new)
    ip = torch.exp(i - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    return o * c_new / torch.clamp(n_new, min=1e-6), c_new, n_new, m_new


def slstm_scan(wx, r, h0, c0, n0, m0, n_heads: int, chunk: int = 64):
    """wx: (B, S, 4d) input contributions, per head (z|i|f|o).  The
    sequential scan over time from (h0, c0, n0, m0), each (B, H, dh).
    Returns (hs (B, S, d) float32, (h, c, n, m)).  ``chunk`` is the
    reference's remat chunk: S must be a multiple of min(chunk, S)."""
    B, S, d4 = wx.shape
    d = d4 // 4
    dh = d // n_heads
    if S % min(chunk, S):
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"sLSTM chunk {chunk}")
    rf = r.float()
    pre_in = wx.reshape(B, S, n_heads, 4 * dh).float()
    h, c, n, m = h0, c0, n0, m0
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h, rf)
        h, c, n, m = _slstm_cell(pre_in[:, t] + rec, c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(B, S, d), (h, c, n, m)


def _slstm_input(params: SLSTMParams, h, n_heads: int):
    """rms-normed input (B, S, d) -> the per-head (z|i|f|o) regrouping of
    h @ w + b, (B, S, 4d) float32 (the float32 bias promotes)."""
    B, S, d = h.shape
    wx = h @ params.w + params.b
    return wx.reshape(B, S, 4, n_heads, d // n_heads).transpose(2, 3) \
        .reshape(B, S, 4 * d)


def _slstm_out(params: SLSTMParams, x, hs, norm_eps: float):
    """x + head-normed hs, then the block's gated FF (factor 4/3 GLU) with
    the reference's norm of scale ``norm * 0``."""
    out = x + rms_norm(hs.to(x.dtype), params.head_norm, norm_eps)
    a, b = torch.chunk(rms_norm(out, params.norm * 0, norm_eps)
                       @ params.up, 2, dim=-1)
    return out + (F.silu(a) * b) @ params.down


def slstm_block_forward(params: SLSTMParams, x, *, n_heads: int,
                        chunk: int = 64, norm_eps: float = 1e-6):
    """The sLSTM residual block.  x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    wx = _slstm_input(params, rms_norm(x, params.norm, norm_eps), n_heads)
    z0 = torch.zeros((B, n_heads, d // n_heads), dtype=torch.float32,
                     device=x.device)
    hs, _ = slstm_scan(wx, params.r, z0, z0, z0, z0, n_heads, chunk)
    return _slstm_out(params, x, hs, norm_eps)


# ---------------------------------------------------------------------------
# decode (one step)
# ---------------------------------------------------------------------------

def init_mlstm_cache(batch: int, d_model: int, n_heads: int,
                     expand: int = 2, dtype=torch.float32, device=None):
    di = expand * d_model
    dh = di // n_heads
    f32 = torch.float32
    return {"C": torch.zeros((batch, n_heads, dh, dh), dtype=f32,
                             device=device),
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
            "m": torch.zeros((batch, n_heads), dtype=f32, device=device),
            "n": torch.zeros((batch, n_heads, dh), dtype=f32,
                             device=device)}


def mlstm_block_decode(params: MLSTMParams, cache, x, *, n_heads: int,
                       expand: int = 2, norm_eps: float = 1e-6):
    """x: (B, 1, d) -> (out (B, 1, d), new {"C", "conv", "m", "n"})."""
    B, _, d = x.shape
    di = expand * d
    dh = di // n_heads
    h = rms_norm(x, params.norm, norm_eps)
    xi, z = torch.chunk(h @ params.up, 2, dim=-1)            # (B, 1, di)
    hist = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)], dim=1)
    xc = torch.einsum("bcd,cd->bd", hist, params.conv_w)[:, None]
    xc = F.silu(xc + params.conv_b)
    q = ((xc @ params.wq).reshape(B, n_heads, dh)
         * weak_scalar(dh ** -0.5, xc.dtype))
    k = (xc @ params.wk).reshape(B, n_heads, dh)
    v = (xi @ params.wv).reshape(B, n_heads, dh)
    ig = (xc.float() @ params.w_igate)[:, 0]
    fg = (xc.float() @ params.w_fgate)[:, 0] + params.fgate_b
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + cache["m"], ig)
    fp = torch.exp(logf + cache["m"] - m_new)
    ip = torch.exp(ig - m_new)
    kf = k.float()
    C = (fp[..., None, None] * cache["C"] + ip[..., None, None]
         * torch.einsum("bhd,bhe->bhde", kf, v.float()))
    n = fp[..., None] * cache["n"] + ip[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
    hval = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    o = rms_norm(hval.reshape(B, 1, di).to(x.dtype), params.head_norm,
                 norm_eps) * F.silu(z)
    return x + o @ params.down, {"C": C, "conv": hist[:, 1:], "m": m_new,
                                 "n": n}


def init_slstm_cache(batch: int, d_model: int, n_heads: int, device=None):
    """{"c", "h", "m", "n"}: (batch, H, dh) float32 zeros, four tensors."""
    shape = (batch, n_heads, d_model // n_heads)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("c", "h", "m", "n")}


def slstm_block_decode(params: SLSTMParams, cache, x, *, n_heads: int,
                       norm_eps: float = 1e-6):
    """x: (B, 1, d) -> (out (B, 1, d), new {"c", "h", "m", "n"})."""
    B, _, d = x.shape
    wx = _slstm_input(params, rms_norm(x, params.norm, norm_eps), n_heads)
    rec = torch.einsum("bhd,hde->bhe", cache["h"], params.r.float())
    h, c, n, m = _slstm_cell(wx.reshape(B, n_heads, 4 * (d // n_heads))
                             .float() + rec, cache["c"], cache["n"],
                             cache["m"])
    out = _slstm_out(params, x, h.reshape(B, 1, d), norm_eps)
    return out, {"c": c, "h": h, "m": m, "n": n}
