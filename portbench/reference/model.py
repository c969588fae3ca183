"""Plain float32 forward of a decoder-only model of the transformer family,
written from the published descriptions, over the weight tree of
``weights.make_tree``.

- The residual stream: x = embed[tokens] * sqrt(d); each layer
  x += mixer(rms(x)); x += mlp(rms(x)); logits = rms(x) @ lm_head.
  RMSNorm carries the gain (1 + scale) on a zero-initialised scale.
- Attention: grouped-query, causal (and windowed when the configuration
  has a window), softmax over q.k / sqrt(hd); RoPE rotates the two halves
  of the head dim (not interleaved lanes) when the configuration uses it.
- SwiGLU: (silu(x W1) * (x W3)) W2.
- Mixture of experts (Jamba, arXiv:2403.19887): softmax router over all
  experts, the top-k gates renormalised to sum to one, every routed token
  computed by its experts (no capacity: nothing is dropped).
- Mamba (S6, Gu & Dao): in_proj to (x, z); a causal depthwise conv with
  bias and silu; x_proj to (dt_in, B, C); dt = softplus(dt_in dt_proj +
  dt_bias); h_t = exp(dt A) h_{t-1} + dt B x_t with A = -exp(a_log),
  computed one position after another; y = C h + D x, gated by silu(z),
  then out_proj.

Departures from Jamba's published model (arXiv:2403.19887 and its
released modelling code), which the port makes and this reference
follows, so that the two compute the same function:

- the embeddings are scaled by sqrt(d); Jamba's are not scaled;
- the top-k gates are renormalised to sum to one (Mixtral's rule);
  Jamba weights each chosen expert by its softmax probability over all
  experts, not renormalised;
- the mamba layers have no RMSNorm inside the block; Jamba's norm dt, B
  and C.

Every product goes through ``Ops.mm`` so that the lower-precision control
can round its operands (``Ops(fp8=True)``); by default it is a float32
product with TF32 off (``strict_fp32``).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_fp32(tf32: bool = False):
    """float32 products without TF32 (``tf32=True``: the TF32 control)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(x, dim: int = -1):
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


class Ops:
    def __init__(self, fp8: bool = False, margins=None):
        self.fp8 = fp8
        # a list: each MoE layer appends, per token, its router logit's
        # margin between the last expert chosen and the first left out
        self.margins = margins

    def w(self, t):
        """A weight (d_in, d_out) in float32 (per output column scales
        under fp8)."""
        t = t.to(F32)
        return fp8_round(t, dim=-2) if self.fp8 else t

    def mm(self, x, w):
        if self.fp8:
            x = fp8_round(x, dim=-1)
        return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + scale.to(F32))


def rope(x, pos, theta):
    """x: (B, S, H, hd); pos: (S,)."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=F32, device=x.device)
                      / hd)
    ang = pos.to(F32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(x, p, s, ops):
    B, S, _ = x.shape
    H, KV, hd = s["n_heads"], s["n_kv_heads"], s["head_dim"]
    q = ops.mm(x, ops.w(p["wq"])).view(B, S, H, hd)
    k = ops.mm(x, ops.w(p["wk"])).view(B, S, KV, hd)
    v = ops.mm(x, ops.w(p["wv"])).view(B, S, KV, hd)
    if s["rope"]:
        pos = torch.arange(S, device=x.device)
        q, k = rope(q, pos, s["rope_theta"]), rope(k, pos, s["rope_theta"])
    G = H // KV
    q = q.permute(0, 2, 1, 3)                                # B H S hd
    k = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    if ops.fp8:
        q, k = fp8_round(q), fp8_round(k)
    sc = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    i = torch.arange(S, device=x.device)
    live = i[:, None] >= i[None, :]
    if s["window"]:
        live &= i[:, None] - i[None, :] < s["window"]
    pr = torch.softmax(sc.masked_fill(~live, float("-inf")), -1)
    if ops.fp8:
        pr, v = fp8_round(pr), fp8_round(v, dim=-2)
    o = (pr @ v).permute(0, 2, 1, 3).reshape(B, S, H * hd)
    return ops.mm(o, ops.w(p["wo"]))


def swiglu(x, w1, w3, w2, ops):
    return ops.mm(F.silu(ops.mm(x, ops.w(w1))) * ops.mm(x, ops.w(w3)),
                  ops.w(w2))


def moe(x, p, s, ops):
    """Dropless top-k mixture; experts converted to float32 one at a
    time."""
    shp = x.shape
    xt = x.reshape(-1, shp[-1])
    logits = xt @ p["router"].to(F32)
    probs = torch.softmax(logits, -1)
    if ops.margins is not None:
        top = torch.topk(logits, s["top_k"] + 1, dim=-1).values
        ops.margins.append(top[:, -2] - top[:, -1])
    gates, ids = torch.topk(probs, s["top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(s["n_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = swiglu(xt[tok], p["w1"][e], p["w3"][e], p["w2"][e], ops)
        y.index_add_(0, tok, h * gates[tok, slot][:, None])
    return y.view(shp)


def mamba(x, p, s, ops):
    """One position after another (x: (B, S, d))."""
    B, S, d = x.shape
    N, r, cv = s["ssm_state"], s["dt_rank"], s["ssm_conv"]
    xz = ops.mm(x, ops.w(p["in_proj"]))
    xi, z = xz.chunk(2, -1)
    di = xi.shape[-1]
    w = p["conv_w"].to(F32)                                  # (cv, di)
    xp = torch.cat([xi.new_zeros(B, cv - 1, di), xi], 1)
    xc = sum(xp[:, j:j + S] * w[j] for j in range(cv)) + p["conv_b"].to(F32)
    xc = F.silu(xc)
    proj = ops.mm(xc, ops.w(p["x_proj"]))
    dt_in, bm, cm = proj.split([r, N, N], -1)
    dt = F.softplus(ops.mm(dt_in, ops.w(p["dt_proj"])) + p["dt_bias"])
    a = -torch.exp(p["a_log"].to(F32))                       # (di, N)
    h = x.new_zeros(B, di, N)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + dt[:, t, :, None] * bm[:, t, None, :] * xc[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    y = torch.stack(ys, 1) + p["d"].to(F32) * xc
    return ops.mm(y * F.silu(z), ops.w(p["out_proj"]))


def layer(x, lp, mixer: str, mlp: str, s, ops):
    h = rms_norm(x, lp["norm1"], s["norm_eps"])
    x = x + (attention(h, lp["mixer"], s, ops) if mixer == "attn"
             else mamba(h, lp["mixer"], s, ops))
    h = rms_norm(x, lp["norm2"], s["norm_eps"])
    if mlp == "moe":
        return x + moe(h, lp["mlp"], s, ops)
    f = lp["mlp"]
    return x + swiglu(h, f["w1"], f["w3"], f["w2"], ops)


def layer_params(tree, p: int, i: int) -> dict:
    """Layer i of period p: the stacked leaves' row p."""
    def pick(node):
        return {k: pick(v) if isinstance(v, dict) else v[p]
                for k, v in node.items()}
    return pick(tree["periods"][f"l{i}"])


def layers(s):
    """[(period, index, mixer, mlp)] in order."""
    P = s["n_layers"] // len(s["period"])
    return [(p, i, m, f) for p in range(P)
            for i, (m, f) in enumerate(s["period"])]


def embed(tree, s, tokens):
    return tree["embed"][tokens.long()].to(F32) * math.sqrt(s["d_model"])


def logits(tree, s, x, ops):
    h = rms_norm(x, tree["final_norm"], s["norm_eps"])
    head = tree["embed"].T if s["tie_embeddings"] else tree["lm_head"]
    return ops.mm(h, ops.w(head))[..., :s["vocab"]]


def forward(tree, s, tokens, ops=None, remat: bool = False):
    """tokens (B, S) -> logits (B, S, vocab) in float32.  ``remat``
    recomputes each layer in the backward (the same numbers, less
    memory)."""
    ops = ops or Ops()
    x = embed(tree, s, tokens)
    for p, i, mixer, mlp in layers(s):
        lp = layer_params(tree, p, i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, lp, mixer, mlp, s, ops,
                           use_reentrant=False)
        else:
            x = layer(x, lp, mixer, mlp, s, ops)
    return logits(tree, s, x, ops)


def loss(tree, s, batch, ops=None, remat: bool = True):
    """Mean token cross-entropy over the batch's labels (mask of ones)."""
    lg = forward(tree, s, batch["tokens"], ops, remat)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           batch["labels"].reshape(-1).long())
