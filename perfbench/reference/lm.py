"""The benchmark's plain reference: forward pass, loss and served logits of
the model families the configurations name, in float32 with TF32 off.

Layers: pre-norm blocks ``x + attn(norm(x))`` then ``x + ffn(norm(x))``
with RMS norms of gain ``1 + g``; rotary embeddings on the whole head
(half-split rotation); causal attention, with a one-sided window
``q - k < window`` on ``swa``/``hyb_swa`` layers, grouped-query heads; a
SiLU-gated MLP; the MoE block (softmax router, top-k, optional
renormalisation, a fixed capacity per expert filled in (token, choice)
order with the rest dropped, shared experts always on, the load-balance
term ``n_experts * sum(mean prob * top-1 share)``); the hybrid block
(attention and a Mamba-2 SSD layer on the same normed input, each
output RMS-normed, averaged); the SSD layer (input projection, causal
depthwise convolution, ``S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t``,
``y_t = C_t S_t + D x_t``, gated RMS norm, output projection), computed
exactly in blocks of ``SSD_BLOCK`` tokens with the state carried between
them.

``prec`` chooses the matrix products' operands: ``"float32"`` (the
reference), ``"bfloat16"``, or ``"float8"`` (each operand rounded to
e4m3 with a per-tensor scale, accumulated in f32: the control).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .params import layer

__all__ = ["highest_precision", "hidden", "loss", "logits_at", "mm",
           "SUPPORTED"]

ATTN_BLOCK = 512
SSD_BLOCK = 512
LOSS_BLOCK = 1024
_F8_MAX = 448.0

#: the model keys this reference implements, with the values it accepts
SUPPORTED = {"causal": (True,), "qkv_bias": (False,), "attn_cap": (None,),
             "final_cap": (None,), "post_norm": (False,),
             "embed_scale": (False,), "norm": ("rms",), "act": ("silu",),
             "gated_mlp": (True,), "rotary_pct": (1.0,), "use_rope": (True,),
             "dense_residual": (False,), "frontend": ("tokens",)}


def _check(m: dict) -> None:
    for key, ok in SUPPORTED.items():
        if m[key] not in ok:
            raise NotImplementedError(f"reference: {key}={m[key]!r}")


@contextlib.contextmanager
def highest_precision():
    """Float32 products in float32: TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(t, prec: str):
    """``t`` rounded to ``prec``; the gradient passes the rounding as it
    is (straight through), as a low-precision step's does."""
    if prec == "float32" or t.numel() == 0:
        return t
    if prec == "bfloat16":
        r = t.detach().to(torch.bfloat16).float()
    elif prec == "float8":
        scale = t.detach().abs().amax().clamp(min=1e-30) / _F8_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        raise ValueError(f"unknown precision {prec!r}")
    return t + (r - t.detach())


def mm(a, b, prec: str):
    """``a @ b`` with both operands rounded to ``prec``, summed in f32."""
    return _round(a, prec) @ _round(b, prec)


def rms(x, g, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + g)


def _rope(x, theta: float):
    """x (B, L, H, D), positions 0..L-1."""
    L, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _proj(x, w, prec):
    """x (B, L, M) by w (M, H, D) -> (B, L, H, D)."""
    M, H, D = w.shape
    return mm(x, w.reshape(M, H * D), prec).reshape(*x.shape[:2], H, D)


def attention(p, x, m: dict, window, prec: str):
    B, L, _ = x.shape
    H, K, D = m["n_heads"], m["n_kv"], m["head_dim"]
    q = _rope(_proj(x, p["wq"], prec), m["rope_theta"])
    k = _rope(_proj(x, p["wk"], prec), m["rope_theta"])
    v = _proj(x, p["wv"], prec)
    g = H // K
    outs = []
    for s in range(0, L, ATTN_BLOCK):
        e = min(L, s + ATTN_BLOCK)
        lo = 0 if window is None else max(0, s - window + 1)
        qb = q[:, s:e].reshape(B, e - s, K, g, D)
        sc = torch.einsum("bqkgd,blkd->bkgql", qb, k[:, lo:e]) / math.sqrt(D)
        qp = torch.arange(s, e, device=x.device)[:, None]
        kp = torch.arange(lo, e, device=x.device)[None, :]
        keep = qp >= kp
        if window is not None:
            keep = keep & (qp - kp < window)
        pr = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
        o = torch.einsum("bkgql,blkd->bqkgd", pr, v[:, lo:e])
        outs.append(o.reshape(B, e - s, H * D))
    o = torch.cat(outs, dim=1)
    return mm(o, p["wo"].reshape(H * D, -1), prec)


def mlp(p, x, prec: str):
    return mm(F.silu(mm(x, p["w_gate"], prec)) * mm(x, p["w_up"], prec),
              p["w_down"], prec)


def capacity(tokens: int, e: dict) -> int:
    c = int(tokens * e["top_k"] / e["n_experts"] * e["capacity_factor"])
    return max(8, (c + 7) // 8 * 8)


def moe(p, x, e: dict, prec: str):
    """x (B, L, M) -> (y, load-balance term)."""
    B, L, M = x.shape
    xf = x.reshape(B * L, M)
    T, k, n = B * L, e["top_k"], e["n_experts"]
    probs = torch.softmax(mm(xf, p["router"], prec), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if e["renorm_topk"]:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    share = torch.bincount(top_e[:, 0], minlength=n).float() / T
    aux = n * torch.sum(probs.mean(0) * share)
    flat_e, flat_w = top_e.reshape(-1), top_w.reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    C = capacity(T, e)
    y = torch.zeros_like(xf)
    for i in range(n):
        pick = torch.nonzero(flat_e == i)[:C, 0]   # (token, choice) order
        rows = tok[pick]
        h = xf[rows]
        out = mm(F.silu(mm(h, p["w_gate"][i], prec)) * mm(h, p["w_up"][i],
                                                          prec),
                 p["w_down"][i], prec)
        y = y.index_add(0, rows, out * flat_w[pick, None])
    if e["n_shared"]:
        y = y + mlp(p["shared"], xf, prec)
    return y.reshape(B, L, M), aux


def ssd(p, x, s: dict, prec: str):
    """The Mamba-2 SSD layer on x (B, L, M)."""
    B, L, _ = x.shape
    di, N, G, W = s["d_inner"], s["d_state"], s["n_groups"], s["conv_width"]
    H, P = di // s["headdim"], s["headdim"]
    zxbcdt = mm(x, p["in_proj"], prec)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[:, i:i + L] * p["conv_w"][i] for i in range(W))
    xbc = F.silu(conv + p["conv_b"])
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, L, H, P)
    Bm = Bm.reshape(B, L, G, N).repeat_interleave(H // G, dim=2)
    Cm = Cm.reshape(B, L, G, N).repeat_interleave(H // G, dim=2)
    dt = F.softplus(dt + p["dt_bias"])                        # (B, L, H)
    A = -torch.exp(p["A_log"])                                 # (H,)
    S = x.new_zeros(B, H, N, P)
    ys = []
    for a0 in range(0, L, SSD_BLOCK):
        a1 = min(L, a0 + SSD_BLOCK)
        xb, Bb, Cb, db = xs[:, a0:a1], Bm[:, a0:a1], Cm[:, a0:a1], \
            dt[:, a0:a1]
        cum = torch.cumsum(db * A, dim=1)                      # (B, q, H)
        n = a1 - a0
        tri = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                    device=x.device))
        seg = (cum[:, :, None] - cum[:, None]).masked_fill(
            ~tri[None, :, :, None], float("-inf"))             # (B, i, j, H)
        G_ = torch.einsum("bihn,bjhn->bijh", Cb, Bb) * seg.exp() \
            * db[:, None]
        y = torch.einsum("bijh,bjhp->bihp", G_, xb)
        y = y + torch.einsum("bihn,bhnp->bihp", Cb, S) * cum.exp()[..., None]
        w = torch.exp(cum[:, -1:] - cum) * db                   # (B, q, H)
        S = torch.exp(cum[:, -1])[..., None, None] * S + torch.einsum(
            "bjhn,bjhp->bhnp", Bb * w[..., None], xb)
        ys.append(y)
    y = torch.cat(ys, dim=1) + xs * p["D"][:, None]
    y = rms(y.reshape(B, L, di) * F.silu(z), p["norm"])
    return mm(y, p["out_proj"], prec)


def block(kind: str, p, x, m: dict, prec: str):
    """One layer: (x, load-balance term)."""
    zero = x.new_zeros(())
    if kind == "ssd":
        return x + ssd(p["ssm"], rms(x, p["norm"]), m["ssm"], prec), zero
    window = m["window"] if kind in ("swa", "hyb_swa") else None
    h = rms(x, p["ln1"])
    y = attention(p["attn"], h, m, window, prec)
    if kind in ("hyb_full", "hyb_swa"):
        ys = ssd(p["ssm"], h, m["ssm"], prec)
        y = 0.5 * (rms(y, p["mix_na"]) + rms(ys, p["mix_ns"]))
    x = x + y
    h = rms(x, p["ln2"])
    if kind == "moe":
        y, aux = moe(p["moe"], h, m["moe"], prec)
        return x + y, aux
    return x + mlp(p["mlp"], h, prec), zero


def hidden(params, m: dict, tokens, prec: str = "float32",
           remat: bool = False):
    """The final-normed hidden states (B, L, M) of ``tokens`` and the sum
    of the layers' load-balance terms.  ``remat`` recomputes each layer
    in the backward pass (memory for a training step at full size)."""
    _check(m)
    x = params["embed"][tokens].float()
    aux = x.new_zeros(())
    for (kind, n), seg in zip(m["program"], params["segments"]):
        for i in range(n):
            p = layer(seg, i) if n > 1 else seg

            def run(xx, pp, _kind=kind):
                return block(_kind, pp, xx, m, prec)
            x, a = checkpoint(run, x, p, use_reentrant=False) if remat \
                else run(x, p)
            aux = aux + a
    return rms(x, params["final_norm"]), aux


def _head(params):
    return params["lm_head"] if "lm_head" in params else params["embed"]


def loss(params, m: dict, tokens, labels, prec: str = "float32",
         remat: bool = False):
    """Mean next-token cross-entropy plus ``aux_weight`` times the summed
    load-balance terms: (loss, cross-entropy)."""
    h, aux = hidden(params, m, tokens, prec, remat)
    B, L, _ = h.shape
    head = _head(params)

    def chunk(hh, lab):
        z = mm(hh, head.T, prec)
        return torch.sum(torch.logsumexp(z, -1)
                         - z.gather(-1, lab[..., None])[..., 0])
    total = h.new_zeros(())
    for s in range(0, L, LOSS_BLOCK):
        args = (h[:, s:s + LOSS_BLOCK], labels[:, s:s + LOSS_BLOCK].long())
        total = total + (checkpoint(chunk, *args, use_reentrant=False)
                         if remat else chunk(*args))
    ce = total / (B * L)
    return ce + m["aux_weight"] * aux, ce


@torch.no_grad()
def logits_at(params, m: dict, tokens, positions, prec: str = "float32"):
    """Logits (B, len(positions), vocab) of ``tokens`` (B, L) at
    ``positions``."""
    h, _ = hidden(params, m, tokens, prec)
    return mm(h[:, positions], _head(params).T, prec)
