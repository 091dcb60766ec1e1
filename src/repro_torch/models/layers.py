"""Shared layer primitives: norms, rotary embeddings, MLPs, embeddings,
and the training loss (chunked cross-entropy).

Compute is bf16 from the embedding on (``_COMPUTE``), with norms, softmax
and the loss's logits in f32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import ParamDef

__all__ = ["rms_norm", "rms_norm_def", "layer_norm", "layer_norm_defs",
           "rope", "softcap", "mlp_defs", "mlp_forward", "embed_def",
           "embed_lookup", "unembed_chunked", "cross_entropy_chunked"]

_COMPUTE = torch.bfloat16


def rms_norm_def(dim: int) -> ParamDef:
    return ParamDef((dim,), ("embed",), init="zeros")   # gemma-style (1+g)


def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def layer_norm_defs(dim: int) -> dict:
    return {"g": ParamDef((dim,), ("embed",), init="ones"),
            "b": ParamDef((dim,), ("embed",), init="zeros")}


def layer_norm(x, p, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b"].float()).to(dt)


def rope(x, positions, theta: float = 10000.0, rotary_dim: int | None = None):
    """Rotary embedding over the trailing head_dim.  ``x``: (..., seq, D)
    with ``positions`` broadcastable to (..., seq).  ``rotary_dim`` rotates
    only the leading slice (stablelm rotary_pct)."""
    D = x.shape[-1]
    rd = rotary_dim or D
    half = rd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs   # (..., seq, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# -- MLPs ---------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, gated: bool = True) -> dict:
    d = {"w_up": ParamDef((d_model, d_ff), ("embed", "mlp"), init="fan_in"),
         "w_down": ParamDef((d_ff, d_model), ("mlp", "embed"), init="fan_in")}
    if gated:
        d["w_gate"] = ParamDef((d_model, d_ff), ("embed", "mlp"),
                               init="fan_in")
    return d


def _act(x, act: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if act == "gelu" else F.silu(x)


def mlp_forward(p, x, act: str = "silu"):
    h = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        h = _act(x @ p["w_gate"].to(x.dtype), act) * h
    else:
        h = _act(h, act)
    return h @ p["w_down"].to(x.dtype)


# -- embeddings / unembedding -------------------------------------------------

def embed_def(vocab: int, d_model: int) -> ParamDef:
    return ParamDef((vocab, d_model), ("vocab", "embed"), init="normal",
                    scale=1.0)


def embed_lookup(table, tokens, scale: bool = False):
    x = table[tokens].to(_COMPUTE)
    if scale:
        d = torch.tensor(float(table.shape[-1]), dtype=torch.float32,
                         device=x.device)
        x = x * torch.sqrt(d).to(x.dtype)
    return x


def unembed_chunked(x, table, final_cap: float | None = None):
    """Logits = x @ table.T, in f32 after the product.  Used only on small
    outputs (decode / last position)."""
    logits = x @ table.to(x.dtype).T
    return softcap(logits.float(), final_cap)


def cross_entropy_chunked(x, table, labels, chunk: int = 512,
                          final_cap: float | None = None):
    """Mean next-token cross-entropy without materializing the (B, L, V)
    logits: a loop over ``max(1, L // chunk)`` sequence chunks (the
    reference scans them), each chunk's logits in f32 after the product,
    ``final_cap`` applied, logsumexp minus the gold logit."""
    B, L, M = x.shape
    n_chunks = max(1, L // chunk)
    if L % n_chunks:
        raise ValueError(f"sequence length {L} is not {n_chunks} chunks")
    c = L // n_chunks
    w = table.to(x.dtype)                 # cast once, shared by the chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        logits = softcap((x[:, i * c:(i + 1) * c] @ w.T).float(), final_cap)
        gold = torch.gather(logits, -1, labels[:, i * c:(i + 1) * c, None]
                            .long())[..., 0]
        total = total + torch.sum(torch.logsumexp(logits, dim=-1) - gold)
    return total / (B * L)