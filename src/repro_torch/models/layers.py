"""Shared layer primitives: norms, rotary embeddings, MLPs, embeddings,
and the training loss (chunked cross-entropy).

Compute is bf16 from the embedding on (``_COMPUTE``), with norms, softmax
and the loss's logits in f32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import current_ctx, is_dtensor, shard
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
    h = shard(h, "batch", *([None] * (h.ndim - 2)), "act_mlp")
    return h @ p["w_down"].to(x.dtype)


# -- embeddings / unembedding -------------------------------------------------

def embed_def(vocab: int, d_model: int) -> ParamDef:
    return ParamDef((vocab, d_model), ("vocab", "embed"), init="normal",
                    scale=1.0)


def embed_lookup(table, tokens, scale: bool = False):
    x = (_embed_sharded(table, tokens) if is_dtensor(table)
         else table[tokens]).to(_COMPUTE)
    if scale:
        d = torch.tensor(float(table.shape[-1]), dtype=torch.float32,
                         device=x.device)
        x = x * torch.sqrt(d).to(x.dtype)
    return x


def _embed_sharded(table, tokens):
    """The lookup of a DTensor ``table`` split over the vocab (the
    reference's ``jnp.take`` on a vocab-sharded table): each rank looks up
    the tokens in its own rows (zeros for the others') and the result is a
    partial sum over the vocab's mesh dims, batch-split as ``tokens`` is.
    DTensor's own index rule (a masked partial sum) is not used: a gloo
    world on CUDA tensors crashed in it with torch 2.11."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    want = tuple(pl if pl.is_shard(0) else Replicate()
                 for pl in table.placements)
    if is_dtensor(tokens):
        batch = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                      for pl in tokens.placements)
        tok = tokens.redistribute(tokens.device_mesh, batch).to_local()
    else:
        batch, tok = (Replicate(),) * mesh.ndim, tokens
    # a rank looks up only its own rows of a batch split over a mesh dim:
    # the table's gradient there is a partial sum over that dim's ranks
    grad = tuple(Partial() if b.is_shard(0) and not w.is_shard(0) else w
                 for w, b in zip(want, batch))
    local = table.redistribute(mesh, want).to_local(grad_placements=grad)
    v0, nv = _shard_index(mesh, want, 0)
    V_loc = local.shape[0]
    rel = tok.long() - v0 * V_loc
    mine = (rel >= 0) & (rel < V_loc)
    x = local[rel.clamp(0, V_loc - 1)] * mine[..., None].to(local.dtype)
    return DTensor.from_local(x, mesh, tuple(
        Partial() if pl.is_shard(0) else b for pl, b in zip(want, batch)))


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
    ``final_cap`` applied, logsumexp minus the gold logit.  Under a mesh
    (DTensor operands) the logits stay vocab-sharded: see
    ``_cross_entropy_sharded``."""
    if is_dtensor(x) or is_dtensor(table):
        return _cross_entropy_sharded(x, table, labels, chunk, final_cap)
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

def _shard_index(mesh, placements, dim: int) -> tuple:
    """(this rank's index, the count) of its block of array dim ``dim``
    under ``placements``: the mesh dims that split it, major first."""
    idx, n = 0, 1
    for i, pl in enumerate(placements):
        if getattr(pl, "dim", None) == dim and pl.is_shard():
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    return idx, n


def _cross_entropy_sharded(x, table, labels, chunk, final_cap):
    """The chunked cross-entropy with each chunk's logits vocab-sharded
    over the mesh (the reference keeps them so): logsumexp and the gold
    logit have no DTensor sharding rule over a sharded vocab, so each rank
    reduces its own slice (a DTensor ``to_local``) and the partial results
    meet in explicit sums over the vocab's mesh dims — the global max (no
    gradient: the logsumexp does not depend on it), the sum of exponents
    and the gold logit — then one sum of the loss over the batch's mesh
    dims.  Those sums have an identity backward (every rank uses the
    summed value), so each rank's logits get the whole function's
    gradient of their slice."""
    from torch.distributed.tensor import DTensor, Replicate
    from ..distributed.collectives import all_reduce, psum_replicated
    ctx = current_ctx()
    mesh = (table if is_dtensor(table) else x).device_mesh
    B, L, M = x.shape
    n_chunks = max(1, L // chunk)
    if L % n_chunks:
        raise ValueError(f"sequence length {L} is not {n_chunks} chunks")
    c = L // n_chunks
    w = table.to(x.dtype)
    want = ctx.placements(("batch", None, "vocab"), (B, c, table.shape[0]),
                          mesh=mesh) if ctx is not None else tuple(
        Replicate() for _ in range(mesh.ndim))
    vocab_dims = [i for i, pl in enumerate(want) if pl.is_shard(2)]
    batch_dims = [i for i, pl in enumerate(want) if pl.is_shard(0)]
    b0, nb = _shard_index(mesh, want, 0)
    v0, nv = _shard_index(mesh, want, 2)
    if is_dtensor(labels):
        labels = labels.full_tensor()
    rows = labels[b0 * (B // nb):(b0 + 1) * (B // nb)].long()
    V_loc = table.shape[0] // nv
    total = torch.zeros((), dtype=torch.float32,
                        device=x.to_local().device if is_dtensor(x)
                        else x.device)
    for i in range(n_chunks):
        logits = softcap((x[:, i * c:(i + 1) * c] @ w.T).float(), final_cap)
        z = logits.redistribute(mesh, want).to_local()   # (b, c, V_loc)
        lab = rows[:, i * c:(i + 1) * c] - v0 * V_loc
        m = z.detach().amax(dim=-1)
        for d in vocab_dims:
            m = all_reduce(m, mesh.get_group(d), "max")
        se = torch.sum(torch.exp(z - m[..., None]), dim=-1)
        mine = (lab >= 0) & (lab < V_loc)
        gold = torch.where(mine, torch.gather(
            z, -1, lab.clamp(0, V_loc - 1)[..., None])[..., 0], 0.0)
        for d in vocab_dims:
            se = psum_replicated(se, mesh.get_group(d))
            gold = psum_replicated(gold, mesh.get_group(d))
        total = total + torch.sum(m + torch.log(se) - gold)
    for d in batch_dims:
        total = psum_replicated(total, mesh.get_group(d))
    return DTensor.from_local(total / (B * L), mesh,
                              (Replicate(),) * mesh.ndim)
