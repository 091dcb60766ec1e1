"""Attention: GQA/MHA/MQA, sliding windows, logit softcap, cross-attention.

Prefill takes one of two routes, as in the reference: the flash kernel
(``kernels/flash_attention.py``) when ``flash`` is set and the length is a
multiple of ``flash_block``, else query-chunked (blockwise-softmax)
attention that never materializes more than a (q_chunk, L) score tensor
per head.  Decode is a single-token step against a full KV cache or a
ring-buffered sliding-window cache.  Cross-attention to memory tokens
(the VLM's) is plain, unmasked attention, as in the reference.  Under a
mesh the flash kernel runs on each rank's shard of the batch and heads
(``_flash_sharded``).
"""

from __future__ import annotations

import math

import torch

from ..distributed.sharding import current_ctx, is_dtensor, shard
from ..kernels.flash_attention import flash_attention
from .layers import rope, softcap
from .params import ParamDef

__all__ = ["attn_defs", "attn_forward", "attn_decode", "init_kv_cache_defs",
           "cross_attn_forward", "cross_kv"]


def attn_defs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
              qkv_bias: bool = False, gated: bool = False) -> dict:
    d = {
        "wq": ParamDef((d_model, n_heads, head_dim),
                       ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": ParamDef((d_model, n_kv, head_dim),
                       ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamDef((d_model, n_kv, head_dim),
                       ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamDef((n_heads, head_dim, d_model),
                       ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if qkv_bias:
        d["bq"] = ParamDef((n_heads, head_dim), ("heads", "head_dim"),
                           init="zeros")
        d["bk"] = ParamDef((n_kv, head_dim), ("kv_heads", "head_dim"),
                           init="zeros")
        d["bv"] = ParamDef((n_kv, head_dim), ("kv_heads", "head_dim"),
                           init="zeros")
    if gated:   # cross-attn tanh gate (llama-3.2-vision)
        d["gate"] = ParamDef((), (), init="zeros")
    return d


def _proj(x, w):
    """``einsum("blm,mhd->blhd")``.  On DTensors as one matrix product
    over the (heads, head_dim) columns: torch 2.11's einsum lowering
    merges a sharded heads dim behind head_dim, which DTensor refuses.
    A weight split over the data axes (FSDP's ``embed``) is gathered over
    them first, as FSDP uses a layer's weights: the product then keeps
    the batch on the data axes and splits its columns on whole heads or
    not at all, and the (heads, head_dim) view takes it."""
    if not is_dtensor(w):
        return torch.einsum("blm,mhd->blhd", x, w)
    w = _gathered_over_data(w)
    M, H, D = w.shape
    return (x @ w.reshape(M, H * D)).reshape(*x.shape[:-1], H, D)


def _gathered_over_data(w):
    """A DTensor weight whole over the data axes ("pod", "data"): an FSDP
    split (``embed``) gathered, as FSDP uses a layer's weights."""
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in ("pod", "data") else pl
                 for i, pl in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def _project_q(p, x):
    q = _proj(x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return q


def _project_kv(p, x):
    k = _proj(x, p["wk"].to(x.dtype))
    v = _proj(x, p["wv"].to(x.dtype))
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return k, v


def _out(p, o, gated: bool = False):
    wo = p["wo"].to(o.dtype)
    if is_dtensor(wo):          # as ``_proj``: one product over (H, D)
        wo = _gathered_over_data(wo)
        H, D, M = wo.shape
        y = o.reshape(*o.shape[:-2], H * D) @ wo.reshape(H * D, M)
    else:
        y = torch.einsum("blhd,hdm->blm", o, wo)
    if gated and "gate" in p:
        y = torch.tanh(p["gate"].to(y.dtype)) * y
    return y


def _scores_mask(qpos, kpos, causal: bool, window: int | None):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def _rope_heads(x, positions, theta, rotary_dim):
    """RoPE on (B, L, H, D) activations, rotated as (B, H, L, D)."""
    return rope(x.transpose(1, 2), positions, theta,
                rotary_dim).transpose(1, 2)


def attn_forward(p, x, *, n_heads: int, n_kv: int, head_dim: int,
                 causal: bool = True, window: int | None = None,
                 positions=None, rope_theta: float = 10000.0,
                 rotary_dim: int | None = None, use_rope: bool = True,
                 attn_cap: float | None = None, q_chunk: int = 512,
                 flash: bool = False, flash_block: int = 256):
    """Self-attention over a full sequence (training / prefill)."""
    B, L, M = x.shape
    if positions is None:
        positions = torch.arange(L, device=x.device)
    q = _project_q(p, x)                     # (B, L, H, D)
    k, v = _project_kv(p, x)                 # (B, L, K, D)
    if use_rope:
        q = _rope_heads(q, positions, rope_theta, rotary_dim)
        k = _rope_heads(k, positions, rope_theta, rotary_dim)
    q = shard(q, "batch", None, "act_heads", None)
    k = shard(k, "batch", None, "act_heads", None)
    v = shard(v, "batch", None, "act_heads", None)
    scale = 1.0 / math.sqrt(head_dim)

    if flash and L % flash_block == 0:
        o = _flash_sharded(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), scale, causal, window,
                           attn_cap, flash_block)
        return _out(p, o.transpose(1, 2))

    def attend(a, b, c):
        return _attend_chunked(a, b, c, positions, scale, causal, window,
                               attn_cap, q_chunk)
    # on DTensors on each rank's rows and heads, as the flash kernel: the
    # product over (batch x heads x groups) has no DTensor sharding rule
    # that a fake trace can take
    return _out(p, _per_shard(q, k, v, attend, heads=2))


def _attend_chunked(q, k, v, positions, scale, causal, window, attn_cap,
                    q_chunk):
    """Plain attention in q chunks: q (B, L, H, D) over k, v (B, L, K, D),
    H a multiple of K; o (B, L, H, D) in q's dtype."""
    B, L, H, D = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, L, n_kv, H // n_kv, D)
    n_chunks = max(1, L // q_chunk) if L % q_chunk == 0 else 1
    qc = L // n_chunks
    outs = []
    for c in range(n_chunks):
        qi = qg[:, c * qc:(c + 1) * qc]
        s = torch.einsum("bqkgd,blkd->bkgql", qi, k).float()
        s = softcap(s * scale, attn_cap)
        mask = _scores_mask(positions[c * qc:(c + 1) * qc], positions,
                            causal, window)
        s = torch.where(mask, s, -1e30)
        pr = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkgql,blkd->bqkgd", pr, v))
    return torch.cat(outs, dim=1).reshape(B, L, H, D)


def _flash_sharded(q, k, v, scale, causal, window, softcap, block):
    """The flash kernel per shard (``_per_shard``) on ``q``, ``k``, ``v``
    (B, H, L, D); called directly without a mesh."""
    def call(a, b, c):
        return flash_attention(a, b, c, scale, causal, window, softcap,
                               block, block)
    return _per_shard(q, k, v, call)


def _per_shard(q, k, v, call, heads: int = 1):
    """``call`` (attention on plain tensors whose dim ``heads`` holds the
    heads: (B, H, L, D) by default, (B, L, H, D) with ``heads=2``) per
    shard: DTensor has no sharding rule for it, so each rank calls it on
    its own slice of ``q``, ``k``, ``v`` over the batch and head axes the
    rules shard them on — the counterpart of the reference's fully manual
    ``shard_map``.  Where the q-heads are split and the kv-heads
    replicated (``kv_heads`` dropped for divisibility), each rank slices
    its own kv group, as the reference does; that slice's gradient is
    then one rank's term (``Partial``).  Without a mesh, on a mesh of one
    device, or with no sharded axis left, ``call`` takes the tensors (or
    their local blocks) as they are."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(q) or q.device_mesh.size() == 1:
        if is_dtensor(q):
            from torch.distributed.tensor import DTensor
            o = call(q.to_local(), k.to_local(), v.to_local())
            return DTensor.from_local(o, q.device_mesh, q.placements)
        return call(q, k, v)
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    axes = [None] * 4
    axes[0], axes[heads] = "batch", "act_heads"
    qpl = ctx.placements(axes, q.shape, mesh=mesh)
    kpl = ctx.placements(axes, k.shape, mesh=mesh)
    Hq, Hkv = q.shape[heads], k.shape[heads]
    g = Hq // Hkv
    head_dims = [i for i, pl in enumerate(qpl) if pl == Shard(heads)]
    sliced = bool(head_dims) and not any(pl == Shard(heads) for pl in kpl)
    kgrad = tuple(Partial() if i in head_dims else pl
                  for i, pl in enumerate(kpl)) if sliced else kpl
    a = q.redistribute(mesh, qpl).to_local()
    b = k.redistribute(mesh, kpl).to_local(grad_placements=kgrad)
    c = v.redistribute(mesh, kpl).to_local(grad_placements=kgrad)
    H_loc = a.shape[heads]
    if sliced and H_loc < Hq:
        # q-heads sharded, kv replicated: slice this shard's group
        idx = 0
        for i in head_dims:                 # major first
            idx = idx * mesh.size(i) + mesh.get_local_rank(names[i])
        kvn = max(1, H_loc // g)
        start = (idx * H_loc) // g
        b = b.narrow(heads, start, kvn)
        c = c.narrow(heads, start, kvn)
    return DTensor.from_local(call(a, b, c), mesh, qpl)


# -- cross attention ----------------------------------------------------------

def cross_kv(p, kv_x):
    """Cross-attention K/V projected from the (vision/audio) memory tokens,
    in the memory's dtype."""
    return _project_kv(p, kv_x)


def cross_attn_forward(p, x, k, v, *, n_heads: int, n_kv: int,
                       head_dim: int):
    """Unmasked attention of ``x`` to memory ``k``, ``v`` (B, M, K, D),
    softmax in f32, gated output.  K and V may be bf16 under f32 compute
    (the memory stays bf16): the products then run in f32, as jnp's
    promotion runs them in the reference."""
    q = _project_q(p, x)
    scale = 1.0 / math.sqrt(head_dim)

    def attend(q, k, v):                # (B, L, H, D) over (B, M, K, D)
        Bq, Lq, H, D = q.shape
        K = k.shape[2]
        dt = torch.promote_types(q.dtype, k.dtype)
        qg = q.reshape(Bq, Lq, K, H // K, D).to(dt)
        s = torch.einsum("bqkgd,blkd->bkgql", qg, k.to(dt)).float() * scale
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        dt = torch.promote_types(pr.dtype, v.dtype)
        o = torch.einsum("bkgql,blkd->bqkgd", pr.to(dt), v.to(dt))
        return o.reshape(Bq, Lq, H, D)
    # on DTensors on each rank's rows and heads, as self-attention
    return _out(p, _per_shard(q, k, v, attend, heads=2), gated=True)


# -- decode -------------------------------------------------------------------

def init_kv_cache_defs(batch: int, cache_len: int, n_kv: int, head_dim: int,
                       dtype: str = "bfloat16",
                       seq_sharded: bool = False) -> dict:
    seq_ax = "kv_seq" if seq_sharded else None
    return {
        "k": ParamDef((batch, cache_len, n_kv, head_dim),
                      ("batch", seq_ax, "kv_heads", None), dtype=dtype,
                      init="zeros"),
        "v": ParamDef((batch, cache_len, n_kv, head_dim),
                      ("batch", seq_ax, "kv_heads", None), dtype=dtype,
                      init="zeros"),
    }


def attn_decode(p, x, cache, pos: int, *, n_heads: int, n_kv: int,
                head_dim: int, window: int | None = None,
                rope_theta: float = 10000.0, rotary_dim: int | None = None,
                use_rope: bool = True, attn_cap: float | None = None):
    """One decode step. ``x``: (B, 1, M); ``pos``: the current position.
    ``cache['k']``: (B, S, K, D) where S == window for ring caches, else
    max_len.  Writes this step's k/v into ``cache`` in place (where the
    reference donates the buffers) and returns ``(y, cache)``."""
    B, _, M = x.shape
    S = cache["k"].shape[1]
    q = _project_q(p, x)
    k1, v1 = _project_kv(p, x)
    if use_rope:
        posb = torch.full((1,), pos, device=x.device)
        q = _rope_heads(q, posb, rope_theta, rotary_dim)
        k1 = _rope_heads(k1, posb, rope_theta, rotary_dim)
    slot = pos % S
    write_slot(cache["k"], k1, slot)
    write_slot(cache["v"], v1, slot)
    # position held by each ring slot j: latest value p <= pos with p%S == j
    slots = torch.arange(S, device=cache["k"].device)
    kpos = pos - ((pos - slots) % S)
    valid = kpos >= 0
    if window is not None:
        valid &= (pos - kpos) < window
    scale = 1.0 / math.sqrt(head_dim)

    def attend(q, k, v):                # (B, 1, H, D) over (B, S, K, D)
        Bq, _, H, D = q.shape
        K = k.shape[2]
        qg = q.reshape(Bq, 1, K, H // K, D)
        s = torch.einsum("bqkgd,blkd->bkgql", qg, k.to(q.dtype)).float()
        s = softcap(s * scale, attn_cap)
        s = torch.where(valid, s, -1e30)
        pr = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bkgql,blkd->bqkgd", pr, v.to(q.dtype))
        return o.reshape(Bq, 1, H, D)
    if is_dtensor(q) and seq_split(cache["k"]):
        o = _decode_seq_split(q, cache, valid, scale, attn_cap)
        return _out(p, o), cache
    # on DTensors on each rank's rows and heads (the cache split as q is)
    return _out(p, _per_shard(q, cache["k"], cache["v"], attend,
                              heads=2)), cache


def write_slot(buf, new, slot) -> None:
    """``buf[:, slot] = new[:, 0]`` in ``buf``'s dtype, in place; on
    DTensors each rank writes its own block (``new`` placed as ``buf``;
    of a cache split over its sequence, ``kv_seq``, the rank whose slots
    hold ``slot``)."""
    if not is_dtensor(buf):
        buf[:, slot] = new[:, 0].to(buf.dtype)
        return
    pl = _whole_sequence(buf.placements)
    if is_dtensor(new):
        new = new.redistribute(buf.device_mesh, pl).to_local()
    start, n = slot_range(buf)
    if start <= slot < start + n:
        buf.to_local()[:, slot - start] = new[:, 0].to(buf.dtype)


def seq_split(t) -> bool:
    """Whether a (B, S, ...) DTensor cache is split over its sequence."""
    return is_dtensor(t) and any(pl.is_shard(1) for pl in t.placements)


def _whole_sequence(placements) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if pl.is_shard(1) else pl for pl in placements)


def slot_range(t) -> tuple:
    """``(start, n)``: the slots of a (B, S, ...) DTensor cache this rank
    holds (all of them where the sequence is whole): DTensor splits it
    evenly over the mesh dims that shard it, the first major."""
    names = t.device_mesh.mesh_dim_names
    dims = [i for i, pl in enumerate(t.placements) if pl.is_shard(1)]
    n = t.to_local().shape[1]
    idx = 0
    for i in dims:
        idx = idx * t.device_mesh.size(i) + \
            t.device_mesh.get_local_rank(names[i])
    return idx * n, n


def _decode_seq_split(q, cache, valid, scale, attn_cap):
    """One token's attention over a cache split over its sequence: every
    rank scores its slots for every head, and the softmax is combined
    over the mesh dims that split the sequence (the running max, the sum
    of exponents and the weighted values, each summed once).  ``q``
    (B, 1, H, D) comes back as (B, 1, H, D), whole over those dims."""
    from torch.distributed.tensor import DTensor
    from ..distributed.collectives import all_reduce
    kc, vc = cache["k"], cache["v"]
    mesh, names = kc.device_mesh, kc.device_mesh.mesh_dim_names
    groups = [mesh.get_group(names[i])
              for i, pl in enumerate(kc.placements) if pl.is_shard(1)]
    qpl = _whole_sequence(kc.placements)
    a = q.redistribute(mesh, qpl).to_local()             # (B, 1, H, D)
    k, v = kc.to_local(), vc.to_local()                  # (B, n, K, D)
    start, n = slot_range(kc)
    Bq, _, H, D = a.shape
    K = k.shape[2]
    qg = a.reshape(Bq, 1, K, H // K, D)
    s = torch.einsum("bqkgd,blkd->bkgql", qg, k.to(a.dtype)).float()
    s = softcap(s * scale, attn_cap)
    s = torch.where(valid[start:start + n], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    for g in groups:
        m = all_reduce(m, g, "max")
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)                      # (B, K, g, 1, 1)
    o = torch.einsum("bkgql,blkd->bqkgd", e, v.float())  # (B, 1, K, g, D)
    for g in groups:
        l = all_reduce(l, g)
        o = all_reduce(o, g)
    o = o / l.permute(0, 3, 1, 2, 4)
    return DTensor.from_local(o.reshape(Bq, 1, H, D).to(a.dtype), mesh,
                              qpl)
