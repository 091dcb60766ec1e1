"""Mamba-2 SSD (state-space duality) blocks — arXiv:2405.21060.

Prefill uses the chunked SSD algorithm: quadratic attention-like compute
inside chunks of ``chunk`` tokens, linear state passing across chunks (a
loop over the chunks carrying the state in f32, where the reference
scans).  Decode is the pure recurrence ``S <- exp(dt*A) S + dt B^T x``,
written into the cache in place (where the reference donates it).  The
reference is plain array code with no kernel of its own, so plain torch
is its port.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..distributed.sharding import (current_ctx, is_dtensor,
                                    mesh_axis_sizes, shard)
from ..spans import region
from .layers import rms_norm
from .params import ParamDef

__all__ = ["ssd_defs", "ssd_forward", "ssd_forward_with_state", "ssd_decode",
           "ssd_cache_defs", "SSMDims"]


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int
    headdim: int
    d_state: int
    n_groups: int = 1
    conv_width: int = 4

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssd_defs(dims: SSMDims) -> dict:
    proj_out = 2 * dims.d_inner + 2 * dims.n_groups * dims.d_state + dims.n_heads
    return {
        "in_proj": ParamDef((dims.d_model, proj_out), ("embed", "ssm_heads"),
                            init="fan_in"),
        "conv_w": ParamDef((dims.conv_width, dims.conv_dim), (None, "ssm_heads"),
                           init="fan_in"),
        "conv_b": ParamDef((dims.conv_dim,), ("ssm_heads",), init="zeros"),
        "A_log": ParamDef((dims.n_heads,), ("ssm_heads",), init="ones"),
        "D": ParamDef((dims.n_heads,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((dims.n_heads,), ("ssm_heads",), init="zeros"),
        "norm": ParamDef((dims.d_inner,), ("ssm_heads",), init="zeros"),
        "out_proj": ParamDef((dims.d_inner, dims.d_model),
                             ("ssm_heads", "embed"), init="fan_in"),
    }


def _split_proj(p, x, dims: SSMDims):
    zxbcdt = torch.einsum("blm,mn->bln", x, p["in_proj"].to(x.dtype))
    # the reference splits at indices, torch.split takes sizes
    return torch.split(zxbcdt, [dims.d_inner, dims.conv_dim, dims.n_heads],
                       dim=-1)


def _causal_conv(p, xBC, dims: SSMDims):
    w = p["conv_w"].to(xBC.dtype)               # (W, C) depthwise
    pad = dims.conv_width - 1
    xp = F.pad(xBC, (0, 0, pad, 0))
    out = torch.zeros_like(xBC)
    for i in range(dims.conv_width):            # W is tiny (4): unrolled taps
        out = out + xp[:, i:i + xBC.shape[1], :] * w[i]
    return F.silu(out + p["conv_b"].to(xBC.dtype))


def _split_xbc(xBC, dims: SSMDims):
    gn = dims.n_groups * dims.d_state
    x_, Bm, Cm = torch.split(xBC, [dims.d_inner, gn, gn], dim=-1)
    B_, L = x_.shape[0], x_.shape[1]
    x_ = x_.reshape(B_, L, dims.n_heads, dims.headdim)
    Bm = Bm.reshape(B_, L, dims.n_groups, dims.d_state)
    Cm = Cm.reshape(B_, L, dims.n_groups, dims.d_state)
    hpg = dims.n_heads // dims.n_groups
    Bm = Bm.repeat_interleave(hpg, dim=2)       # (B, L, H, N)
    Cm = Cm.repeat_interleave(hpg, dim=2)
    return x_, Bm, Cm


def ssd_forward(p, x, dims: SSMDims, chunk: int = 256):
    y, _ = _ssd_full(p, x, dims, chunk)
    return y


def ssd_forward_with_state(p, x, dims: SSMDims, chunk: int = 256):
    """Prefill variant: also returns the decode cache
    {"S": final state, "conv": last conv_width-1 raw xBC}."""
    return _ssd_full(p, x, dims, chunk)


def _ssd_full(p, x, dims: SSMDims, chunk: int = 256):
    """(out, cache).  Under a mesh (DTensor operands) the chunk scan runs
    on each rank's data shard (``_scan_per_shard``), and the output
    projection after it under the rules again."""
    scan = {k: v for k, v in p.items() if k != "out_proj"}
    if is_dtensor(x):
        y, cache = _scan_per_shard(scan, x, dims, chunk)
    else:
        y, cache = _ssd_scan(scan, x, dims, chunk)
    y = shard(y, "batch", None, "act_mlp")
    out = torch.einsum("bli,im->blm", y, p["out_proj"].to(y.dtype))
    return out, cache


def _scan_per_shard(p, x, dims: SSMDims, chunk: int):
    """The chunk scan on DTensors, which no DTensor sharding rule covers:
    each rank runs it on the rows of its data shard (the batch split over
    the non-manual data axes, where it divides) with the parameters whole,
    and its outputs keep that split.  The heads stay whole on every model
    rank: ``in_proj``'s columns interleave z, x, B, C and dt.  Each rank's
    parameter gradients are its rows' terms (``Partial`` over the data
    axes)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ctx = current_ctx()
    mesh = x.device_mesh
    sizes = mesh_axis_sizes(mesh)
    manual = ctx.manual if ctx is not None else frozenset()
    dp = tuple(a for a in ("pod", "data") if a in sizes and a not in manual)
    if x.shape[0] % math.prod(sizes[a] for a in dp):
        dp = ()
    rows = tuple(Shard(0) if a in dp else Replicate()
                 for a in mesh.mesh_dim_names)
    terms = tuple(Partial() if a in dp else Replicate()
                  for a in mesh.mesh_dim_names)
    whole = (Replicate(),) * mesh.ndim

    def local(t, placements, grads):
        if not is_dtensor(t):
            return t
        return t.redistribute(t.device_mesh, placements).to_local(
            grad_placements=grads)
    y, cache = _ssd_scan({k: local(v, whole, terms) for k, v in p.items()},
                         local(x, rows, rows), dims, chunk)
    return (DTensor.from_local(y, mesh, rows),
            {k: DTensor.from_local(v, mesh, rows) for k, v in cache.items()})


def _ssd_scan(p, x, dims: SSMDims, chunk: int):
    """The SSD block up to its output projection: (y, cache)."""
    B, L, M = x.shape
    z, xBC, dt = _split_proj(p, x, dims)
    xBC_raw_tail = xBC[:, L - (dims.conv_width - 1):, :]
    xBC = _causal_conv(p, xBC, dims)
    xh, Bm, Cm = _split_xbc(xBC, dims)
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B, L, H)
    A = -torch.exp(p["A_log"].float())                       # (H,)
    y, S = region("repro_torch.ssd.scan", _chunk_scan, xh, Bm, Cm, dt, A,
                  chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, L, dims.d_inner)
    y = rms_norm(y * F.silu(z), p["norm"])
    # the raw (pre-conv) tail, in a buffer of its own: decode writes it
    cache = {"S": S,
             "conv": xBC_raw_tail.to(torch.bfloat16, copy=True,
                                     memory_format=torch.contiguous_format)}
    return y, cache


def _chunk_scan(xh, Bm, Cm, dt, A, chunk: int):
    """The chunk loop: (y (B, L, H, P) in ``xh``'s dtype, the final state
    S (B, H, N, P) in f32)."""
    B, L, H, P = xh.shape
    Q = chunk if L % chunk == 0 else L
    nc = L // Q

    def chunked(t):                             # (nc, B, Q, ...)
        return t.reshape(B, nc, Q, *t.shape[2:]).transpose(0, 1)

    S = torch.zeros((B, H, Bm.shape[-1], P), dtype=torch.float32,
                    device=xh.device)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    for xc, Bc, Cc, dtc in zip(chunked(xh), chunked(Bm), chunked(Cm),
                               chunked(dt)):
        xc, Bc, Cc = xc.float(), Bc.float(), Cc.float()
        a = dtc * A                              # (B,Q,H)
        acum = torch.cumsum(a, dim=1)            # (B,Q,H)
        # intra-chunk (quadratic in Q)
        cb = torch.einsum("bqhn,bkhn->bhqk", Cc, Bc)
        # above the diagonal acum_q - acum_k is positive and its exp
        # overflows to inf once a chunk's |dt*A| sums past ~88; masking
        # the product afterwards keeps the forward finite but the backward
        # then multiplies a zero cotangent by inf (nan).  Mask the exponent
        # instead: exp(-inf) = 0, whose gradient is 0 too.  (The reference
        # masks the product and gives nan gradients at chunk 256.)
        diff = torch.where(mask[:, :, None],
                           acum[:, :, None] - acum[:, None, :],
                           float("-inf"))                       # (B,Q,K,H)
        decay = torch.exp(diff).permute(0, 3, 1, 2)             # (B,H,Q,K)
        w = cb * decay
        w = w * dtc.transpose(1, 2)[:, :, None, :]              # * dt_j
        y_intra = torch.einsum("bhqk,bkhp->bqhp", w, xc)
        # inter-chunk: contribution of incoming state
        y_inter = torch.einsum("bqhn,bhnp->bqhp", Cc, S) \
            * torch.exp(acum)[..., None]
        # state update
        a_tot = acum[:, -1]                                     # (B,H)
        rdecay = torch.exp(a_tot[:, None] - acum)               # (B,Q,H)
        Bw = Bc * (dtc * rdecay)[..., None]
        dBx = torch.einsum("bkhn,bkhp->bhnp", Bw, xc)
        S = torch.exp(a_tot)[..., None, None] * S + dBx
        ys.append((y_intra + y_inter).to(xh.dtype))
    return torch.stack(ys).transpose(0, 1).reshape(B, L, H, P), S


# -- decode -------------------------------------------------------------------

def ssd_cache_defs(batch: int, dims: SSMDims, dtype: str = "float32") -> dict:
    return {
        "S": ParamDef((batch, dims.n_heads, dims.d_state, dims.headdim),
                      ("batch", "ssm_heads", None, None), dtype=dtype,
                      init="zeros"),
        "conv": ParamDef((batch, dims.conv_width - 1, dims.conv_dim),
                         ("batch", None, "ssm_heads"), dtype="bfloat16",
                         init="zeros"),
    }


def ssd_decode(p, x, cache, dims: SSMDims):
    """One token. ``x``: (B, 1, M).  Writes the new state and conv window
    into ``cache`` in place (the model's decode keeps the stacked cache it
    was given) and returns ``(y, cache)``.  On DTensors each rank decodes
    the rows of its data shard with the parameters and heads whole, as
    the scan runs (``_scan_per_shard``), and writes its blocks of the new
    state back into the cache's placements."""
    if is_dtensor(x):
        return _decode_per_shard(p, x, cache, dims)
    return _decode(p, x, cache, dims)


def _decode_per_shard(p, x, cache, dims: SSMDims):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    sizes = mesh_axis_sizes(mesh)
    ctx = current_ctx()
    manual = ctx.manual if ctx is not None else frozenset()
    dp = tuple(a for a in ("pod", "data") if a in sizes and a not in manual)
    if x.shape[0] % math.prod(sizes[a] for a in dp):
        dp = ()
    rows = tuple(Shard(0) if a in dp else Replicate()
                 for a in mesh.mesh_dim_names)
    whole = (Replicate(),) * mesh.ndim

    def local(t, placements):
        return t.redistribute(t.device_mesh, placements).to_local() \
            if is_dtensor(t) else t
    mine = {k: local(v, rows) for k, v in cache.items()}
    out, mine = _decode({k: local(v, whole) for k, v in p.items()},
                        local(x, rows), mine, dims)
    for k, t in cache.items():          # each rank's blocks, in place
        t.to_local().copy_(DTensor.from_local(mine[k], mesh, rows)
                           .redistribute(mesh, t.placements).to_local())
    return DTensor.from_local(out, mesh, rows), cache


def _decode(p, x, cache, dims: SSMDims):
    B = x.shape[0]
    z, xBC, dt = _split_proj(p, x, dims)        # (B,1,*)
    window = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)  # (B,W,C)
    w = p["conv_w"].to(xBC.dtype)
    conv_out = torch.einsum("bwc,wc->bc", window, w) + p["conv_b"].to(
        xBC.dtype)
    xBC1 = F.silu(conv_out)[:, None, :]
    xh, Bm, Cm = _split_xbc(xBC1, dims)         # (B,1,H,P),(B,1,H,N)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())   # (B,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                     # (B,H)
    dBx = torch.einsum("bhn,bhp->bhnp", Bm[:, 0].float() * dt[..., None],
                       xh[:, 0].float())
    S_new = dA[..., None, None] * cache["S"] + dBx
    y = torch.einsum("bhn,bhnp->bhp", Cm[:, 0].float(), S_new)
    y = y.to(x.dtype) + xh[:, 0] * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(B, 1, dims.d_inner)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = torch.einsum("bli,im->blm", y, p["out_proj"].to(x.dtype))
    cache["S"].copy_(S_new)
    cache["conv"].copy_(window[:, 1:, :])
    return out, cache
