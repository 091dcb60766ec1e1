"""Mixture-of-Experts FFN: top-k routing with fixed capacity.

Two dispatch paths share the routing math, as in the reference:
  * ``gather`` — the dispatch buffer filled by a scatter-add of each kept
    (token, choice) into its expert's next free slot, gathered back and
    weighted in the combine.  Every other ``dispatch`` value (the
    reference's ``a2a`` included) takes it, as in the reference;
  * ``local`` — under a sharding context whose mesh has a non-manual
    ``"model"`` axis, each data shard is routed alone (the reference's
    ``_moe_forward_local``); without such a mesh it is the gather path.

On DTensors both run on each rank's blocks (``_moe_forward_sharded``):
its data shard's tokens and its model rank's slice of the experts, ONE
sum over the model axis combining them.

Supports DeepSeek-MoE shared experts (always-on) and Arctic's parallel
dense residual branch (handled at the block level).  The reference
computes the block outside any Pallas kernel, so plain torch is its port.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..distributed.sharding import (current_ctx, is_dtensor,
                                    mesh_axis_sizes, shard)
from ..spans import region, span
from .layers import mlp_defs, mlp_forward
from .params import ParamDef

__all__ = ["MoEDims", "moe_defs", "moe_forward"]


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0         # always-active shared experts (deepseek)
    capacity_factor: float = 1.25
    renorm_topk: bool = True  # renormalize the top-k gate weights
    dispatch: str = "gather"  # gather | a2a (the gather path) | local


def moe_defs(dims: MoEDims) -> dict:
    E, M, F_ = dims.n_experts, dims.d_model, dims.d_ff
    d = {
        "router": ParamDef((M, E), ("embed", None), init="fan_in"),
        "w_gate": ParamDef((E, M, F_), ("experts", "embed", "expert_mlp"),
                           init="fan_in"),
        "w_up": ParamDef((E, M, F_), ("experts", "embed", "expert_mlp"),
                         init="fan_in"),
        "w_down": ParamDef((E, F_, M), ("experts", "expert_mlp", "embed"),
                           init="fan_in"),
    }
    if dims.n_shared:
        d["shared"] = mlp_defs(M, F_ * dims.n_shared, gated=True)
    return d


def _gates(p, xf, dims: MoEDims):
    """Router: returns (weights (T,k), experts (T,k), probs (T,E))."""
    logits = torch.einsum("tm,me->te", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, dims.top_k, dim=-1)
    if dims.renorm_topk:
        top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    return top_w, top_e, probs


def _balance(me, ce, dims: MoEDims):
    """Switch-style load-balance aux loss from the mean router probability
    ``me`` and the top-1 share ``ce`` of each expert."""
    return dims.n_experts * torch.sum(me * ce)


def _route(p, xf, dims: MoEDims):
    """Router: returns (weights (T,k), experts (T,k), aux_loss)."""
    top_w, top_e, probs = _gates(p, xf, dims)
    T = xf.shape[0]
    me = torch.mean(probs, dim=0)                                 # (E,)
    ce = _counts(top_e[:, 0], dims.n_experts).float() / T
    return top_w, top_e, _balance(me, ce, dims)


def _counts(idx, n: int):
    """``torch.bincount(idx, minlength=n)`` for indices below ``n``, as a
    scatter-add: the same int64 counts with a shape that does not depend
    on the values (a fake trace cannot give bincount one)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx.long(), torch.ones(idx.shape, dtype=torch.int64,
                                  device=idx.device))


def _capacity(T: int, dims: MoEDims) -> int:
    c = int(T * dims.top_k / dims.n_experts * dims.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def _positions(e_flat, n_experts: int):
    """Each (token, choice)'s position among the earlier choices of its
    expert, in (token, choice) order; int32, as the reference counts."""
    experts = torch.arange(n_experts, device=e_flat.device)
    onehot = (e_flat[:, None] == experts).to(torch.int32)  # (T*k, E)
    before = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return torch.gather(before, 1, e_flat[:, None])[:, 0]


def _expert_ffn(p, h, x_dtype):
    g = torch.bmm(h, p["w_gate"].to(x_dtype))             # (E, C, F)
    u = torch.bmm(h, p["w_up"].to(x_dtype))
    a = shard(F.silu(g) * u, "act_experts", None, None)
    return torch.bmm(a, p["w_down"].to(x_dtype))


def _dispatch(xf, e, pos_c, keep, n_experts: int, slots: int, k: int):
    """The (n_experts, slots, M) buffer: a kept (token, choice) owns its
    slot; a dropped one adds zeros into (e, C-1), so the sum is exact in
    any order."""
    t_idx = torch.arange(e.shape[0], device=xf.device) // k
    contrib = torch.where(keep[:, None], xf[t_idx], 0).to(xf.dtype)
    disp = torch.zeros((n_experts, slots, xf.shape[1]), dtype=xf.dtype,
                       device=xf.device)
    return disp.index_put((e, pos_c), contrib, accumulate=True)


def _combine(out_e, e, pos_c, top_w, keep, k: int):
    """Each token's kept choices gathered back from the experts' output,
    weighted and summed: (T, M)."""
    gathered = out_e[e, pos_c]                            # (T*k, M)
    w_flat = (top_w.reshape(-1) * keep).to(out_e.dtype)
    return torch.sum((gathered * w_flat[:, None]).reshape(
        -1, k, out_e.shape[-1]), dim=1)


def moe_forward(p, x, dims: MoEDims):
    """``x``: (B, L, M) -> (B, L, M), plus aux loss scalar."""
    if is_dtensor(x):
        with span("repro_torch.moe"):
            return _moe_forward_sharded(p, x, dims, current_ctx())
    return region("repro_torch.moe", _moe_forward_gather, p, x, dims)


def _moe_forward_gather(p, x, dims: MoEDims):
    B, L, M = x.shape
    T = B * L
    xf = x.reshape(T, M)
    top_w, top_e, aux = region("repro_torch.moe.route", _route, p, xf, dims)
    C = _capacity(T, dims)
    E, k = dims.n_experts, dims.top_k

    # position of each (token, choice) within its expert's capacity
    with span("repro_torch.moe.positions"):
        e_flat = top_e.reshape(T * k)                     # (T*k,)
        pos = _positions(e_flat, E)
        keep = pos < C
        pos_c = torch.clamp(pos, max=C - 1).long()

    disp = region("repro_torch.moe.dispatch", _dispatch, xf, e_flat, pos_c,
                  keep, E, C, k)
    disp = shard(disp, "act_experts", None, None)
    out_e = region("repro_torch.moe.experts", _expert_ffn, p, disp,
                   x.dtype)                               # (E, C, M)
    y = region("repro_torch.moe.combine", _combine, out_e, e_flat, pos_c,
               top_w, keep, k)

    if dims.n_shared:
        y = y + mlp_forward(p["shared"], xf)
    return y.reshape(B, L, M), aux


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------

def _local(t, placements, grad_placements=None):
    """``t`` (a DTensor) redistributed to ``placements`` on its mesh and
    handed over as this rank's plain block; its gradient comes back as
    ``grad_placements`` (by default the same).  A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    t = t.redistribute(t.device_mesh, placements)
    return t.to_local(grad_placements=grad_placements or placements)


def _shards_before(counts, mesh, dp_axes, sizes):
    """``counts`` summed over the data shards whose tokens come before
    this rank's in the batch (DTensor splits the batch over the data axes
    major first, in mesh order)."""
    from ..distributed.collectives import all_gather
    every = counts
    for a in reversed(dp_axes):
        every = all_gather(every, mesh.get_group(a))
    idx = 0
    for a in dp_axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return every.reshape(-1, counts.shape[0])[:idx].sum(dim=0)


def _moe_forward_sharded(p, x, dims: MoEDims, ctx):
    """The MoE block on DTensors, run on each rank's plain blocks (the
    dispatch's index ops have no DTensor sharding rule): each rank routes
    the tokens of its data shard, builds the dispatch buffer for its
    model rank's slice of the experts only, and ONE sum of the (T, M)
    output over ``"model"`` combines them (the reference's
    ``_moe_forward_local``: the structurally minimal EP collective).

    ``dispatch="local"`` (with a non-manual ``"model"`` axis, experts and
    batch that split evenly) routes each data shard alone, as the
    reference's local path does: the capacity from the shard's tokens,
    aux the mean of the shards'.  Every other dispatch gives the gather
    path's result over the whole batch, as the reference's partitioned
    gather does: each expert's positions are offset by its counts in the
    data shards before this one, the capacity and aux come from the whole
    batch, and the buffer's slots are summed and split over the data
    axes (a reduce-scatter: each data rank runs the experts on its share
    of the slots), then gathered back for the combine.  Experts that do
    not split over ``"model"`` stay whole on every model rank, a batch
    that does not split over the data axes whole on every data rank.

    Gradients are the whole function's: the combine's sum has an identity
    backward (every model rank uses the summed output), the slots'
    reduce-scatter and gather are each other's backward, aux enters
    divided by the ranks it is summed over, so the router's, input's and
    experts' per-rank terms come back as ``Partial`` sums."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..distributed.collectives import (all_gather_dim, all_reduce,
                                           psum_replicated,
                                           reduce_scatter_dim)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = mesh_axis_sizes(mesh)
    manual = ctx.manual if ctx is not None else frozenset()
    B, L, M = x.shape
    E, k = dims.n_experts, dims.top_k
    dp_axes = tuple(a for a in ("pod", "data")
                    if a in sizes and a not in manual)
    n_dp = math.prod(sizes[a] for a in dp_axes)
    ep_axes = ("model",) if "model" in sizes and "model" not in manual \
        else ()
    per_shard = dims.dispatch == "local" and bool(ep_axes) and \
        E % sizes["model"] == 0 and B % n_dp == 0
    if B % n_dp:
        dp_axes, n_dp = (), 1
    if ep_axes and E % sizes["model"]:
        ep_axes = ()
    n_ep = sizes["model"] if ep_axes else 1
    E_loc = E // n_ep
    e_lo = (mesh.get_local_rank("model") if ep_axes else 0) * E_loc
    groups = {a: mesh.get_group(a) for a in dp_axes + ep_axes}

    def placed(dp, model):
        return tuple(dp if a in dp_axes else model if a in ep_axes
                     else Replicate() for a in names)
    rep = (Replicate(),) * mesh.ndim
    # tokens: each data shard's own, the same on every model rank (whose
    # gradient terms sum over the model axis)
    xx = _local(x, placed(Shard(0), Replicate()),
                placed(Shard(0), Partial()))
    router = {"router": _local(p["router"], rep,
                               placed(Partial(), Partial()))}
    w = {n: _local(p[n], placed(Replicate(), Shard(0)),
                   placed(Partial(), Shard(0)))
         for n in ("w_gate", "w_up", "w_down")}

    Bb, Ll, _ = xx.shape
    T = Bb * Ll
    xf = xx.reshape(T, M)
    with span("repro_torch.moe.route"):
        if per_shard:
            top_w, top_e, aux = _route(router, xf, dims)
            for a in dp_axes:
                aux = psum_replicated(aux / sizes[a], groups[a])
        else:
            top_w, top_e, probs = _gates(router, xf, dims)
            me = torch.sum(probs, dim=0)
            top1 = _counts(top_e[:, 0], E)
            for a in dp_axes:
                me = psum_replicated(me, groups[a])
                top1 = all_reduce(top1, groups[a])
            aux = _balance(me / (T * n_dp), top1.float() / (T * n_dp), dims)
    with span("repro_torch.moe.positions"):
        e_flat = top_e.reshape(T * k)
        pos = _positions(e_flat, E)
        if per_shard:
            C = slots = _capacity(T, dims)
        else:
            if dp_axes:
                before = _shards_before(_counts(e_flat, E),
                                        mesh, dp_axes, sizes)
                pos = pos + before.to(pos.dtype)[e_flat]
            C = _capacity(T * n_dp, dims)
            slots = -(-C // n_dp) * n_dp      # an equal share a data rank
        keep = pos < C
        mine = keep & (e_flat >= e_lo) & (e_flat < e_lo + E_loc)
        e_loc = torch.clamp(e_flat - e_lo, 0, E_loc - 1)
        pos_c = torch.clamp(pos, max=C - 1).long()

    with span("repro_torch.moe.dispatch"):
        disp = _dispatch(xf, e_loc, pos_c, mine, E_loc, slots, k)
        if not per_shard:
            for a in dp_axes:
                disp = reduce_scatter_dim(disp, 1, groups[a])
    with span("repro_torch.moe.experts"):
        out_e = _expert_ffn(w, disp, xx.dtype)
    with span("repro_torch.moe.combine"):
        if not per_shard:
            for a in reversed(dp_axes):
                out_e = all_gather_dim(out_e, 1, groups[a])
        y = _combine(out_e, e_loc, pos_c, top_w, mine, k)
    for a in ep_axes:
        y = psum_replicated(y, groups[a])        # THE one EP collective
        aux = psum_replicated(aux / n_ep, groups[a])
    y = DTensor.from_local(y.reshape(Bb, Ll, M), mesh,
                           placed(Shard(0), Replicate()))
    aux = DTensor.from_local(aux, mesh, rep)
    if dims.n_shared:
        y = y + mlp_forward(p["shared"], x.reshape(B * L, M)).reshape(
            B, L, M)
    return y, aux
