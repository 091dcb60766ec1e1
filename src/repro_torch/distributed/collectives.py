"""Collective helpers: compressed cross-pod gradient reduction and
communication/compute overlap utilities.

``compressed_psum_tree`` implements error-feedback int8 gradient
compression for the slow "pod" axis: quantize to int8 with a per-tensor
scale, sum the int8 payload (8x fewer bytes over the wire), dequantize, and
carry the quantization error into the next step's feedback buffer.

Where the JAX package names a ``shard_map`` axis, these take ``group``: a
``torch.distributed`` process group, a mesh dim name of the active sharding
context's ``DeviceMesh``, or a one-dim ``DeviceMesh``.  Every rank of the
group calls them with tensors of the same shapes.

The collectives a model layer runs (``psum_replicated``,
``reduce_scatter_dim``, ``all_gather_dim``, ``all_reduce``, ``all_gather``)
are functional ops (``_c10d_functional``): their outputs are new tensors.
The remat policy keeps the reductions' outputs (``models/model.py``
``_collectives_saveable``), so a layer's recompute in the backward runs
no reduction again; it gathers again what it gathered.  An in-place c10d
call could not be kept so: the recompute would skip it and read its
input unreduced.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.params import tree_leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_tree",
           "reduce_scatter_then_gather", "psum_replicated", "process_group",
           "reduce_scatter_dim", "all_gather_dim", "all_reduce",
           "all_gather"]

_funcol = torch.ops._c10d_functional


def process_group(group):
    """The process group ``group`` names (see the module's docstring)."""
    if isinstance(group, str):
        from .sharding import current_ctx
        ctx = current_ctx()
        if ctx is None or not hasattr(ctx.mesh, "get_group"):
            raise ValueError(f"mesh axis {group!r} needs an active sharding "
                             f"context over a DeviceMesh")
        return ctx.mesh.get_group(group)
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def quantize_int8(x: torch.Tensor) -> tuple:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compressed_psum_tree(grads, group, error_fb=None):
    """Error-feedback int8 sum of ``grads`` over ``group``.

    Returns (reduced_grads, new_error_feedback).  With an ``error_fb`` tree
    the residual of the previous step's quantization is added before
    quantizing (EF-SGD), keeping the compressed reduction unbiased over
    time.  The int8 payloads are summed as int32, the scales take their
    maximum, as in the JAX package."""
    pg = process_group(group)
    leaves = tree_leaves(grads)
    fb = (tree_leaves(error_fb) if error_fb is not None
          else [torch.zeros_like(g, dtype=torch.float32) for g in leaves])
    outs, new_fb = [], []
    for g, e in zip(leaves, fb):
        g32 = g.to(torch.float32) + e
        q, scale = quantize_int8(g32)
        new_fb.append(g32 - dequantize_int8(q, scale))   # local error
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=pg)
        s_max = scale.clone()                  # shared conservative scale
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=pg)
        outs.append((q_sum.to(torch.float32) * s_max).to(g.dtype))
    it_out, it_fb = iter(outs), iter(new_fb)
    return (tree_map(lambda _: next(it_out), grads),
            tree_map(lambda _: next(it_fb), grads))


def reduce_scatter_then_gather(x: torch.Tensor, group):
    """ZeRO-style reduction: reduce-scatter ``x`` over ``group`` along dim
    0, return this rank's shard of the sum and a gather closure — lets the
    caller overlap the update with the gather."""
    pg = process_group(group)
    n = dist.get_world_size(pg)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    shard = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(shard, x.contiguous(), group=pg)

    def gather(updated_shard: torch.Tensor) -> torch.Tensor:
        full = updated_shard.new_empty(
            (updated_shard.shape[0] * n,) + tuple(updated_shard.shape[1:]))
        dist.all_gather_into_tensor(full, updated_shard.contiguous(),
                                    group=pg)
        return full
    return shard, gather


class _PsumReplicated(torch.autograd.Function):
    """Sum over a group whose result every rank then uses as the same
    replicated value: the backward is the identity.  (The loss is computed
    on every rank; each rank's term of the sum gets the whole upstream
    gradient.  ``torch.distributed.nn``'s all_reduce sums the gradients
    too, which would count them once a rank.)"""

    @staticmethod
    def forward(ctx, x, pg):
        return all_reduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (the JAX package's ``psum`` inside a
    ``shard_map`` whose output is replicated), with an identity
    backward."""
    return _PsumReplicated.apply(x, process_group(group))


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"``, ``"max"``, ...) over ``group`` into a new
    tensor, as one functional collective and its wait."""
    pg = process_group(group)
    return _funcol.wait_tensor(_funcol.all_reduce(x.contiguous(), op,
                                                  pg.group_name))


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading dim in rank order, as
    one functional collective and its wait."""
    pg = process_group(group)
    n = dist.get_world_size(pg)
    out = _funcol.wait_tensor(_funcol.all_gather_into_tensor(
        x.contiguous(), n, pg.group_name))
    return out.view((n,) + tuple(x.shape))


def _scatter(x, dim, pg):
    n = dist.get_world_size(pg)
    full = x.movedim(dim, 0).contiguous()
    out = _funcol.wait_tensor(_funcol.reduce_scatter_tensor(
        full, "sum", n, pg.group_name))
    return out.movedim(0, dim)


def _gather(x, dim, pg):
    part = x.movedim(dim, 0)
    return all_gather(part, pg).flatten(0, 1).movedim(0, dim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _scatter(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.pg), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _gather(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.pg), None, None


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group``, this rank's block of it along ``dim``
    (which the group's size divides); the backward gathers the blocks'
    gradients (``all_gather_dim``)."""
    return _ReduceScatter.apply(x, dim, process_group(group))


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    backward sums the gradients over ``group`` and hands each rank its
    block (``reduce_scatter_dim``)."""
    return _AllGather.apply(x, dim, process_group(group))
