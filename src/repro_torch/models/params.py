"""Parameter-definition skeletons.

Models build a tree (nested dicts and lists) of :class:`ParamDef` (shape +
dtype + logical axes + init law).  From the skeleton we derive, without
materializing weights, the parameter count and the cache bytes, and
``materialize(skel, generator)`` makes the weights.  Under an active
sharding context ``abstract(skel)`` gives each leaf's shape, dtype and
sharding, ``shardings(skel)`` the shardings alone (``MeshSharding``s, the
counterpart of the reference's ``NamedSharding``s), and
``materialize(..., place=True)`` places each leaf as a DTensor.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ParamDef", "Abstract", "abstract", "shardings", "stack",
           "count_params", "materialize", "tree_leaves", "tree_map",
           "grad_leaf", "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                   # logical axis name (or None) per dim
    dtype: str = "float32"
    init: str = "normal"          # normal | zeros | ones | fan_in
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / ... as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts, lists and tuples, dict keys in sorted
    order (the order ``jax.tree_util`` uses); ``None`` is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``tree`` with ``fn`` applied to every leaf (``None`` stays); with
    ``rest``, ``fn`` takes the leaves at the same path of every tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def grad_leaf(p: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """An autograd leaf sharing ``p``'s storage whose gradient accumulates
    in place into ``grad`` (zeroed, ``p``'s shape and dtype): the leaf's
    ``.grad`` is ``grad`` itself, so a backward pass adds into it."""
    t = p.detach().requires_grad_()
    t.grad = grad
    return t


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A leaf without its values (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype
    sharding: object = None


def abstract(skel, sharded: bool = True):
    """``Abstract`` leaves of ``skel``; with ``sharded``, each carries the
    ``MeshSharding`` the active context gives it (None without one)."""
    from ..distributed import sharding as shd

    def one(d: ParamDef) -> Abstract:
        sh = shd.named_sharding(d.axes, d.shape) if sharded else None
        return Abstract(tuple(d.shape), torch_dtype(d.dtype), sh)
    return tree_map(one, skel)


def shardings(skel):
    """Each leaf's ``MeshSharding`` under the active context."""
    from ..distributed import sharding as shd
    return tree_map(lambda d: shd.named_sharding(d.axes, d.shape), skel)


def stack(d: ParamDef, n: int) -> ParamDef:
    """Layer-stacked version for a segment of ``n`` layers."""
    return ParamDef(shape=(n,) + tuple(d.shape), axes=("layers",) + d.axes,
                    dtype=d.dtype, init=d.init, scale=d.scale)


def count_params(skel) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(skel))


def materialize(skel, generator: torch.Generator, place: bool = False):
    """Initialize every ``ParamDef`` on ``generator``'s device.  The draws
    are the reference's laws (N(0, scale), N(0, 1/fan_in), zeros, ones),
    not its numbers: ``jax.random`` is not reproduced.

    With ``place`` (under an active sharding context) each leaf, drawn
    whole as without a mesh, becomes a DTensor over the context's mesh
    with the placements its logical axes give it; every rank draws the
    same numbers from the same seed and keeps its own block, with no
    communication, so a sharded init equals the unsharded one leaf for
    leaf."""
    dev = generator.device
    ctx = None
    if place:
        from ..distributed.sharding import current_ctx
        ctx = current_ctx()
        if ctx is None:
            raise ValueError("place=True needs an active sharding context")

    def mk(d: ParamDef) -> torch.Tensor:
        dtype = torch_dtype(d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        if d.init == "fan_in":
            fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            s = 1.0 / math.sqrt(max(fan, 1))
        elif d.init == "normal":
            s = d.scale
        else:
            raise ValueError(f"unknown init {d.init!r}")
        x = torch.randn(d.shape, generator=generator, device=dev)
        # in place: a stacked expert weight is a quarter of a card
        return x.mul_(s).to(dtype)

    if ctx is None:
        return tree_map(mk, skel)
    from torch.distributed.tensor import distribute_tensor

    def placed(d: ParamDef):
        return distribute_tensor(mk(d), ctx.mesh,
                                 ctx.placements(d.axes, d.shape),
                                 src_data_rank=None)
    return tree_map(placed, skel)
