"""Parameter-definition skeletons.

Models build a tree (nested dicts and lists) of :class:`ParamDef` (shape +
dtype + logical axes + init law).  From the skeleton we derive, without
materializing weights, the parameter count and the cache bytes, and
``materialize(skel, generator)`` makes the weights.  The mesh-facing
``abstract``/``shardings`` of the reference come with the distributed
slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ParamDef", "stack", "count_params", "materialize",
           "tree_leaves", "tree_map", "grad_leaf", "torch_dtype"]


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


def stack(d: ParamDef, n: int) -> ParamDef:
    """Layer-stacked version for a segment of ``n`` layers."""
    return ParamDef(shape=(n,) + tuple(d.shape), axes=("layers",) + d.axes,
                    dtype=d.dtype, init=d.init, scale=d.scale)


def count_params(skel) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(skel))


def materialize(skel, generator: torch.Generator):
    """Initialize every ``ParamDef`` on ``generator``'s device.  The draws
    are the reference's laws (N(0, scale), N(0, 1/fan_in), zeros, ones),
    not its numbers: ``jax.random`` is not reproduced."""
    dev = generator.device

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

    return tree_map(mk, skel)
