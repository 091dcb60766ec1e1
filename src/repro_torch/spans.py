"""Profiler spans at the port's layer boundaries.

``span(name)`` marks a stretch of host code; ``region(name, fn, *args)``
runs ``fn`` under a span that also covers its backward pass, where the
autograd engine runs it (the card's backward thread).  Both are host
events of whatever ``torch.profiler`` trace is recording, on the same
clock as the kernels they launch.  With no profiler recording, a span is
a shared ``nullcontext`` and a region calls ``fn`` as it is: one boolean
check, no dispatcher call, no autograd node.

An operator traces any call by running it inside ``torch.profiler.profile``
(``activities=[CPU, CUDA]``); the spans are named ``repro_torch.<layer>``.

A region's backward span is opened and closed by two identity
``autograd.Function`` markers: one on the region's outputs, whose
backward opens it, and one on its inputs, whose backward closes it.  The
engine runs ready nodes by descending sequence number, so every node the
region created runs between the two, and nodes created after the region
run before the first.  Spans are entered with ``_RecordFunctionFast``,
which, unlike ``record_function``, enters no dispatcher op: under a
selective-checkpoint ``TorchDispatchMode`` the mode's own events would
straddle the span's edges.

``recompute_marked`` runs one checkpointed layer so that its recompute
happens inside ``repro_torch.remat.recompute``, before any region of
the layer's backward opens, and computes exactly what it does unmarked.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["recording", "span", "region", "recompute_marked"]

_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler is recording on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler span named ``name`` while a profiler records, else a
    shared ``nullcontext``."""
    return _RecordFunctionFast(name) if recording() else _NULL


class _Open:
    """The backward span one region's two markers share."""
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None


class _Outputs(torch.autograd.Function):
    """Identity on a region's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, state, *ts):
        ctx.state = state
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        st = ctx.state
        st.rf = _RecordFunctionFast(st.name)
        st.rf.__enter__()
        return (None, *grads)


class _Inputs(torch.autograd.Function):
    """Identity on a region's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, state, *ts):
        ctx.state = state
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        st = ctx.state
        if st.rf is not None:
            st.rf.__exit__(None, None, None)
            st.rf = None
        return (None, *grads)


def _marked(marker, state, items):
    """``items`` with each tensor that requires grad passed through
    ``marker`` (one node for all of them), the rest as they are."""
    items = list(items)
    at = [i for i, t in enumerate(items)
          if isinstance(t, torch.Tensor) and t.requires_grad]
    if at:
        for i, t in zip(at, marker.apply(state, *(items[i] for i in at))):
            items[i] = t
    return items


def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in args)


def region(name: str, fn, *args):
    """``fn(*args)`` under the span ``name``, and its backward under a
    span of the same name.  The markers go on the tensor arguments and
    tensor outputs (``fn`` returns a tensor or a tuple) that require grad,
    only while a profiler records and grad is enabled: otherwise
    ``fn(*args)`` in a forward span at most."""
    if not recording():
        return fn(*args)
    with _RecordFunctionFast(name):
        if not _needs_grad(args):
            return fn(*args)
        state = _Open(name)
        out = fn(*_marked(_Inputs, state, args))
        if isinstance(out, tuple):
            return tuple(_marked(_Outputs, state, out))
        return _marked(_Outputs, state, (out,))[0]


class _Enter(torch.autograd.Function):
    """Identity on a checkpointed layer's first input that saves it: the
    layer's first saved tensor, so a recompute, which stops once it has
    made the last saved tensor again, stops where it would unmarked."""

    @staticmethod
    def forward(ctx, t):
        ctx.save_for_backward(t)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Recompute(torch.autograd.Function):
    """Identity on a checkpointed layer's outputs: its backward is the
    layer's first node to run, and there the unpack of ``_Enter``'s saved
    tensor, the layer's first, runs the recompute inside its span."""

    @staticmethod
    def forward(ctx, enter, *ts):
        ctx.enter = enter
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        with _RecordFunctionFast("repro_torch.remat.recompute"):
            ctx.enter.saved_tensors
        ctx.enter = None
        return (None, *grads)


def recompute_marked(fn, *args):
    """``fn(*args)`` (one checkpointed layer, returning a tuple) between
    the two markers: ``_Enter`` on its first tensor argument that requires
    grad, ``_Recompute`` on its outputs that do.  The caller decides at the
    forward whether to mark, and marks the recompute alike, so both save
    the same tensors."""
    at = next((i for i, t in enumerate(args)
               if isinstance(t, torch.Tensor) and t.requires_grad), None)
    if at is None:
        return fn(*args)
    args = list(args)
    args[at] = _Enter.apply(args[at])
    return tuple(_marked(_Recompute, args[at].grad_fn, fn(*args)))
