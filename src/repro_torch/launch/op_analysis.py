"""Per-rank cost analysis of one step: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The JAX package parses the optimized HLO of one device.  The port has no
HLO: it counts the ops one rank dispatches while the step runs, eagerly on
real tensors or under ``FakeTensorMode`` (the dry run), through a
``TorchDispatchMode`` (``OpCounter``):

  * flops from the matrix products only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``; einsum and ``@`` lower to them), 2 x out x contracted, as
    ``_dot_flops`` counts dots, plus the flash custom ops' useful flops
    (``kernels/flash_attention.flash_flops``);
  * bytes as each op's operands plus its outputs: an eager op's boundary
    is its device-memory traffic, as a fusion's is in the reference.
    Views, ``detach``, allocations and metadata ops cost nothing (the
    counterpart of ``_SKIP_OPS``);
  * collective bytes per kind (all-reduce counted 2x for ring cost), from
    the functional (``_c10d_functional``) and the classic (``c10d``)
    collectives alike: an op's input bytes.

On DTensors the counter sees each rank's local ops, not the logical op:
it hands an op on DTensors back to DTensor (``NotImplemented``), whose
dispatch then runs the local aten ops and collectives through it again.
The ops DTensor's sharding propagation runs on fake tensors of the
logical shapes, to learn an output's shape, are not counted.

``HloCost.while_trips`` has no counterpart: eager code runs each
iteration of a loop as ops of its own, so no trip count needs correcting.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["analyze_ops", "OpCost", "OpCounter"]

_aten = torch.ops.aten

#: functional / classic collective op name -> the reference's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
}
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")

#: ops that move no bytes: allocations, metadata, the collectives' waits
_FREE = {"detach", "alias", "empty", "empty_strided", "empty_like",
         "new_empty", "new_empty_strided", "lift_fresh", "device",
         "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size",
         "_wrap_tensor_autograd", "set_"}


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _mm_flops(func, args, out) -> float:
    if func in (_aten.mm.default, _aten.bmm.default):
        a = args[0]
    elif func in (_aten.addmm.default, _aten.baddbmm.default):
        a = args[1]
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1]


def _flash_flops(func, args) -> float:
    from ..kernels.flash_attention import flash_flops
    kind = {"flash_fwd": "fwd", "flash_dq": "dq",
            "flash_dkv": "dkv"}[func._opname]
    q, k = args[0], args[1]
    causal, window = (args[4], args[5]) if kind == "fwd" else \
        (args[7], args[8])
    return float(flash_flops(kind, tuple(q.shape), tuple(k.shape), causal,
                             window))


class OpCounter(TorchDispatchMode):
    """Counts one rank's dispatched ops into ``cost`` (an ``OpCost``)
    while it is entered; ``by_group`` keeps the collective bytes by
    process group name, ``on_op(func, nbytes)`` (if given) sees every
    counted op.
    ``live`` and ``peak`` follow the bytes of the storages this rank's
    ops made (and those ``track`` was given) while they stay alive: a
    storage counts from the op that made it until it is freed.  A
    collective's ``wait_tensor`` returns its input on a device; under
    ``FakeTensorMode`` it makes a storage of its own, which counts as the
    input's bytes (until both are freed), not as new ones."""

    def __init__(self, on_op=None):
        super().__init__()
        self.cost = OpCost(collectives={k: {"count": 0, "bytes": 0.0}
                                        for k in _KINDS})
        self.on_op = on_op
        self.by_group: dict = {}
        self.propagating = 0
        self.live = 0             # bytes of the storages alive now
        self.peak = 0             # their most at any op's end
        self._storages = WeakIdKeyDictionary()
        self._refs = []

    def track(self, *tensors) -> None:
        """Count ``tensors``' storages (this rank's blocks of DTensors) as
        live from now on: the step's arguments."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._hold(t.to_local() if _is_dtensor_type(type(t))
                           else t)

    def _hold(self, t, block=None) -> None:
        """Count ``t``'s storage from now until it is freed, as new bytes,
        or as ``block``'s (``[bytes, storages]``: the bytes count while any
        of its storages lives)."""
        st = t.untyped_storage()
        if st in self._storages:
            return
        if block is None:
            block = [st.nbytes(), 0]
            self.live += block[0]
            self.peak = max(self.peak, self.live)
        block[1] += 1
        self._storages[st] = block
        self._refs.append(weakref.ref(st, functools.partial(self._free,
                                                            block)))

    def _free(self, block, _ref) -> None:
        block[1] -= 1
        if not block[1]:
            self.live -= block[0]

    def __enter__(self):
        # DTensor learns an op's output shape by running it on fake
        # tensors of the logical shapes: those ops are not this rank's
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        inner = prop._propagate_tensor_meta_non_cached

        def quiet(*a, **kw):
            self.propagating += 1
            try:
                return inner(*a, **kw)
            finally:
                self.propagating -= 1
        prop._propagate_tensor_meta_non_cached = quiet
        self._prop = prop
        return super().__enter__()

    def __exit__(self, *exc):
        del self._prop._propagate_tensor_meta_non_cached
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented               # DTensor runs local ops
        out = func(*args, **kwargs)
        if self.propagating:
            return out        # DTensor's sharding propagation, not work
        flat = [t for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        name = func._opname
        alias = self._storages.get(args[0].untyped_storage()) \
            if name == "wait_tensor" else None
        for t in outs:
            self._hold(t, alias)
        if name in _FREE or getattr(func, "is_view", False):
            return out
        nbytes = sum(_bytes(t) for t in flat) + sum(_bytes(t) for t in outs)
        flops = 0.0
        if func.namespace == "aten" and outs:
            flops = _mm_flops(func, args, outs[0])
        elif func.namespace == "repro_torch" and name.startswith("flash_"):
            flops = _flash_flops(func, args)
        kind = _COLLECTIVES.get(name) if func.namespace in (
            "_c10d_functional", "c10d") else None
        c = self.cost
        if kind is not None:
            src = args[0]
            if isinstance(src, (list, tuple)):        # the classic calls
                src = src[0]
            cb = _bytes(src) * (2 if kind == "all-reduce" else 1)
            c.collectives[kind]["count"] += 1
            c.collectives[kind]["bytes"] += cb
            c.collective_bytes += cb
            group = _group_name(func, args)
            self.by_group[group] = self.by_group.get(group, 0.0) + cb
        c.flops += flops
        c.bytes += nbytes
        if self.on_op is not None:
            self.on_op(func, nbytes)
        return out


def _group_name(func, args) -> str:
    """The process group a collective runs over: the functional ops name
    it (their last string argument), the classic ones pass it."""
    if func.namespace == "_c10d_functional":
        return next(a for a in reversed(args) if isinstance(a, str))
    for a in args:
        name = getattr(a, "group_name", None)
        if isinstance(name, str):
            return name
    return "?"


def _is_dtensor_type(t) -> bool:
    return t.__name__ == "DTensor" and t.__module__.startswith(
        "torch.distributed")


def analyze_ops(fn, *args, **kwargs) -> OpCost:
    """The cost of one call ``fn(*args, **kwargs)`` on this rank: its
    flops, device-memory bytes and collectives (see the module's
    docstring).  The call runs (on fake tensors: traces); its result is
    dropped."""
    counter = OpCounter()
    with counter:
        fn(*args, **kwargs)
    cost = counter.cost
    cost.collectives = {k: v for k, v in cost.collectives.items()
                        if v["count"]}
    return cost
