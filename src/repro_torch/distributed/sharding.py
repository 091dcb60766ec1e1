"""Logical-axis sharding rules -> DTensor placements / sharding constraints.

Model code names dimensions logically ("batch", "heads", "mlp", "experts",
"kv_seq", ...); a :class:`ShardingRules` maps each logical name to mesh
axes.  Divisibility is checked at spec-build time: a logical axis whose dim
does not divide by the mesh-axis extent is silently replicated (recorded in
``dropped``), so the same model code runs on any mesh.

The rules and :meth:`ShardingCtx.spec` are the JAX package's.  The mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with named dims, or, where
no process group exists (planning a production mesh, tests), a mapping of
axis name to size in mesh order.  A spec becomes DTensor placements
(:meth:`ShardingCtx.placements`), a
:class:`~repro_torch.checkpoint.blocks_map.MeshSharding`
(:func:`named_sharding`, the counterpart of ``NamedSharding``), or a
redistribution of a DTensor activation (:func:`shard`, the counterpart of
``with_sharding_constraint``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Sequence

import numpy as np

__all__ = ["PartitionSpec", "ShardingRules", "ShardingCtx", "use_sharding",
           "active", "current_ctx", "logical_spec", "shard", "named_sharding",
           "mesh_axis_sizes", "is_dtensor", "replicate_plain",
           "DEFAULT_RULES", "FSDP_RULES"]

#: default logical-axis -> mesh-axes rules (single- and multi-pod; missing
#: mesh axes are dropped automatically, so "pod" entries are safe on 2-D
#: meshes)
DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                   # sequence replicated by default
    "kv_seq": ("model",),        # long-context KV sharding (batch==1 decode)
    "act_embed": (),
    "act_mlp": ("model",),
    "act_heads": ("model",),
    "act_experts": ("model",),
    # params
    "vocab": ("model",),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "conv": (),
    "ssm_heads": ("model",),
    "state": (),
    "layers": (),                # layer-stacked dim: never sharded
    "zero_data": ("data",),      # ZeRO-1 optimizer-moment sharding
}

#: ZeRO-3/FSDP: additionally shard the "embed" param dim over the data axis
FSDP_RULES = dict(DEFAULT_RULES, embed=("data",))


class PartitionSpec(tuple):
    """A spec entry per array dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (major first); trailing ``None`` trimmed.
    Equal, as a tuple, to the JAX package's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (without
    importing DTensor where nothing made one)."""
    cls = type(x)
    return cls.__name__ == "DTensor" and \
        cls.__module__.startswith("torch.distributed")


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` with named
    dims or of such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if hasattr(mesh, "keys"):
        return {str(k): int(v) for k, v in mesh.items()}
    raise TypeError(f"not a mesh: {mesh!r} (a DeviceMesh with named dims, "
                    f"or a mapping of axis name to size)")


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass
class ShardingRules:
    mapping: dict

    def axes_for(self, name: str | None) -> tuple:
        if name is None:
            return ()
        if name not in self.mapping:
            raise KeyError(f"unknown logical axis {name!r}")
        return tuple(self.mapping[name])


@dataclasses.dataclass
class ShardingCtx:
    mesh: object
    rules: ShardingRules
    dropped: list = dataclasses.field(default_factory=list)
    #: axes handled manually (each rank holds its own slice as a plain
    #: tensor) — suppressed in constraints
    manual: frozenset = frozenset()

    @property
    def axis_sizes(self) -> dict:
        return mesh_axis_sizes(self.mesh)

    def spec(self, logical_axes: Sequence,
             shape: Sequence[int] | None) -> PartitionSpec:
        """PartitionSpec for ``logical_axes`` (one entry per dim; None =
        replicated).  ``shape`` enables divisibility checking."""
        sizes = self.axis_sizes
        entries = []
        used = set()
        for d, name in enumerate(logical_axes):
            axes = self.rules.axes_for(name)
            # drop axes missing from the mesh (e.g. "pod" on single-pod)
            # and axes that are manual in the current region
            axes = tuple(a for a in axes
                         if a in sizes and a not in self.manual)
            # an axis may appear only once in a spec
            axes = tuple(a for a in axes if a not in used)
            if shape is not None and axes:
                total = 1
                for a in axes:
                    total *= sizes[a]
                if shape[d] % total != 0:
                    self.dropped.append((tuple(logical_axes), d, name,
                                         tuple(shape)))
                    axes = ()
            used.update(axes)
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(tuple(axes))
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def placements(self, logical_axes: Sequence, shape=None,
                   mesh=None) -> tuple:
        """DTensor placements, one per dim of ``mesh`` (the context's
        unless given: a sub-mesh of it, whose other axes are manual):
        ``Shard(d)`` on each mesh dim the spec splits array dim ``d`` over,
        ``Replicate()`` on the others.  Where one array dim takes several
        mesh axes, DTensor splits it over them in mesh-dim order, the first
        mesh dim major; the spec names them major first, so its order must
        be the mesh's for every device's block to equal
        ``devices_indices_map``'s (``ValueError`` otherwise)."""
        from torch.distributed.tensor import Replicate, Shard
        mesh = self.mesh if mesh is None else mesh
        order = list(mesh_axis_sizes(mesh))
        out = [Replicate() for _ in order]
        for d, entry in enumerate(self.spec(logical_axes, shape)):
            axes = [a for a in _entry_axes(entry) if a in order]
            at = [order.index(a) for a in axes]
            if at != sorted(at):
                raise ValueError(
                    f"spec entry {entry!r} of dim {d} names its mesh axes "
                    f"out of the mesh's order {tuple(order)}: DTensor "
                    f"splits a dim over its mesh dims major-first in mesh "
                    f"order")
            for i in at:
                out[i] = Shard(d)
        return tuple(out)

    def device_ids(self) -> np.ndarray:
        """The mesh's device ids (ranks), one a mesh cell."""
        ids = getattr(self.mesh, "mesh", None)
        if ids is not None:
            return np.asarray(ids.cpu().numpy(), dtype=np.int64)
        shape = tuple(self.axis_sizes.values())
        return np.arange(math.prod(shape), dtype=np.int64).reshape(shape)

    def named(self, logical_axes: Sequence, shape=None):
        from ..checkpoint.blocks_map import MeshSharding
        return MeshSharding(self.device_ids(), tuple(self.axis_sizes),
                            self.spec(logical_axes, shape))


_tls = threading.local()


def current_ctx() -> ShardingCtx | None:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: dict | ShardingRules = None,
                 manual: frozenset = frozenset()):
    if rules is None:
        rules = DEFAULT_RULES
    if isinstance(rules, dict):
        rules = ShardingRules(dict(rules))
    prev = current_ctx()
    _tls.ctx = ShardingCtx(mesh=mesh, rules=rules, manual=frozenset(manual))
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def active(ctx: ShardingCtx | None):
    """``ctx`` (a context ``use_sharding`` made, or None) as the active
    one for the block.  The context is thread-local, and a remat
    recompute runs on the backward's thread (on a card, the autograd
    device thread): the recompute re-enters the forward's context so
    that it takes the forward's placements and collectives."""
    prev = current_ctx()
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def logical_spec(logical_axes: Sequence, shape=None) -> PartitionSpec:
    ctx = current_ctx()
    if ctx is None:
        return PartitionSpec()
    return ctx.spec(logical_axes, shape)


def named_sharding(logical_axes: Sequence, shape=None):
    """The :class:`~repro_torch.checkpoint.blocks_map.MeshSharding` of
    ``logical_axes`` under the active context, or None without one."""
    ctx = current_ctx()
    if ctx is None:
        return None
    return ctx.named(logical_axes, shape)


def shard(x, *logical_axes):
    """Sharding constraint: a DTensor ``x`` redistributed to the placements
    the rules give ``logical_axes`` on its own mesh (manual axes left out).
    A no-op without a context (single-device runs) and on a plain tensor
    (one rank's slice inside a manual region)."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    want = ctx.placements(logical_axes, x.shape, mesh=x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def replicate_plain():
    """A context in which plain tensors meet DTensors as replicated ones
    (positions, masks, constants), as ``implicit_replication`` makes them,
    but nestable: on exit the setting is what it was before (the
    library's context resets it to off, which would end an outer one's).
    The model's forward and backward run under it when their params are
    DTensors."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev
