"""Derive the paper's Block sets from shardings, and name a tree's leaves.

A sharding over a mesh assigns each device a cuboid shard of every array;
grouping devices into hosts gives the per-host block sets that map exactly
onto the paper's per-process block model (irregular under DP+TP+EP: a host
owns a ragged collection of cuboids per array — the AMR motif).

:class:`MeshSharding` is the port's counterpart of JAX's
``NamedSharding(Mesh, PartitionSpec)``: the same ``devices_indices_map``,
so :func:`blocks_from_sharding` keeps the JAX package's contract and gives
the same blocks for the same mesh and spec; :func:`dtensor_sharding` gives
a DTensor's (its mesh's ranks as device ids, its ``Shard`` placements as
the spec), so a sharded model's leaves keep that contract too.  The names of
:func:`flatten_pytree` follow ``jax.tree_util.tree_flatten_with_path``:
dict keys in sorted order, list and tuple items by index, ``None`` an empty
subtree, joined with ``/``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.blocks import Block

__all__ = ["MeshDevice", "MeshSharding", "blocks_from_sharding",
           "placement_sharding", "dtensor_sharding", "rank_block",
           "flatten_pytree",
           "unflatten_like"]


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """A device of a :class:`MeshSharding`'s mesh, known by its id."""

    id: int


class MeshSharding:
    """A named-axis sharding: ``device_ids`` is the mesh (an int array, one
    device id a cell) whose axes are ``axis_names``; ``spec`` gives for each
    array dimension ``None`` (replicated), one mesh axis name, or a tuple
    of names (major first) over whose product the dimension is split."""

    def __init__(self, device_ids, axis_names: Sequence[str], spec=()):
        self.device_ids = np.asarray(device_ids, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.device_ids.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.device_ids.shape} has "
                             f"{len(self.axis_names)} axis names")
        self.spec = tuple(spec)
        used = [a for e in self.spec for a in self._axes(e)]
        unknown = [a for a in used if a not in self.axis_names]
        if unknown:
            raise ValueError(f"spec {self.spec} names {unknown}, not axes "
                             f"of the mesh {self.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} maps a mesh axis to more "
                             f"than one dimension")

    @staticmethod
    def _axes(entry) -> tuple:
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)

    def __repr__(self) -> str:
        return (f"MeshSharding(mesh={dict(zip(self.axis_names, self.device_ids.shape))}, "
                f"spec={self.spec})")

    def devices_indices_map(self, shape: Sequence[int]) -> dict:
        """``{MeshDevice: tuple of slices}``, one shard per device; an
        unsplit dimension is ``slice(None)``.  A dimension its mesh axes do
        not divide raises ``ValueError``."""
        shape = tuple(int(s) for s in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"{len(shape)} dimensions of {shape}")
        mesh = dict(zip(self.axis_names, self.device_ids.shape))
        splits = []
        for d, entry in enumerate(self.spec):
            axes = self._axes(entry)
            n = int(np.prod([mesh[a] for a in axes], dtype=np.int64))
            if shape[d] % n:
                raise ValueError(f"{self} splits array axis {d} {n} ways, "
                                 f"but its size is {shape[d]} (full shape "
                                 f"{shape}): the tiling should evenly "
                                 f"divide the shape")
            splits.append((d, axes, shape[d] // n))
        out = {}
        for coord in np.ndindex(*self.device_ids.shape):
            at = dict(zip(self.axis_names, coord))
            idx = [slice(None)] * len(shape)
            for d, axes, size in splits:
                if not axes:
                    continue
                k = 0
                for a in axes:                      # major first
                    k = k * mesh[a] + at[a]
                idx[d] = slice(k * size, (k + 1) * size)
            out[MeshDevice(int(self.device_ids[coord]))] = tuple(idx)
        return out


def placement_sharding(device_ids, axis_names: Sequence[str], placements,
                       ndim: int) -> MeshSharding:
    """The :class:`MeshSharding` of DTensor ``placements`` (one per mesh
    axis) over the mesh ``device_ids`` with axes ``axis_names``: for each
    array dim the mesh axes whose placement is ``Shard`` of it, in mesh
    order (DTensor splits a dim over several mesh dims major-first in that
    order).  A ``Partial`` placement has no blocks: ``ValueError``."""
    spec = [[] for _ in range(ndim)]
    for name, pl in zip(axis_names, placements):
        if pl.is_partial():
            raise ValueError(f"a partial sum over mesh dim {name!r} has no "
                             f"blocks to save: reduce it first")
        if pl.is_shard():
            spec[pl.dim].append(name)
    entries = [None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in spec]
    while entries and entries[-1] is None:
        entries.pop()
    return MeshSharding(device_ids, axis_names, entries)


def dtensor_sharding(t) -> MeshSharding:
    """The :class:`MeshSharding` of a DTensor: its mesh's ranks as the
    device ids, its placements as the spec (``placement_sharding``)."""
    mesh = t.device_mesh
    if mesh.mesh_dim_names is None:
        raise ValueError("a DTensor's mesh needs named dims to checkpoint")
    return placement_sharding(mesh.mesh.cpu().numpy(), mesh.mesh_dim_names,
                              t.placements, t.dim())


def rank_block(shape: Sequence[int], sharding, rank: int) -> Block:
    """The block of an array of ``shape`` that device ``rank`` holds under
    ``sharding`` (owner ``rank``, block id 0)."""
    shape = tuple(int(s) for s in shape)
    idx = sharding.devices_indices_map(shape)[MeshDevice(int(rank))]
    lo = [s.start if s.start is not None else 0 for s in idx]
    hi = [s.stop if s.stop is not None else shape[d]
          for d, s in enumerate(idx)]
    return Block(tuple(lo), tuple(hi), owner=int(rank), block_id=0)


def blocks_from_sharding(shape: Sequence[int], sharding,
                         devices_per_host: int = 4) -> list:
    """Unique shards of an array as Blocks owned by (simulated) hosts.

    Replicated copies dedupe to the lowest-id owning host (each shard is
    checkpointed once); blocks are numbered in sorted ``(lo, hi)`` order.
    0-d arrays are handled by the caller.
    """
    shape = tuple(shape)
    idx_map = sharding.devices_indices_map(shape)
    seen: dict = {}
    for dev, idx in idx_map.items():
        lo, hi = [], []
        for d, s in enumerate(idx):
            lo.append(s.start if s.start is not None else 0)
            hi.append(s.stop if s.stop is not None else shape[d])
        key = (tuple(lo), tuple(hi))
        host = getattr(dev, "id", 0) // devices_per_host
        if key not in seen or host < seen[key]:
            seen[key] = host
    return [Block(lo, hi, owner=int(host), block_id=bid)
            for bid, ((lo, hi), host) in enumerate(sorted(seen.items()))]


def _paths(tree, path: tuple = ()):
    """``(path, leaf)`` pairs in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, path + (i,))
    else:
        yield path, tree


def _name(prefix: str, path: tuple) -> str:
    return prefix + "/".join(str(k) for k in path)


def flatten_pytree(tree, prefix: str = "") -> dict:
    """Stable name->leaf map using tree paths ('segments/0/attn/wq')."""
    return {_name(prefix, p): leaf for p, leaf in _paths(tree)}


def unflatten_like(template, flat: dict, prefix: str = "", _path=()):
    """Rebuild a tree shaped like ``template`` from a flat name map."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, prefix, _path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_like(t, flat, prefix, _path + (i,))
                              for i, t in enumerate(template))
    return flat[_name(prefix, _path)]
