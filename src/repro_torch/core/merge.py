"""Merge-plan construction and host execution (paper §4.2, final loop of
Alg. 1).

After clustering, each fully-filled cuboid's member blocks are copied into one
contiguous buffer ("Copy [b_i0..b_ik-1] into memory allocated to B_i").  A
:class:`MergePlan` is the device-agnostic description of those copies; it is
executed on the host (:func:`execute_merge_numpy`) or on the card by the
``pack_rows`` kernel (:func:`repro_torch.kernels.ops.merge_blocks_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .blocks import Block
from .clustering import cluster_blocks

__all__ = ["CopyOp", "MergePlan", "build_merge_plan", "execute_merge_numpy"]


@dataclasses.dataclass(frozen=True)
class CopyOp:
    """Copy source block ``block_id`` into ``dst_slices`` of merged buffer."""

    block_id: int
    src_block: Block
    dst_index: int              # which merged buffer
    dst_slices: tuple           # slices into the merged buffer


@dataclasses.dataclass(frozen=True)
class MergePlan:
    clusters: tuple             # tuple[Cluster]
    copies: tuple               # tuple[CopyOp]

    @property
    def merged_blocks(self) -> list:
        return [c.cuboid for c in self.clusters]

    def buffers_nbytes(self, itemsize: int) -> int:
        return sum(c.volume * itemsize for c in self.clusters)


def plan_from_clusters(clusters: Sequence) -> MergePlan:
    """The :class:`MergePlan` that copies every cluster's members into it,
    in cluster order — for callers whose clusters are already decided (a
    layout's chunks, a whole-domain linearization)."""
    copies = []
    for ci, cl in enumerate(clusters):
        origin = cl.cuboid.lo
        for b in cl.members:
            copies.append(CopyOp(block_id=b.block_id, src_block=b,
                                 dst_index=ci,
                                 dst_slices=b.slices(origin=origin)))
    return MergePlan(clusters=tuple(clusters), copies=tuple(copies))


def build_merge_plan(blocks: Sequence[Block],
                     max_clusters: int | None = None) -> MergePlan:
    return plan_from_clusters(cluster_blocks(blocks,
                                             max_clusters=max_clusters))


def execute_merge_numpy(plan: MergePlan,
                        data: Mapping[int, np.ndarray],
                        dtype=None) -> list:
    """Run the plan on host arrays. ``data`` maps block_id -> ndarray whose
    shape equals the source block's shape.  Returns merged buffers in cluster
    order."""
    if dtype is None:
        dtype = next(iter(data.values())).dtype
    buffers = [np.empty(c.cuboid.shape, dtype=dtype) for c in plan.clusters]
    for op in plan.copies:
        src = data[op.block_id]
        if src.shape != op.src_block.shape:
            raise ValueError(
                f"block {op.block_id}: data shape {src.shape} != "
                f"block shape {op.src_block.shape}")
        buffers[op.dst_index][op.dst_slices] = src
    return buffers
