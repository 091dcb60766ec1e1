"""Merge-plan construction and host execution (paper §4.2, final loop of
Alg. 1).

After clustering, each fully-filled cuboid's member blocks are copied into one
contiguous buffer ("Copy [b_i0..b_ik-1] into memory allocated to B_i").  A
:class:`MergePlan` is the device-agnostic description of those copies; it is
executed on the host (:func:`execute_merge_numpy`) or on the card by the
``pack_rows`` kernel (:func:`repro_torch.kernels.ops.merge_blocks_device`).
:func:`merge_blocks` does both with the paper's timing breakdown, by where
the data lie.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

import numpy as np

from .blocks import Block
from .clustering import cluster_blocks

__all__ = ["CopyOp", "MergePlan", "build_merge_plan", "execute_merge_numpy",
           "MergeStats", "merge_blocks"]


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


@dataclasses.dataclass
class MergeStats:
    """The paper's §4.3 accounting: clustering vs. merging (copy) time."""

    n_original: int = 0
    n_merged: int = 0
    cluster_seconds: float = 0.0
    merge_seconds: float = 0.0
    gather_seconds: float = 0.0     # intra-node gather overhead, if any
    bytes_moved: int = 0


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


def merge_blocks(blocks: Sequence[Block], data: Mapping,
                 max_clusters: int | None = None,
                 gather: Callable[[Mapping], Mapping] | None = None
                 ) -> tuple:
    """Cluster + merge with the paper's timing breakdown.

    ``data`` maps block_id -> the block's tensor or ndarray.  Tensors are
    merged on their device in one ``pack_rows`` launch over the plan's row
    tables (:func:`repro_torch.kernels.ops.merge_blocks_device`; the plain
    version for CPU tensors), ndarrays on the host.  ``gather`` optionally
    simulates the intra-node MPI gather (paper: 0.25 s extra for intra-node
    merging): callable that relocates the block data to the merging process
    and returns it.  Returns (merged_blocks, buffers, stats) where
    merged_blocks[i] is the cuboid for buffers[i].
    """
    import torch
    stats = MergeStats(n_original=len(blocks))
    t0 = time.perf_counter()
    plan = build_merge_plan(blocks, max_clusters=max_clusters)
    stats.cluster_seconds = time.perf_counter() - t0
    stats.n_merged = len(plan.clusters)
    if gather is not None:
        t0 = time.perf_counter()
        data = gather(data)
        stats.gather_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    if any(isinstance(v, torch.Tensor) for v in data.values()):
        from ..kernels.ops import merge_blocks_device
        buffers = merge_blocks_device(plan, data)
        if buffers and buffers[0].device.type == "cuda":
            torch.cuda.synchronize(buffers[0].device)
        stats.bytes_moved = sum(b.numel() * b.element_size()
                                for b in buffers)
    else:
        buffers = execute_merge_numpy(plan, data)
        stats.bytes_moved = sum(b.nbytes for b in buffers)
    stats.merge_seconds = time.perf_counter() - t0
    return plan.merged_blocks, buffers, stats
