"""Layout strategies and layout planning (paper §2, §4, §5).

A :class:`LayoutPlan` describes *what chunks exist on storage and where each
chunk's data comes from* — pure index-space planning, no I/O.  Execution
(extent planning, buffer assembly, engine dispatch) lives in
:mod:`repro_torch.io.planner` / :mod:`repro_torch.io.engine` behind the
:class:`repro_torch.io.reader.Dataset` session.

Strategies (paper names):
  contiguous      §2.1 logically contiguous — one global row-major chunk
  chunked         §2.2 one chunk per block in a single shared file
  subfiled_fpp    §2.3 one chunk per block, one file per process
  subfiled_fpn    §2.3 one chunk per block, one file per node (aggregated)
  merged_process  §4   intra-process clustering+merging, then FPP
  merged_node     §4   intra-node gather + clustering+merging, then FPN
  reorganized     §5   full reorganization into a regular K-way decomposition
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .blocks import Block, bounding_box, regular_decomposition
from .clustering import cluster_blocks_many

__all__ = ["STRATEGIES", "ChunkPlan", "LayoutPlan", "plan_layout",
           "node_of", "DEFAULT_REORG_SCHEME", "default_reorg_scheme"]

STRATEGIES = ("contiguous", "chunked", "subfiled_fpp", "subfiled_fpn",
              "merged_process", "merged_node", "reorganized")

DEFAULT_REORG_SCHEME = (4, 4, 4)  # paper §5.2: 64 chunks, 4x4x4

#: chunk-count target the dimension-aware default scheme aims for
DEFAULT_REORG_CHUNKS = 64


def default_reorg_scheme(ndim: int, target_chunks: int = DEFAULT_REORG_CHUNKS,
                         global_shape: Sequence[int] | None = None) -> tuple:
    """Dimension-aware default reorganization scheme: spread ~``target_chunks``
    over ``ndim`` axes as evenly as possible (3-D: the paper's 4x4x4; 2-D:
    8x8; 1-D: 64; 4-D: 4x4x2x2).  With ``global_shape`` each axis split is
    clamped to the axis extent so no zero-size chunk can arise.

    The historical constant :data:`DEFAULT_REORG_SCHEME` is this function at
    ``ndim == 3`` — callers with non-3-D variables got a silent rank mismatch
    before this existed.
    """
    if ndim <= 0:
        raise ValueError(f"ndim must be positive, got {ndim}")
    k = max(0, int(round(math.log2(max(1, target_chunks)))))
    base, rem = divmod(k, ndim)
    scheme = tuple(2 ** (base + (1 if d < rem else 0)) for d in range(ndim))
    if global_shape is not None:
        scheme = tuple(min(int(s), max(1, int(g)))
                       for s, g in zip(scheme, global_shape))
    return scheme


def node_of(rank: int, procs_per_node: int) -> int:
    return rank // procs_per_node


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One stored chunk: the cuboid it covers, the original blocks whose data
    feeds it, which logical writer produces it and into which subfile."""

    chunk: Block
    sources: tuple           # tuple[Block] (pieces come from intersections)
    writer: int              # logical writer rank (process, node, or stager)
    subfile: int             # subfile index (0 == the single shared file)


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    strategy: str
    global_shape: tuple
    chunks: tuple            # tuple[ChunkPlan]
    num_subfiles: int
    #: elements that must move ACROSS processes to build this layout
    inter_process_moved: int
    #: elements that move within a node (gather/merge memcpy)
    intra_node_moved: int

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def chunks_per_writer(self) -> dict:
        out: dict = {}
        for c in self.chunks:
            out.setdefault(c.writer, []).append(c)
        return out


def _merged_chunks(blocks_by_group: dict, subfile_of_group,
                   max_clusters: int | None) -> list:
    keys = sorted(blocks_by_group)
    clustered = cluster_blocks_many([blocks_by_group[g] for g in keys],
                                    max_clusters=max_clusters)
    chunks = []
    for g, clusters in zip(keys, clustered):
        for cl in clusters:
            chunks.append(ChunkPlan(chunk=cl.cuboid, sources=cl.members,
                                    writer=g, subfile=subfile_of_group(g)))
    return chunks


def plan_layout(strategy: str,
                blocks: Sequence[Block],
                num_procs: int,
                procs_per_node: int = 1,
                global_shape: Sequence[int] | None = None,
                reorg_scheme: Sequence[int] | None = None,
                num_stagers: int = 1,
                max_clusters: int | None = None) -> LayoutPlan:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    blocks = list(blocks)
    if global_shape is None:
        global_shape = bounding_box(blocks).hi
    global_shape = tuple(global_shape)

    inter_moved = 0
    intra_moved = 0

    if strategy == "contiguous":
        root = Block((0,) * len(global_shape), global_shape)
        # every element not already on the root writer crosses processes
        inter_moved = sum(b.volume for b in blocks if b.owner != 0)
        chunks = (ChunkPlan(chunk=root, sources=tuple(blocks), writer=0,
                            subfile=0),)
        nsub = 1

    elif strategy == "chunked":
        chunks = tuple(ChunkPlan(chunk=b, sources=(b,), writer=b.owner,
                                 subfile=0) for b in blocks)
        nsub = 1

    elif strategy == "subfiled_fpp":
        chunks = tuple(ChunkPlan(chunk=b, sources=(b,), writer=b.owner,
                                 subfile=b.owner) for b in blocks)
        nsub = num_procs

    elif strategy == "subfiled_fpn":
        nnodes = (num_procs + procs_per_node - 1) // procs_per_node
        chunks = tuple(ChunkPlan(chunk=b, sources=(b,),
                                 writer=node_of(b.owner, procs_per_node),
                                 subfile=node_of(b.owner, procs_per_node))
                       for b in blocks)
        intra_moved = sum(b.volume for b in blocks
                          if b.owner % procs_per_node != 0)
        nsub = nnodes

    elif strategy == "merged_process":
        by_proc: dict = {}
        for b in blocks:
            by_proc.setdefault(b.owner, []).append(b)
        chunks = tuple(_merged_chunks(by_proc, lambda g: g, max_clusters))
        intra_moved = sum(b.volume for b in blocks)   # merge memcpy
        nsub = num_procs

    elif strategy == "merged_node":
        by_node: dict = {}
        for b in blocks:
            by_node.setdefault(node_of(b.owner, procs_per_node), []).append(b)
        chunks = tuple(_merged_chunks(by_node, lambda g: g, max_clusters))
        intra_moved = 2 * sum(b.volume for b in blocks)  # gather + merge
        nsub = len(by_node)

    elif strategy == "reorganized":
        if reorg_scheme is None:
            scheme = default_reorg_scheme(len(global_shape),
                                          global_shape=global_shape)
        else:
            scheme = tuple(reorg_scheme)
        if len(scheme) != len(global_shape):
            raise ValueError(
                f"reorg_scheme rank {len(scheme)} != variable rank "
                f"{len(global_shape)} (scheme={scheme}, "
                f"global_shape={global_shape}); pass a scheme per axis or "
                f"None for the dimension-aware default")
        # clamp: an axis can never be split finer than its extent
        scheme = tuple(min(int(s), max(1, int(g)))
                       for s, g in zip(scheme, global_shape))
        targets = regular_decomposition(global_shape, scheme)
        chunks = []
        for t in targets:
            srcs = tuple(b for b in blocks if t.overlaps(b))
            chunks.append(ChunkPlan(chunk=Block(t.lo, t.hi),
                                    sources=srcs,
                                    writer=t.block_id % max(1, num_stagers),
                                    subfile=t.block_id % max(1, num_stagers)))
        chunks = tuple(chunks)
        # everything crosses from sim processes to staging nodes
        inter_moved = sum(b.volume for b in blocks)
        nsub = max(1, num_stagers)

    else:  # pragma: no cover
        raise AssertionError(strategy)

    return LayoutPlan(strategy=strategy, global_shape=global_shape,
                      chunks=tuple(chunks), num_subfiles=nsub,
                      inter_process_moved=inter_moved,
                      intra_node_moved=intra_moved)
