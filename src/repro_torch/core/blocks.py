"""Index-space block (cuboid) abstractions.

The paper's unit of data is a *block*: an axis-aligned cuboid of cells inside a
global N-D array, owned by some process.  After load balancing, each process
owns an irregular set of blocks scattered through the global index space
(paper Fig. 8).  Everything in :mod:`repro_torch.core` is expressed over these
blocks; the same abstraction covers WarpX-style 3-D mesh variables and the
shard grids of checkpointed model parameters.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Block",
    "fast_block",
    "bounding_box",
    "total_volume",
    "blocks_disjoint",
    "uniform_grid_blocks",
    "simulate_load_balance",
    "regular_decomposition",
    "shard_grid_blocks",
]


@dataclasses.dataclass(frozen=True, order=True)
class Block:
    """Half-open axis-aligned cuboid ``[lo, hi)`` in global index space."""

    lo: tuple
    hi: tuple
    owner: int = -1          # process rank that holds the data (-1: unowned)
    block_id: int = -1       # stable id within a BlockSet

    def __post_init__(self):
        if len(self.lo) != len(self.hi):
            raise ValueError(f"rank mismatch: {self.lo} vs {self.hi}")
        if any(l >= h for l, h in zip(self.lo, self.hi)):
            raise ValueError(f"empty/inverted block: lo={self.lo} hi={self.hi}")

    # -- geometry ----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.lo)

    @property
    def shape(self) -> tuple:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def volume(self) -> int:
        v = 1
        for s in self.shape:
            v *= s
        return v

    def contains(self, other: "Block") -> bool:
        return all(sl <= ol and oh <= sh
                   for sl, ol, oh, sh in zip(self.lo, other.lo, other.hi, self.hi))

    def intersect(self, other: "Block"):
        """Intersection block or None."""
        lo = tuple(max(a, b) for a, b in zip(self.lo, other.lo))
        hi = tuple(min(a, b) for a, b in zip(self.hi, other.hi))
        if any(l >= h for l, h in zip(lo, hi)):
            return None
        return Block(lo, hi, owner=other.owner, block_id=other.block_id)

    def overlaps(self, other: "Block") -> bool:
        return all(max(a, b) < min(c, d)
                   for a, b, c, d in zip(self.lo, other.lo, self.hi, other.hi))

    def slices(self, origin: Sequence[int] | None = None) -> tuple:
        """numpy slices of this block relative to ``origin`` (default global 0)."""
        if origin is None:
            origin = (0,) * self.ndim
        return tuple(slice(l - o, h - o)
                     for l, h, o in zip(self.lo, self.hi, origin))

    def translate(self, offset: Sequence[int]) -> "Block":
        return Block(tuple(l + o for l, o in zip(self.lo, offset)),
                     tuple(h + o for h, o in zip(self.hi, offset)),
                     owner=self.owner, block_id=self.block_id)

    def with_owner(self, owner: int) -> "Block":
        return Block(self.lo, self.hi, owner=owner, block_id=self.block_id)

    def with_id(self, block_id: int) -> "Block":
        return Block(self.lo, self.hi, owner=self.owner, block_id=block_id)


# ---------------------------------------------------------------------------
# set-level helpers
# ---------------------------------------------------------------------------

def fast_block(lo: tuple, hi: tuple, owner: int = -1,
               block_id: int = -1) -> Block:
    """Construct a Block skipping ``__post_init__`` validation.

    For hot paths (cluster emission) where ``lo < hi`` holds by
    construction; callers are responsible for the invariant.
    """
    b = object.__new__(Block)
    object.__setattr__(b, "lo", lo)
    object.__setattr__(b, "hi", hi)
    object.__setattr__(b, "owner", owner)
    object.__setattr__(b, "block_id", block_id)
    return b


def bounding_box(blocks: Iterable[Block]) -> Block:
    blocks = list(blocks)
    if not blocks:
        raise ValueError("bounding_box of empty block set")
    nd = blocks[0].ndim
    lo = tuple(min(b.lo[d] for b in blocks) for d in range(nd))
    hi = tuple(max(b.hi[d] for b in blocks) for d in range(nd))
    return Block(lo, hi)


def total_volume(blocks: Iterable[Block]) -> int:
    return sum(b.volume for b in blocks)


def blocks_disjoint(blocks: Sequence[Block]) -> bool:
    """O(n^2) pairwise disjointness check (test/validation helper)."""
    for i, a in enumerate(blocks):
        for b in blocks[i + 1:]:
            if a.overlaps(b):
                return False
    return True


# ---------------------------------------------------------------------------
# block-distribution generators (the WarpX motif)
# ---------------------------------------------------------------------------

def uniform_grid_blocks(global_shape: Sequence[int],
                        block_shape: Sequence[int]) -> list:
    """Decompose ``global_shape`` into a regular grid of blocks.

    Mirrors AMReX's fixed ``max_grid_size`` box decomposition (paper §3.1).
    ``global_shape`` must be divisible by ``block_shape``.
    """
    counts = []
    for g, c in zip(global_shape, block_shape):
        if g % c:
            raise ValueError(f"{g} not divisible by block dim {c}")
        counts.append(g // c)
    out = []
    for bid, idx in enumerate(itertools.product(*[range(n) for n in counts])):
        lo = tuple(i * c for i, c in zip(idx, block_shape))
        hi = tuple((i + 1) * c for i, c in zip(idx, block_shape))
        out.append(Block(lo, hi, owner=-1, block_id=bid))
    return out


def simulate_load_balance(blocks: Sequence[Block],
                          num_procs: int,
                          rounds: int = 2,
                          exchange_frac: float = 0.1,
                          seed: int = 0,
                          locality_bias: float = 0.9) -> list:
    """Assign blocks to processes, then shuffle them like dynamic load balancing.

    Initially blocks are dealt out in space-filling (lexicographic) order, so
    each process owns a compact region — the state right after domain
    decomposition.  Each round then re-assigns a fraction of blocks to other
    processes, preferring *neighbouring* processes with probability
    ``locality_bias`` (AMReX load balancing trades work locally more often
    than globally).  The result is the paper's Fig. 8 situation: per-process
    block sets that are mostly-clustered but ragged.
    """
    rng = np.random.default_rng(seed)
    blocks = list(blocks)
    n = len(blocks)
    per = (n + num_procs - 1) // num_procs
    owners = np.array([min(i // per, num_procs - 1) for i in range(n)])
    for _ in range(rounds):
        k = max(1, int(exchange_frac * n))
        movers = rng.choice(n, size=k, replace=False)
        for i in movers:
            cur = owners[i]
            if rng.random() < locality_bias:
                step = int(rng.choice([-2, -1, 1, 2]))
                dst = int(np.clip(cur + step, 0, num_procs - 1))
            else:
                dst = int(rng.integers(0, num_procs))
            owners[i] = dst
    return [b.with_owner(int(owners[i])) for i, b in enumerate(blocks)]


def regular_decomposition(global_shape: Sequence[int],
                          scheme: Sequence[int]) -> list:
    """Regular ``scheme``-way decomposition (e.g. paper's 4x4x4 = 64 chunks).

    Axis sizes need not divide evenly; remainders go to trailing parts.
    """
    nd = len(global_shape)
    cuts = []
    for d in range(nd):
        g, s = global_shape[d], scheme[d]
        base, rem = divmod(g, s)
        edges = [0]
        for i in range(s):
            edges.append(edges[-1] + base + (1 if i >= s - rem else 0))
        cuts.append(edges)
    out = []
    for bid, idx in enumerate(itertools.product(*[range(len(c) - 1) for c in cuts])):
        lo = tuple(cuts[d][idx[d]] for d in range(nd))
        hi = tuple(cuts[d][idx[d] + 1] for d in range(nd))
        out.append(Block(lo, hi, owner=bid, block_id=bid))
    return out


def shard_grid_blocks(global_shape: Sequence[int],
                      grid: Sequence[int],
                      owner_of_shard) -> list:
    """Blocks for a sharded array: ``grid[d]``-way split along each axis.

    ``owner_of_shard(shard_index_tuple) -> int`` maps grid coordinates to the
    owning host — this is how a ``NamedSharding`` turns into a BlockSet (each
    host typically owns a *ragged* set of shards under DP+TP+EP meshes).
    """
    blocks = regular_decomposition(global_shape, grid)
    counts = list(grid)
    out = []
    for b in blocks:
        idx = []
        # recover grid coordinates from the decomposition order
        rem = b.block_id
        for d in reversed(range(len(counts))):
            idx.append(rem % counts[d])
            rem //= counts[d]
        idx = tuple(reversed(idx))
        out.append(Block(b.lo, b.hi, owner=int(owner_of_shard(idx)),
                         block_id=b.block_id))
    return out
