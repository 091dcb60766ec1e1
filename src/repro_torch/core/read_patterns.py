"""The six common read patterns of a 3-D mesh variable (paper Fig. 6) and
reader-side decompositions (paper Fig. 5).

A pattern selects a region of the global array; a decomposition scheme
``(r_x, r_y, r_z)`` splits that region over ``prod(r)`` concurrent readers.
For restore-path ML use the same machinery describes "restore on a different
mesh" (whole domain, new decomposition) and tensor-slice inspection reads.
"""

from __future__ import annotations

from typing import Sequence

from .blocks import Block, regular_decomposition

__all__ = ["PATTERNS", "pattern_region", "decompose_region",
           "best_decompositions"]

#: the six patterns; fractions are of each axis extent
PATTERNS = (
    "whole_domain",   # everything
    "sub_area",       # centered half along each axis (1/8 of the volume)
    "plane_yz",       # single x-slab
    "plane_xz",       # single y-slab
    "plane_xy",       # single z-slab
    "line_z",         # 1-D pencil along z (fixed x,y)
)


def pattern_region(pattern: str, global_shape: Sequence[int],
                   slab_thickness: int = 1) -> Block:
    X, Y, Z = global_shape
    if pattern == "whole_domain":
        return Block((0, 0, 0), (X, Y, Z))
    if pattern == "sub_area":
        return Block((X // 4, Y // 4, Z // 4),
                     (X // 4 + X // 2, Y // 4 + Y // 2, Z // 4 + Z // 2))
    if pattern == "plane_yz":
        x = X // 2
        return Block((x, 0, 0), (x + slab_thickness, Y, Z))
    if pattern == "plane_xz":
        y = Y // 2
        return Block((0, y, 0), (X, y + slab_thickness, Z))
    if pattern == "plane_xy":
        z = Z // 2
        return Block((0, 0, z), (X, Y, z + slab_thickness))
    if pattern == "line_z":
        x, y = X // 2, Y // 2
        return Block((x, y, 0), (x + slab_thickness, y + slab_thickness, Z))
    raise ValueError(f"unknown pattern {pattern!r}")


def decompose_region(region: Block, scheme: Sequence[int]) -> list:
    """Split ``region`` into per-reader sub-regions (paper's 1x1x2 etc.).

    Axes whose extent is smaller than the requested split get fewer parts;
    the reader count is ``prod(effective scheme)``.
    """
    eff = tuple(min(s, e) for s, e in zip(scheme, region.shape))
    parts = regular_decomposition(region.shape, eff)
    return [p.translate(region.lo).with_owner(p.owner) for p in parts]


def best_decompositions(num_readers: int, ndim: int = 3) -> list:
    """All factorizations of ``num_readers`` into ``ndim`` axis splits.

    The paper reports the best-performing decomposition per reader count; the
    benchmark sweeps these and keeps the min.
    """
    out = []

    def rec(prefix, remaining, depth):
        if depth == ndim - 1:
            out.append(tuple(prefix + [remaining]))
            return
        f = 1
        while f <= remaining:
            if remaining % f == 0:
                rec(prefix + [f], remaining // f, depth + 1)
            f += 1
    rec([], num_readers, 0)
    return out
