"""Extended Berger–Rigoutsos clustering and merging of data blocks.

Faithful implementation of the paper's Algorithm 1 (§4.2):

* works on N-D (the paper extends the original 2-D point algorithm to 3-D;
  we keep it rank-generic so parameter shard grids of any rank work too);
* never stops early — a cuboid is emitted only when it is *completely filled*
  by original blocks (``Vol(C) == sum Vol(b_i)``), unlike the original
  algorithm which tolerates empty space inside each rectangle;
* split placement = Laplacian edge detection over the per-axis occupancy
  histogram: build ``U_ax`` (fraction of each slab filled by original
  blocks), take the discrete second derivative ``L = lap(U)``, find
  zero-crossings of ``L``, and split at the zero-crossing whose histogram
  slope is steepest (paper Fig. 9).

Input blocks may be non-uniform (the paper notes the equal-shape assumption
"can be loosened to a certain extent"); candidate cuts are restricted to
coordinates that do not slice through any member block, which guarantees each
block lands in exactly one output cluster.

Two engines produce bit-identical cluster lists:

* **level-batched** (default) — the whole BFS frontier advances one level at
  a time; candidate-cut validation, occupancy histograms, Laplacians and
  zero-crossing selection for *every pending cuboid and every axis* are
  computed in a handful of flat ``bincount``/``cumsum``/``reduceat`` passes
  over globally coordinate-compressed block boundaries.  Per-split cost is
  O(n log n)-ish and, crucially, numpy dispatch overhead is paid per level
  instead of per cuboid, so clustering scales to tens of thousands of
  blocks.
* **per-node fallback** — vectorized ``searchsorted``/``bincount`` per
  cuboid; used when the coordinate universe is too large to rasterize
  (heavily irregular, non-grid-aligned blocks).

:func:`cluster_blocks_many` clusters many independent groups (e.g. one per
process) in one batched run — layout planners use it to cluster every
writer's blocks simultaneously.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Sequence

import numpy as np

from .blocks import Block, fast_block

__all__ = ["Cluster", "cluster_blocks", "cluster_blocks_many",
           "merged_block_counts"]

#: above this many distinct boundary coordinates per axis the dense
#: rasterization would waste memory; fall back to the per-node engine
_DENSE_COORD_LIMIT = 512


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A fully-filled cuboid and the original blocks merged into it."""

    cuboid: Block
    members: tuple

    @property
    def volume(self) -> int:
        return self.cuboid.volume

    def __len__(self) -> int:
        return len(self.members)


# ---------------------------------------------------------------------------
# shared scalar pieces
# ---------------------------------------------------------------------------

def _laplacian(u: np.ndarray) -> np.ndarray:
    """Discrete Laplacian with replicated boundary (second difference)."""
    padded = np.concatenate([u[:1], u, u[-1:]])
    return padded[2:] - 2 * padded[1:-1] + padded[:-2]


def _extract_bounds(blocks: Sequence[Block]) -> tuple:
    n = len(blocks)
    ndim = blocks[0].ndim
    los = np.fromiter(itertools.chain.from_iterable(b.lo for b in blocks),
                      dtype=np.int64, count=n * ndim).reshape(n, ndim)
    his = np.fromiter(itertools.chain.from_iterable(b.hi for b in blocks),
                      dtype=np.int64, count=n * ndim).reshape(n, ndim)
    return los, his


# ---------------------------------------------------------------------------
# per-node engine (irregular-coordinate fallback)
# ---------------------------------------------------------------------------

def _valid_cuts(lo_sorted: np.ndarray, hi_sorted: np.ndarray,
                box_lo: int, box_hi: int) -> np.ndarray:
    """Interior cut candidates: block boundaries that no block straddles.

    A block straddles ``c`` iff ``lo < c < hi``; with both boundary arrays
    sorted, the straddler count at ``c`` is ``#{lo < c} - #{hi <= c}``.
    """
    cand = np.unique(np.concatenate([lo_sorted, hi_sorted]))
    cand = cand[(cand > box_lo) & (cand < box_hi)]
    if cand.size == 0:
        return cand
    n_lo_less = np.searchsorted(lo_sorted, cand, side="left")
    n_hi_le = np.searchsorted(hi_sorted, cand, side="right")
    return cand[n_lo_less == n_hi_le]


def _best_split_on_axis(lo_ax: np.ndarray, hi_ax: np.ndarray,
                        vols: np.ndarray, box_lo: int, box_hi: int,
                        other_vol: int):
    """Returns (score, cut_coord) for the steepest zero-crossing, or None."""
    lo_sorted = np.sort(lo_ax)
    hi_sorted = np.sort(hi_ax)
    cuts = _valid_cuts(lo_sorted, hi_sorted, box_lo, box_hi)
    if cuts.size == 0:
        return None
    # slabs bounded by the candidate cuts (plus the box ends); no block
    # straddles a valid cut, so each block lies wholly inside one slab and
    # the occupancy histogram is a bincount of member volumes
    edges = np.concatenate(([box_lo], cuts, [box_hi]))
    slab = np.searchsorted(edges, lo_ax, side="right") - 1
    filled = np.bincount(slab, weights=vols, minlength=len(edges) - 1)
    u = filled / (np.diff(edges) * other_vol)
    lap = _laplacian(u)
    # a zero-crossing between slab i and i+1 corresponds to cutting at
    # edges[i+1]; its edge strength is the Laplacian jump |L[i+1]-L[i]|
    pair_nonzero = ~((lap[:-1] == 0.0) & (lap[1:] == 0.0))
    zc = np.flatnonzero((lap[:-1] * lap[1:] <= 0.0) & pair_nonzero)
    if zc.size:
        scores = np.abs(lap[zc + 1] - lap[zc])
        j = int(np.argmax(scores))
        return float(scores[j]), int(edges[zc[j] + 1])
    # no inflection point: histogram is monotone/flat. Fall back to the
    # largest |gradient| position, then to the median cut, so the
    # recursion always makes progress.
    grad = np.abs(np.diff(u))
    if grad.size and grad.max() > 0:
        i = int(np.argmax(grad))
        return float(grad[i]), int(edges[i + 1])
    return 0.0, int(edges[len(edges) // 2])


def _halve_by_centroid(idx: np.ndarray, los: np.ndarray, his: np.ndarray,
                       blo: np.ndarray, bhi: np.ndarray):
    """Fallback when no clean cut exists on any axis (heavily irregular,
    non-grid-aligned blocks): partition the *block list* in half by centroid
    along the longest bounding-box axis.  Each block still lands in exactly
    one side; emitted cuboids remain fully filled, hence disjoint."""
    axis = int(np.argmax(bhi - blo))
    order = idx[np.argsort(los[idx, axis] + his[idx, axis], kind="stable")]
    half = len(order) // 2
    return order[:half], order[half:]


def _node_split(idx: np.ndarray, los: np.ndarray, his: np.ndarray,
                fvols: np.ndarray, blo: np.ndarray, bhi: np.ndarray,
                box_vol: int):
    """Split one pending cuboid (per-node engine)."""
    best = None
    for axis in range(los.shape[1]):
        other_vol = box_vol // int(bhi[axis] - blo[axis])
        cand = _best_split_on_axis(los[idx, axis], his[idx, axis],
                                   fvols[idx], int(blo[axis]),
                                   int(bhi[axis]), other_vol)
        if cand is None:
            continue
        score, cut = cand
        if best is None or score > best[0]:
            best = (score, axis, cut)
    if best is None:
        return _halve_by_centroid(idx, los, his, blo, bhi)
    _, axis, cut = best
    left_mask = his[idx, axis] <= cut        # valid cuts never straddle
    l, r = idx[left_mask], idx[~left_mask]
    if not l.size or not r.size:             # degenerate cut; force progress
        return _halve_by_centroid(idx, los, his, blo, bhi)
    return l, r


def _cluster_per_node(blocks: list, los: np.ndarray, his: np.ndarray,
                      vols: np.ndarray, groups: list,
                      max_clusters: int | None) -> list:
    """BFS with per-node numpy split selection (the irregular fallback)."""
    fvols = vols.astype(np.float64)
    results = []
    for g_lo, g_hi in groups:
        out: list = []
        if g_hi == g_lo:
            results.append(out)
            continue
        queue = deque()
        queue.append(np.arange(g_lo, g_hi))
        while queue:
            idx = queue.popleft()
            blo = los[idx].min(axis=0)
            bhi = his[idx].max(axis=0)
            box_vol = int((bhi - blo).prod())
            if box_vol == int(vols[idx].sum()):
                members = tuple(blocks[i] for i in idx)
                out.append(Cluster(
                    cuboid=Block(tuple(map(int, blo)), tuple(map(int, bhi)),
                                 owner=members[0].owner),
                    members=members))
                continue
            if max_clusters is not None \
                    and len(out) + len(queue) + 2 > max_clusters:
                # budget exhausted: emit this cuboid as-is (possibly not
                # fully filled — layout planners opt into that via the cap)
                out.append(Cluster(
                    cuboid=Block(tuple(map(int, blo)), tuple(map(int, bhi))),
                    members=tuple(blocks[i] for i in idx)))
                continue
            l, r = _node_split(idx, los, his, fvols, blo, bhi, box_vol)
            for part in (l, r):
                if part.size:
                    queue.append(part)
        results.append(out)
    return results


# ---------------------------------------------------------------------------
# level-batched engine
# ---------------------------------------------------------------------------

def _group_first_argmax(values: np.ndarray, valid: np.ndarray,
                        gid: np.ndarray, ngroups: int) -> tuple:
    """Per-group (max value, flat index of its FIRST occurrence) over the
    ``valid`` entries of ``values``; groups with no valid entry get -inf/-1.

    ``gid`` must be sorted ascending (entries grouped contiguously).
    """
    masked = np.where(valid, values, -np.inf)
    gmax = np.full(ngroups, -np.inf)
    np.maximum.at(gmax, gid, masked)
    hit = valid & (masked == gmax[gid])
    pos = np.where(hit, np.arange(len(values)), len(values))
    first = np.full(ngroups, len(values), dtype=np.int64)
    np.minimum.at(first, gid, pos)
    has = np.isfinite(gmax) & (first < len(values))
    return gmax, np.where(has, first, -1)


def _batched_splits(mem_a: np.ndarray, a_starts: np.ndarray,
                    seg_a: np.ndarray, active: np.ndarray,
                    los: np.ndarray, his: np.ndarray, vols: np.ndarray,
                    lo_c: np.ndarray, hi_c: np.ndarray,
                    coords_pad: np.ndarray, widths_pad: np.ndarray,
                    blo: np.ndarray, bhi: np.ndarray, box_vol: np.ndarray):
    """Best (axis, cut) for every active frontier segment, all at once.

    ``mem_a``/``a_starts``/``seg_a`` describe the flat member table of the
    active segments.  Returns (ax_best, cut_best, has_split) arrays indexed
    by *active* order.  See module docstring: one flat bincount/cumsum pass
    covers every (segment, axis) pair of the level.
    """
    ndim = los.shape[1]
    C = coords_pad.shape[1]
    A = len(active)
    K = A * ndim

    # (segment, axis, coord) event rasters via one bincount each
    ax_ids = np.arange(ndim)
    key_base = (seg_a[:, None] * ndim + ax_ids) * C        # (Ma, d)
    keys_lo = (key_base + lo_c[mem_a]).ravel()
    keys_hi = (key_base + hi_c[mem_a]).ravel()
    starts_cnt = np.bincount(keys_lo, minlength=K * C).reshape(K, C)
    ends_cnt = np.bincount(keys_hi, minlength=K * C).reshape(K, C)
    w = (vols[mem_a][:, None] // (his[mem_a] - los[mem_a])).astype(np.float64)
    rate = (np.bincount(keys_lo, weights=w.ravel(), minlength=K * C)
            - np.bincount(keys_hi, weights=w.ravel(), minlength=K * C)
            ).reshape(K, C)

    cs = np.cumsum(starts_cnt, axis=1)
    ce = np.cumsum(ends_cnt, axis=1)
    straddle = np.empty_like(cs)
    straddle[:, 0] = 0
    straddle[:, 1:] = cs[:, :-1] - ce[:, 1:]
    boundary = (starts_cnt + ends_cnt) > 0

    # compressed bounding boxes per (segment, axis)
    blo_c = np.minimum.reduceat(lo_c[mem_a], a_starts[:-1], axis=0)  # (A,d)
    bhi_c = np.maximum.reduceat(hi_c[mem_a], a_starts[:-1], axis=0)
    c_range = np.arange(C)
    interior = (c_range > blo_c[..., None]) & (c_range < bhi_c[..., None])
    valid = (straddle == 0) & boundary \
        & interior.reshape(K, C)
    is_end = (c_range == blo_c[..., None]) | (c_range == bhi_c[..., None])
    edge_mask = valid | is_end.reshape(K, C)

    # cumulative filled volume (exact: integer-valued floats) at every coord
    fill_cum = np.zeros((K, C))
    np.cumsum(np.cumsum(rate, axis=1)[:, :-1]
              * widths_pad[np.tile(ax_ids, A)][:, : C - 1],
              axis=1, out=fill_cum[:, 1:])

    # flat ragged edge table, grouped by (segment, axis), coords ascending
    ek, ec = np.nonzero(edge_mask)
    n_edges = np.bincount(ek, minlength=K)                 # >= 2 everywhere
    e_ax = ek % ndim
    e_coord = coords_pad[e_ax, ec]
    e_fill = fill_cum[ek, ec]
    # slabs = edges that are not last-in-group
    not_last = np.empty(len(ek), dtype=bool)
    not_last[:-1] = ek[:-1] == ek[1:]
    not_last[-1] = False
    slab_pos = np.flatnonzero(not_last)
    slab_k = ek[slab_pos]
    slab_w = e_coord[slab_pos + 1] - e_coord[slab_pos]
    slab_fill = e_fill[slab_pos + 1] - e_fill[slab_pos]
    other_vol = (box_vol[active][:, None]
                 // (bhi[active] - blo[active])).reshape(K)
    u = slab_fill / (slab_w * other_vol[slab_k])

    # ragged Laplacian with replicated ends
    same_prev = np.empty(len(u), dtype=bool)
    same_prev[0] = False
    same_prev[1:] = slab_k[1:] == slab_k[:-1]
    u_prev = np.where(same_prev, np.roll(u, 1), u)
    same_next = np.empty(len(u), dtype=bool)
    same_next[-1] = False
    same_next[:-1] = slab_k[:-1] == slab_k[1:]
    u_next = np.where(same_next, np.roll(u, -1), u)
    lap = u_next - 2 * u + u_prev

    # zero-crossings between slab i and i+1 (same group): cut at the shared
    # edge; strength = |lap[i+1] - lap[i]|
    li, lj = lap[:-1], lap[1:]
    pair_ok = same_next[:-1]
    zc_ok = pair_ok & (li * lj <= 0.0) & ~((li == 0.0) & (lj == 0.0))
    zc_score = np.abs(lj - li)
    pair_gid = slab_k[:-1]
    zmax, zfirst = _group_first_argmax(zc_score, zc_ok, pair_gid, K)
    # gradient fallback for groups with cuts but no zero-crossing
    g_ok = pair_ok
    g_score = np.abs(u[1:] - u[:-1])
    gmax, gfirst = _group_first_argmax(g_score, g_ok & (g_score > 0),
                                       pair_gid, K)

    has_cuts = n_edges > 2
    score_k = np.where(zfirst >= 0, zmax, np.where(gfirst >= 0, gmax, 0.0))
    score_k = np.where(has_cuts, score_k, -np.inf)
    # winning pair index -> cut coordinate = left edge of slab i+1
    pick = np.where(zfirst >= 0, zfirst, gfirst)
    group_start = np.concatenate(([0], np.cumsum(n_edges)))[:-1]
    median_edge = group_start + n_edges // 2
    cut_edge = np.where(pick >= 0, slab_pos[np.maximum(pick, 0) + 1],
                        np.minimum(median_edge, len(ek) - 1))
    cut_k = e_coord[cut_edge]

    score_ad = score_k.reshape(A, ndim)
    ax_best = np.argmax(score_ad, axis=1)
    has_split = np.isfinite(score_ad[np.arange(A), ax_best])
    cut_best = cut_k.reshape(A, ndim)[np.arange(A), ax_best]
    return ax_best, cut_best, has_split


def _cluster_batched(blocks: list, los: np.ndarray, his: np.ndarray,
                     vols: np.ndarray, groups: list,
                     max_clusters: int | None) -> list:
    """Level-synchronous Algorithm 1 over many groups at once.

    Visits pending cuboids in exactly the per-group BFS order of the
    per-node engine, so outputs (including ``max_clusters`` truncation) are
    identical; only the *batching* of the split computation differs.
    """
    ndim = los.shape[1]
    # global coordinate compression, one universe per axis — built lazily on
    # the first level that actually needs a split (fully-filled inputs never
    # pay for it)
    compression = None

    def _compress():
        coords = [np.unique(np.concatenate([los[:, d], his[:, d]]))
                  for d in range(ndim)]
        C = max(len(c) for c in coords)
        if C > _DENSE_COORD_LIMIT:
            return None
        coords_pad = np.stack([np.pad(c, (0, C - len(c)), mode="edge")
                               for c in coords])
        widths_pad = np.diff(coords_pad, axis=1)
        lo_c = np.stack([np.searchsorted(coords[d], los[:, d])
                         for d in range(ndim)], axis=1)
        hi_c = np.stack([np.searchsorted(coords[d], his[:, d])
                         for d in range(ndim)], axis=1)
        return lo_c, hi_c, coords_pad, widths_pad

    results = [[] for _ in groups]
    # frontier: concatenated member ids + segment table (start, group, pending
    # same-group nodes behind this one in seed BFS order — for the cap rule)
    mem = np.arange(len(blocks))
    starts = np.array([g[0] for g in groups] + [groups[-1][1]],
                      dtype=np.int64)
    nonempty = np.diff(starts) > 0
    seg_group = np.arange(len(groups))[nonempty]
    starts = np.concatenate((starts[:-1][nonempty], starts[-1:]))

    while len(starts) > 1:
        sizes = np.diff(starts)
        blo = np.minimum.reduceat(los[mem], starts[:-1], axis=0)
        bhi = np.maximum.reduceat(his[mem], starts[:-1], axis=0)
        box_vol = (bhi - blo).prod(axis=1)
        seg_vol = np.add.reduceat(vols[mem], starts[:-1])
        full = box_vol == seg_vol
        active = np.flatnonzero(~full)
        if active.size and compression is None:
            compression = _compress()
            if compression is None:     # coord universe too large: rasterize
                return _cluster_per_node(blocks, los, his, vols, groups,
                                         max_clusters)
        if active.size:
            lo_c, hi_c, coords_pad, widths_pad = compression
            a_sizes = sizes[active]
            a_starts = np.concatenate(([0], np.cumsum(a_sizes)))
            mem_a = np.concatenate(
                [mem[starts[s]:starts[s + 1]] for s in active]) \
                if len(active) < len(sizes) else mem
            seg_a = np.repeat(np.arange(len(active)), a_sizes)
            ax_best, cut_best, has_split = _batched_splits(
                mem_a, a_starts, seg_a, active, los, his, vols, lo_c, hi_c,
                coords_pad, widths_pad, blo, bhi, box_vol)
            # left/right side of every active member, one vectorized pass
            axm = ax_best[seg_a]
            left_all = his[mem_a, axm] <= cut_best[seg_a]
        a_idx = np.full(len(sizes), -1, dtype=np.int64)
        a_idx[active] = np.arange(len(active))

        # sequential walk in BFS order: emit / cap / enqueue children
        next_mem_parts = []
        next_seg_group = []
        # seed-queue length for group g while visiting segment s of level:
        # (same-group segments after s this level) + children enqueued so far
        remaining = np.bincount(seg_group, minlength=len(groups))
        children_count = np.zeros(len(groups), dtype=np.int64)
        blo_l = blo.tolist()
        bhi_l = bhi.tolist()
        mem_l = mem.tolist()
        starts_l = starts.tolist()
        for s in range(len(sizes)):
            g = int(seg_group[s])
            remaining[g] -= 1
            out = results[g]
            if full[s]:
                members = tuple(blocks[i]
                                for i in mem_l[starts_l[s]:starts_l[s + 1]])
                out.append(Cluster(
                    cuboid=fast_block(tuple(blo_l[s]), tuple(bhi_l[s]),
                                      owner=members[0].owner),
                    members=members))
                continue
            if max_clusters is not None and len(out) + remaining[g] \
                    + children_count[g] + 2 > max_clusters:
                out.append(Cluster(
                    cuboid=fast_block(tuple(blo_l[s]), tuple(bhi_l[s])),
                    members=tuple(blocks[i] for i in
                                  mem_l[starts_l[s]:starts_l[s + 1]])))
                continue
            a = a_idx[s]
            seg_members = mem_a[a_starts[a]:a_starts[a + 1]]
            if has_split[a]:
                left_mask = left_all[a_starts[a]:a_starts[a + 1]]
                l = seg_members[left_mask]
                r = seg_members[~left_mask]
                if not l.size or not r.size:
                    l, r = _halve_by_centroid(seg_members, los, his,
                                              blo[s], bhi[s])
            else:
                l, r = _halve_by_centroid(seg_members, los, his,
                                          blo[s], bhi[s])
            for part in (l, r):
                if part.size:
                    next_mem_parts.append(part)
                    next_seg_group.append(g)
                    children_count[g] += 1

        if not next_mem_parts:
            break
        mem = np.concatenate(next_mem_parts)
        sizes = np.fromiter((len(p) for p in next_mem_parts),
                            dtype=np.int64, count=len(next_mem_parts))
        starts = np.concatenate(([0], np.cumsum(sizes)))
        seg_group = np.asarray(next_seg_group, dtype=np.int64)
    return results


# ---------------------------------------------------------------------------
# Algorithm 1 — public API
# ---------------------------------------------------------------------------

def cluster_blocks_many(block_groups: Sequence[Sequence[Block]],
                        max_clusters: int | None = None) -> list:
    """Cluster many independent block groups in one batched run.

    Equivalent to ``[cluster_blocks(g, max_clusters) for g in block_groups]``
    but the level-batched engine advances every group's recursion together —
    layout planners cluster all writers' blocks in one pass this way.
    """
    groups = [list(g) for g in block_groups]
    flat = [b for g in groups for b in g]
    if not flat:
        return [[] for _ in groups]
    los, his = _extract_bounds(flat)
    vols = (his - los).prod(axis=1)
    bounds = []
    off = 0
    for g in groups:
        bounds.append((off, off + len(g)))
        off += len(g)
    return _cluster_batched(flat, los, his, vols, bounds, max_clusters)


def cluster_blocks(blocks: Sequence[Block],
                   max_clusters: int | None = None) -> list:
    """Cluster ``blocks`` into the minimal* set of fully-filled cuboids.

    (*minimal in the greedy Berger–Rigoutsos sense.)  Returns a list of
    :class:`Cluster`; every input block appears in exactly one cluster and
    every cluster's cuboid volume equals the sum of its member volumes.

    ``max_clusters`` optionally stops refinement early once that many
    clusters have been emitted plus queued (each queued cuboid yields >= 1
    cluster); used by layout planners that cap chunk counts.
    """
    blocks = list(blocks)
    if not blocks:
        return []
    return cluster_blocks_many([blocks], max_clusters=max_clusters)[0]


def merged_block_counts(blocks: Sequence[Block]) -> tuple:
    """(original_count, merged_count) — the paper's 10->3 / 64->10 metric."""
    clusters = cluster_blocks(blocks)
    return len(blocks), len(clusters)
