"""Spatial chunk index: sub-linear region -> chunk lookup.

``Dataset.read`` used to do a full linear scan over every stored
:class:`ChunkRecord` per query; with thousands of chunks the index lookup
dominates the read itself (the metadata cost ADIOS2-style formats are known
for).  This module provides an exact axis-aligned-box index over the chunk
cuboids of one variable with two complementary organizations:

* **grid buckets** — the common case.  Stored chunks come from regular or
  near-regular decompositions, so a bucket grid sized from the mean chunk
  shape assigns almost every chunk to exactly one bucket; a query touches
  only the buckets its region overlaps.
* **sorted-interval fallback** — irregular chunk populations (wildly mixed
  sizes) would smear single chunks over many buckets.  Instead we keep, per
  axis, the chunk intervals sorted by their low edge; a query picks the most
  selective axis via ``searchsorted`` and only scans that prefix.

Both organizations finish with the same vectorized exact AABB test, so a
query returns precisely the intersecting chunk ids (ascending), never a
superset.  The index is persisted inside ``index.json`` (format version 2)
and rebuilt transparently for version-1 datasets.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SpatialChunkIndex", "aabb_mask"]


def aabb_mask(los: np.ndarray, his: np.ndarray, lo, hi) -> np.ndarray:
    """Boolean mask of the ``[los, his)`` boxes intersecting ``[lo, hi)``.

    The one intersection predicate shared by the index, the read planner and
    the brute-force oracle — half-open on every axis.
    """
    return np.all(los < hi, axis=1) & np.all(his > lo, axis=1)

#: fall back to the interval organization once chunks overlap this many
#: buckets each on average (grid degenerates for very mixed chunk sizes)
_MAX_MEAN_OCCUPANCY = 8.0
#: cap on total bucket count relative to chunk count
_MAX_BUCKET_FACTOR = 4


class SpatialChunkIndex:
    """Exact AABB index over the chunk cuboids of one variable.

    ``los``/``his`` are ``(n, d)`` int64 arrays of chunk bounds; ids returned
    by :meth:`query` are row positions into them (the caller maps those to
    ``ChunkRecord`` positions).
    """

    def __init__(self, los: np.ndarray, his: np.ndarray):
        self.los = np.ascontiguousarray(los, dtype=np.int64)
        self.his = np.ascontiguousarray(his, dtype=np.int64)
        if self.los.ndim != 2 or self.los.shape != self.his.shape:
            raise ValueError("los/his must be matching (n, d) arrays")
        self.n, self.ndim = self.los.shape
        self.kind = "interval"
        # grid organization
        self._origin = None
        self._bucket = None
        self._dims = None
        self._starts = None          # CSR offsets, len prod(dims)+1
        self._ids = None             # CSR payload
        # interval organization (built lazily; tiny)
        self._lo_sorted = None       # (n, d) lo values, per-axis ascending
        self._lo_order = None        # (n, d) ids in that order
        if self.n:
            self._build()

    # -- construction -------------------------------------------------------
    def _build(self) -> None:
        los, his = self.los, self.his
        origin = los.min(axis=0)
        extent = np.maximum(his.max(axis=0) - origin, 1)
        bucket = np.maximum(
            np.round((his - los).mean(axis=0)).astype(np.int64), 1)
        dims = -(-extent // bucket)
        # keep the grid at most _MAX_BUCKET_FACTOR * n cells
        cap = max(_MAX_BUCKET_FACTOR * self.n, 64)
        while int(dims.prod()) > cap:
            ax = int(np.argmax(dims))
            bucket[ax] *= 2
            dims[ax] = -(-extent[ax] // bucket[ax])
        b_lo = (los - origin) // bucket
        b_hi = (his - 1 - origin) // bucket + 1
        occupancy = (b_hi - b_lo).prod(axis=1)
        if occupancy.mean() > _MAX_MEAN_OCCUPANCY:
            self._build_interval()
            return
        self.kind = "grid"
        self._origin, self._bucket, self._dims = origin, bucket, dims
        ncells = int(dims.prod())
        if int(occupancy.max()) == 1:
            # every chunk in exactly one bucket: fully vectorized CSR build
            cell = np.ravel_multi_index(tuple(b_lo.T), tuple(dims))
            order = np.argsort(cell, kind="stable")
            counts = np.bincount(cell, minlength=ncells)
            self._ids = order.astype(np.int64)
            self._starts = np.concatenate(
                ([0], np.cumsum(counts))).astype(np.int64)
            return
        cells, ids = [], []
        for i in range(self.n):
            ranges = [np.arange(b_lo[i, d], b_hi[i, d])
                      for d in range(self.ndim)]
            grid = np.meshgrid(*ranges, indexing="ij")
            lin = np.ravel_multi_index(tuple(g.ravel() for g in grid),
                                       tuple(dims))
            cells.append(lin)
            ids.append(np.full(lin.size, i, dtype=np.int64))
        cells = np.concatenate(cells)
        ids = np.concatenate(ids)
        order = np.argsort(cells, kind="stable")
        counts = np.bincount(cells, minlength=ncells)
        self._ids = ids[order]
        self._starts = np.concatenate(
            ([0], np.cumsum(counts))).astype(np.int64)

    def _build_interval(self) -> None:
        self.kind = "interval"
        order = np.argsort(self.los, axis=0, kind="stable")
        self._lo_order = order.astype(np.int64)
        self._lo_sorted = np.take_along_axis(self.los, order, axis=0)

    # -- queries ------------------------------------------------------------
    def _exact(self, ids: np.ndarray, lo, hi) -> np.ndarray:
        if ids.size == 0:
            return ids
        keep = aabb_mask(self.los[ids], self.his[ids], lo, hi)
        return np.sort(ids[keep])

    def query(self, lo, hi) -> np.ndarray:
        """Ids of every chunk whose cuboid intersects ``[lo, hi)``, ascending."""
        if self.n == 0:
            return np.empty(0, dtype=np.int64)
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        if self.kind == "grid":
            q_lo = np.clip((lo - self._origin) // self._bucket,
                           0, self._dims - 1)
            q_hi = np.clip((hi - 1 - self._origin) // self._bucket,
                           0, self._dims - 1) + 1
            if np.any(hi <= self._origin) or \
                    np.any(lo >= self._origin + self._bucket * self._dims):
                return np.empty(0, dtype=np.int64)
            if np.all(q_lo == 0) and np.all(q_hi == self._dims):
                return self._exact(np.arange(self.n, dtype=np.int64), lo, hi)
            ranges = [np.arange(q_lo[d], q_hi[d]) for d in range(self.ndim)]
            grid = np.meshgrid(*ranges, indexing="ij")
            cells = np.ravel_multi_index(tuple(g.ravel() for g in grid),
                                         tuple(self._dims))
            # vectorized CSR multi-slice gather
            lens = self._starts[cells + 1] - self._starts[cells]
            total = int(lens.sum())
            if total == 0:
                return np.empty(0, dtype=np.int64)
            base = np.repeat(self._starts[cells]
                             - np.concatenate(([0], np.cumsum(lens)[:-1])),
                             lens)
            cand = self._ids[np.arange(total) + base]
            return self._exact(np.unique(cand), lo, hi)
        # interval: pick the axis whose lo < hi[ax] prefix is smallest
        prefix = np.array([
            np.searchsorted(self._lo_sorted[:, d], hi[d], side="left")
            for d in range(self.ndim)])
        ax = int(np.argmin(prefix))
        cand = self._lo_order[:prefix[ax], ax]
        return self._exact(cand, lo, hi)

    # -- persistence --------------------------------------------------------
    def to_json(self) -> dict:
        """Compact payload (bounds live in the chunk records, not here)."""
        if self.kind != "grid" or self.n == 0:
            return {"kind": "interval"}
        return {"kind": "grid",
                "origin": self._origin.tolist(),
                "bucket": self._bucket.tolist(),
                "dims": self._dims.tolist(),
                "starts": self._starts.tolist(),
                "ids": self._ids.tolist()}

    @staticmethod
    def from_json(payload: dict, los: np.ndarray,
                  his: np.ndarray) -> "SpatialChunkIndex":
        idx = SpatialChunkIndex.__new__(SpatialChunkIndex)
        idx.los = np.ascontiguousarray(los, dtype=np.int64)
        idx.his = np.ascontiguousarray(his, dtype=np.int64)
        idx.n, idx.ndim = idx.los.shape if idx.los.ndim == 2 else (0, 0)
        idx._origin = idx._bucket = idx._dims = None
        idx._starts = idx._ids = None
        idx._lo_sorted = idx._lo_order = None
        idx.kind = payload.get("kind", "interval")
        if idx.n == 0:
            idx.kind = "interval"
            return idx
        if idx.kind == "grid":
            idx._origin = np.asarray(payload["origin"], dtype=np.int64)
            idx._bucket = np.asarray(payload["bucket"], dtype=np.int64)
            idx._dims = np.asarray(payload["dims"], dtype=np.int64)
            idx._starts = np.asarray(payload["starts"], dtype=np.int64)
            idx._ids = np.asarray(payload["ids"], dtype=np.int64)
        else:
            idx._build_interval()
        return idx
