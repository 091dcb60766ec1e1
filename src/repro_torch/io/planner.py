"""Extent planning for both I/O directions.

Read side — converts a region query into an explicit, ordered extent plan
before any I/O happens:

1. **probe** — the variable's :class:`~repro_torch.io.spatial.SpatialChunkIndex`
   (or a caller-supplied candidate superset, narrowed vectorized) yields
   exactly the intersecting chunk rows;
2. **extents** — for every hit the planner computes, fully vectorized, the
   intersection cuboid, the needed byte span inside the stored extent and
   the *exact* number of contiguous byte runs;
3. **order + coalesce** — hits are sorted by ``(subfile, offset)`` and
   adjacent byte spans are merged into run *groups* (one ``preadv``-style
   grouped read each).

Write side — converts a :class:`~repro_torch.core.layouts.LayoutPlan` into
the same vectorized extent representation: per-extent subfile/offset/size
arrays, alignment padding folded in at plan time, rows sorted by
``(subfile, offset)`` and adjacent extents coalesced into groups.

A copy of the JAX package's planner: the same inputs give the same plans,
so both packages lay out and find the same bytes.  All byte-offset
arithmetic of the container lives in this module; the engines in
:mod:`repro_torch.io.engine` execute plans verbatim.  A plan's shape —
coalesced groups, contiguous runs, payload and span bytes — is what
``engine="auto"`` prices (:func:`repro_torch.core.cost_model.
choose_engine`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.blocks import Block
from ..core.layouts import LayoutPlan
from .format import DatasetIndex, VarRows, align_up
from .spatial import aabb_mask

__all__ = ["ReadPlan", "WritePlan", "build_read_plan", "build_write_plan",
           "build_span_plan", "subset_write_plan", "linear_candidates"]


def linear_candidates(rows: VarRows, region: Block) -> np.ndarray:
    """Brute-force O(n) candidate scan — the pre-index behaviour, kept as the
    oracle for property tests and as the benchmark baseline."""
    if rows.n == 0:
        return np.empty(0, dtype=np.int64)
    m = aabb_mask(rows.los, rows.his, np.asarray(region.lo, dtype=np.int64),
                  np.asarray(region.hi, dtype=np.int64))
    return np.flatnonzero(m).astype(np.int64)


@dataclasses.dataclass
class ReadPlan:
    """Explicit extent list for one region read, in execution order.

    All per-hit arrays are row-aligned and sorted by ``(subfile, file_lo)``.
    ``group_bounds`` delimits coalesced run groups: group ``g`` covers plan
    rows ``group_bounds[g]:group_bounds[g+1]`` and one contiguous byte span
    per group is enough to serve every row in it.
    """

    var: str
    region: Block
    dtype: np.dtype
    rec_ids: np.ndarray        # (m,) positions into DatasetIndex.chunks
    chunk_los: np.ndarray      # (m,d) stored-chunk bounds
    chunk_his: np.ndarray
    inter_los: np.ndarray      # (m,d) intersection with the region
    inter_his: np.ndarray
    strides: np.ndarray        # (m,d) row-major element strides of each chunk
    subfiles: np.ndarray       # (m,)
    extent_offsets: np.ndarray  # (m,) byte offset of the whole stored extent
    extent_nbytes: np.ndarray   # (m,) size of the whole stored extent
    file_lo: np.ndarray        # (m,) first needed byte (absolute, in subfile)
    file_hi: np.ndarray        # (m,) end of last needed byte
    chunk_runs: np.ndarray     # (m,) exact contiguous runs within each chunk
    group_bounds: np.ndarray   # (g+1,)
    runs: int                  # total runs after cross-chunk coalescing
    bytes_needed: int          # payload bytes (== region ∩ chunks volume)
    span_bytes: int            # bytes pulled if every group span is read whole
    probe_seconds: float = 0.0
    plan_seconds: float = 0.0
    #: per-row codec codes (0 = raw; see ``repro_torch.core.codecs``).  ``None``
    #: means every row is raw.  A compressed row's ``file_lo``/``file_hi``
    #: span the WHOLE stored extent (decompression needs all of it) and the
    #: strided gather happens post-decode in ``scatter_row``.
    codecs: np.ndarray | None = None

    @property
    def num_chunks(self) -> int:
        return len(self.rec_ids)

    @property
    def num_groups(self) -> int:
        return len(self.group_bounds) - 1

    def out_slices(self, row: int) -> tuple:
        """numpy slices of plan row ``row`` inside the region's output array."""
        olo = self.region.lo
        return tuple(slice(int(l - o), int(h - o))
                     for l, h, o in zip(self.inter_los[row],
                                        self.inter_his[row], olo))


def _empty_plan(var: str, region: Block, dtype: np.dtype, ndim: int,
                probe_seconds: float) -> ReadPlan:
    z = np.empty(0, dtype=np.int64)
    z2 = np.empty((0, ndim), dtype=np.int64)
    return ReadPlan(var=var, region=region, dtype=dtype, rec_ids=z,
                    chunk_los=z2, chunk_his=z2, inter_los=z2, inter_his=z2,
                    strides=z2, subfiles=z, extent_offsets=z, extent_nbytes=z,
                    file_lo=z, file_hi=z, chunk_runs=z,
                    group_bounds=np.zeros(1, dtype=np.int64), runs=0,
                    bytes_needed=0, span_bytes=0,
                    probe_seconds=probe_seconds)


def build_read_plan(index: DatasetIndex, var: str, region: Block,
                    candidates: np.ndarray | None = None,
                    coalesce_gap: int = 0) -> ReadPlan:
    """Plan a read of ``region`` of ``var``.

    ``candidates`` — optional candidate *row* superset from a previous probe
    of an enclosing region (decomposed reads share one probe this way); it is
    narrowed to the exact hit set vectorized.  ``coalesce_gap`` merges spans
    separated by at most that many bytes into one group (trades read
    amplification for fewer seeks); gap bytes are never copied to the output.
    """
    rows = index.var_rows(var)
    dtype = index.var_dtype(var)
    ndim = region.ndim
    t0 = time.perf_counter()
    if candidates is None:
        cand = index.spatial_index(var).query(region.lo, region.hi)
    else:
        # narrowing needs only the plain AABB test — don't force an index
        # build on paths that deliberately bypass it
        cand = np.asarray(candidates, dtype=np.int64)
        if cand.size:
            keep = aabb_mask(rows.los[cand], rows.his[cand],
                             np.asarray(region.lo, dtype=np.int64),
                             np.asarray(region.hi, dtype=np.int64))
            cand = np.sort(cand[keep])
    probe_seconds = time.perf_counter() - t0
    if cand.size == 0:
        return _empty_plan(var, region, dtype, ndim, probe_seconds)

    t1 = time.perf_counter()
    itemsize = dtype.itemsize
    los = rows.los[cand]
    his = rows.his[cand]
    rlo = np.asarray(region.lo, dtype=np.int64)
    rhi = np.asarray(region.hi, dtype=np.int64)
    ilo = np.maximum(los, rlo)
    ihi = np.minimum(his, rhi)
    shape = his - los
    ishape = ihi - ilo

    # row-major element strides: strides[:, d] = prod(shape[:, d+1:])
    strides = np.ones_like(shape)
    if ndim > 1:
        strides[:, :-1] = np.cumprod(shape[:, :0:-1], axis=1)[:, ::-1]
    first = ((ilo - los) * strides).sum(axis=1)
    last = ((ihi - 1 - los) * strides).sum(axis=1)
    file_lo = rows.offsets[cand] + first * itemsize
    file_hi = rows.offsets[cand] + (last + 1) * itemsize

    # exact per-chunk contiguous runs: the trailing fully-covered suffix
    # coalesces with the last partially-covered axis; axes before multiply
    neq = ishape != shape
    any_neq = neq.any(axis=1)
    kidx = ndim - 1 - np.argmax(neq[:, ::-1], axis=1)   # last partial axis
    cum = np.cumprod(ishape, axis=1)
    prefix = np.take_along_axis(cum, np.maximum(kidx - 1, 0)[:, None],
                                axis=1)[:, 0]
    chunk_runs = np.where(any_neq & (kidx > 0), prefix, 1).astype(np.int64)
    bytes_per = cum[:, -1] * itemsize

    codecs = rows.codecs[cand]
    comp = codecs != 0
    if comp.any():
        # a compressed extent can only be decoded whole: the needed span IS
        # the stored extent (one contiguous run), whatever the intersection
        file_lo = np.where(comp, rows.offsets[cand], file_lo)
        file_hi = np.where(comp, rows.offsets[cand] + rows.nbytes[cand],
                           file_hi)
        chunk_runs = np.where(comp, 1, chunk_runs)

    subf = rows.subfiles[cand]
    order = np.lexsort((file_lo, subf))
    cand = cand[order]
    los, his, ilo, ihi = los[order], his[order], ilo[order], ihi[order]
    strides = strides[order]
    subf, file_lo, file_hi = subf[order], file_lo[order], file_hi[order]
    chunk_runs, bytes_per = chunk_runs[order], bytes_per[order]
    codecs = codecs[order]

    m = cand.size
    new_group = np.empty(m, dtype=bool)
    new_group[0] = True
    if m > 1:
        new_group[1:] = ((subf[1:] != subf[:-1])
                         | (file_lo[1:] > file_hi[:-1] + coalesce_gap))
        # a chunk's LAST run always ends at its file_hi and the next chunk's
        # FIRST run starts at its file_lo, so byte-adjacent extents merge one
        # run regardless of how many runs each chunk has internally
        adjacent = (~new_group[1:]) & (file_lo[1:] == file_hi[:-1])
        runs = int(chunk_runs.sum() - adjacent.sum())
    else:
        runs = int(chunk_runs.sum())
    group_bounds = np.concatenate(
        (np.flatnonzero(new_group), [m])).astype(np.int64)
    span_bytes = int((file_hi[group_bounds[1:] - 1]
                      - file_lo[group_bounds[:-1]]).sum())

    plan = ReadPlan(
        var=var, region=region, dtype=dtype, rec_ids=rows.ids[cand],
        chunk_los=los, chunk_his=his, inter_los=ilo, inter_his=ihi,
        strides=strides, subfiles=subf,
        extent_offsets=rows.offsets[cand], extent_nbytes=rows.nbytes[cand],
        file_lo=file_lo, file_hi=file_hi, chunk_runs=chunk_runs,
        group_bounds=group_bounds, runs=runs,
        bytes_needed=int(bytes_per.sum()), span_bytes=span_bytes,
        probe_seconds=probe_seconds,
        plan_seconds=time.perf_counter() - t1,
        codecs=codecs if comp.any() else None)
    return plan


def build_span_plan(var: str, subfiles: np.ndarray, file_lo: np.ndarray,
                    file_hi: np.ndarray) -> ReadPlan:
    """A :class:`ReadPlan` over raw *byte spans* instead of array geometry.

    Given disjoint byte spans, it builds a 1-D ``uint8`` plan whose output
    array is the flat concatenation of the spans, in row order.  Any
    :class:`~repro_torch.io.engine.IOEngine` executes it unchanged — one
    contiguous transfer per span, the overlapped engine at depth — and the
    caller then takes the stored extents out of the flat buffer without
    further I/O (the whole-variable read to the card does exactly this).
    """
    subfiles = np.asarray(subfiles, dtype=np.int64)
    file_lo = np.asarray(file_lo, dtype=np.int64)
    file_hi = np.asarray(file_hi, dtype=np.int64)
    m = len(subfiles)
    sizes = file_hi - file_lo
    total = int(sizes.sum())
    region = Block((0,), (max(1, total),))
    if m == 0:
        return _empty_plan(var, region, np.dtype(np.uint8), 1, 0.0)
    # flat-buffer positions: span i occupies out[prefix[i]:prefix[i]+size]
    prefix = np.cumsum(sizes) - sizes
    inter_los = prefix[:, None]
    inter_his = (prefix + sizes)[:, None]
    return ReadPlan(
        var=var, region=region, dtype=np.dtype(np.uint8),
        rec_ids=np.arange(m, dtype=np.int64),
        chunk_los=inter_los, chunk_his=inter_his,
        inter_los=inter_los, inter_his=inter_his,
        strides=np.ones((m, 1), dtype=np.int64),
        subfiles=subfiles, extent_offsets=file_lo, extent_nbytes=sizes,
        file_lo=file_lo, file_hi=file_hi,
        chunk_runs=np.ones(m, dtype=np.int64),
        group_bounds=np.arange(m + 1, dtype=np.int64),
        runs=m, bytes_needed=total, span_bytes=total)


@dataclasses.dataclass
class WritePlan:
    """Explicit extent list for writing one variable, in execution order.

    The write-side mirror of :class:`ReadPlan`: all per-extent arrays are
    row-aligned and sorted by ``(subfile, file_lo)``; ``group_bounds``
    delimits coalesced groups of byte-adjacent extents (one
    ``pwritev``-style vectored write each).  Append offsets — including any
    alignment padding — are assigned here, at plan time; executors never do
    offset arithmetic.

    ``chunk_ids[row]`` is the index into ``layout.chunks`` whose assembled
    buffer plan row ``row`` writes, so executors can pair buffers (built in
    layout order) with extents (sorted for sequential access).
    """

    var: str
    layout: LayoutPlan
    dtype: np.dtype
    chunk_ids: np.ndarray      # (m,) rows into layout.chunks, execution order
    chunk_los: np.ndarray      # (m,d) cuboid each extent covers
    chunk_his: np.ndarray
    writers: np.ndarray        # (m,) logical writer of each extent
    subfiles: np.ndarray       # (m,)
    file_lo: np.ndarray        # (m,) aligned absolute start offset
    file_hi: np.ndarray        # (m,) end of extent (file_lo + nbytes)
    nbytes: np.ndarray         # (m,) extent sizes
    group_bounds: np.ndarray   # (g+1,) coalesced byte-adjacent groups
    file_sizes: dict           # subfile -> required end size after this plan
    align: int | None
    bytes_total: int           # payload bytes (no padding)
    span_bytes: int            # bytes spanned if every group is one write
    plan_seconds: float = 0.0

    @property
    def strategy(self) -> str:
        return self.layout.strategy

    @property
    def global_shape(self) -> tuple:
        return self.layout.global_shape

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_ids)

    @property
    def num_groups(self) -> int:
        return len(self.group_bounds) - 1


def build_write_plan(layout: LayoutPlan, var: str, dtype,
                     align: int | None = None,
                     base_offsets: dict | None = None,
                     sizes: np.ndarray | None = None) -> WritePlan:
    """Plan the write of ``var`` under ``layout``.

    ``base_offsets`` maps subfile -> first free byte (log-structured append
    past existing extents; empty/missing means a fresh subfile).  Extents
    are laid out in ``layout.chunks`` order per subfile — each start offset
    aligned up to ``align`` — then sorted by ``(subfile, offset)`` and
    coalesced: consecutive extents with no padding gap form one group.

    ``sizes`` — optional per-chunk STORED byte sizes in ``layout.chunks``
    order, overriding the dense ``volume * itemsize`` default.  Compressed
    writers pass the encoded lengths here: append offsets depend on them,
    so encoding happens *before* planning and the plan stays pure metadata.
    """
    t0 = time.perf_counter()
    dtype = np.dtype(dtype)
    m = layout.num_chunks
    ndim = len(layout.global_shape)
    if m == 0:
        z = np.empty(0, dtype=np.int64)
        z2 = np.empty((0, ndim), dtype=np.int64)
        return WritePlan(var=var, layout=layout, dtype=dtype, chunk_ids=z,
                         chunk_los=z2, chunk_his=z2, writers=z, subfiles=z,
                         file_lo=z, file_hi=z, nbytes=z,
                         group_bounds=np.zeros(1, dtype=np.int64),
                         file_sizes={}, align=align, bytes_total=0,
                         span_bytes=0,
                         plan_seconds=time.perf_counter() - t0)

    los = np.asarray([cp.chunk.lo for cp in layout.chunks], dtype=np.int64)
    his = np.asarray([cp.chunk.hi for cp in layout.chunks], dtype=np.int64)
    writers = np.asarray([cp.writer for cp in layout.chunks], dtype=np.int64)
    subf = np.asarray([cp.subfile for cp in layout.chunks], dtype=np.int64)
    if sizes is None:
        nbytes = (his - los).prod(axis=1) * dtype.itemsize
    else:
        nbytes = np.asarray(sizes, dtype=np.int64)
        if nbytes.shape != (m,):
            raise ValueError(f"sizes must be one stored size per chunk "
                             f"({m} chunks, got shape {nbytes.shape})")

    # Append-order offsets, vectorized per subfile: every extent start is
    # aligned, so within a subfile the starts are an exclusive prefix sum of
    # the aligned sizes on top of the (aligned-up) base offset.
    a = int(align) if align else 1
    aligned_nb = -(-nbytes // a) * a
    stable = np.argsort(subf, kind="stable")   # groups subfiles, keeps order
    s_sorted = subf[stable]
    seg_first = np.flatnonzero(np.concatenate(
        ([True], s_sorted[1:] != s_sorted[:-1])))
    cs = np.cumsum(aligned_nb[stable]) - aligned_nb[stable]   # exclusive
    seg_id = np.cumsum(np.concatenate(
        ([0], (s_sorted[1:] != s_sorted[:-1]).astype(np.int64))))
    base = np.zeros(len(seg_first), dtype=np.int64)
    if base_offsets:
        for i, f in enumerate(seg_first):
            base[i] = align_up(int(base_offsets.get(int(s_sorted[f]), 0)),
                               align)
    starts_sorted = base[seg_id] + (cs - cs[seg_first][seg_id])
    file_lo = np.empty(m, dtype=np.int64)
    file_lo[stable] = starts_sorted
    file_hi = file_lo + nbytes

    order = np.lexsort((file_lo, subf))
    subf_o = subf[order]
    lo_o, hi_o = file_lo[order], file_hi[order]

    new_group = np.empty(m, dtype=bool)
    new_group[0] = True
    if m > 1:
        new_group[1:] = (subf_o[1:] != subf_o[:-1]) | (lo_o[1:] > hi_o[:-1])
    group_bounds = np.concatenate(
        (np.flatnonzero(new_group), [m])).astype(np.int64)
    span_bytes = int((hi_o[group_bounds[1:] - 1]
                      - lo_o[group_bounds[:-1]]).sum())
    file_sizes = {}
    for g in range(len(group_bounds) - 1):
        sf = int(subf_o[group_bounds[g]])
        file_sizes[sf] = max(file_sizes.get(sf, 0),
                             int(hi_o[group_bounds[g + 1] - 1]))

    return WritePlan(
        var=var, layout=layout, dtype=dtype, chunk_ids=order,
        chunk_los=los[order], chunk_his=his[order], writers=writers[order],
        subfiles=subf_o, file_lo=lo_o, file_hi=hi_o, nbytes=nbytes[order],
        group_bounds=group_bounds, file_sizes=file_sizes, align=align,
        bytes_total=int(nbytes.sum()), span_bytes=span_bytes,
        plan_seconds=time.perf_counter() - t0)


def subset_write_plan(plan: WritePlan, rows) -> WritePlan:
    """A :class:`WritePlan` covering only plan rows ``rows`` of ``plan``.

    Every extent keeps the byte offsets the full plan assigned it — the
    subset executes a *slice* of the same on-disk layout, which is what lets
    independent workers write disjoint parts of one destination and still
    converge bit-identically to a single-process write.  Group bounds are
    recomputed over the selected rows (two extents adjacent in the full plan
    stay coalesced only if both are selected); ``file_sizes`` shrinks to
    what the selected extents need, so executing a subset never truncates or
    grows a subfile past its own rows' requirements.
    """
    t0 = time.perf_counter()
    rows = np.unique(np.asarray(rows, dtype=np.int64))
    if rows.size and (rows[0] < 0 or rows[-1] >= plan.num_chunks):
        raise IndexError(f"subset rows out of range for a "
                         f"{plan.num_chunks}-extent plan")
    subf = plan.subfiles[rows]
    lo = plan.file_lo[rows]
    hi = plan.file_hi[rows]
    m = len(rows)
    if m == 0:
        group_bounds = np.zeros(1, dtype=np.int64)
        span_bytes = 0
        file_sizes: dict = {}
    else:
        new_group = np.empty(m, dtype=bool)
        new_group[0] = True
        if m > 1:
            new_group[1:] = (subf[1:] != subf[:-1]) | (lo[1:] > hi[:-1])
        group_bounds = np.concatenate(
            (np.flatnonzero(new_group), [m])).astype(np.int64)
        span_bytes = int((hi[group_bounds[1:] - 1]
                          - lo[group_bounds[:-1]]).sum())
        file_sizes = {}
        for g in range(len(group_bounds) - 1):
            sf = int(subf[group_bounds[g]])
            file_sizes[sf] = max(file_sizes.get(sf, 0),
                                 int(hi[group_bounds[g + 1] - 1]))
    return WritePlan(
        var=plan.var, layout=plan.layout, dtype=plan.dtype,
        chunk_ids=plan.chunk_ids[rows], chunk_los=plan.chunk_los[rows],
        chunk_his=plan.chunk_his[rows], writers=plan.writers[rows],
        subfiles=subf, file_lo=lo, file_hi=hi, nbytes=plan.nbytes[rows],
        group_bounds=group_bounds, file_sizes=file_sizes, align=plan.align,
        bytes_total=int(plan.nbytes[rows].sum()), span_bytes=span_bytes,
        plan_seconds=time.perf_counter() - t0)
