"""Chunk assembly and whole-variable linearization on the card: the glue
between the kernels and the container.

**Write** (:func:`assemble_chunks`, which ``Dataset.write_planned`` calls
when the data are tensors):

* a 2-D layout whose chunks are the cells of an even grid (``reorganized``
  with a scheme that divides the shape) over blocks that tile the domain
  runs ``pack_rows`` from the blocks into the row-major field, then
  ``rowmajor_to_chunked``: chunk ``(i, j)`` is then one contiguous slice.
  This holds whether or not the chunk edges fall on block edges;
* any other layout, at any rank, fills each chunk from its sources'
  intersections (:func:`~repro_torch.kernels.ref.chunk_row_tables`,
  lowered once a layout by the session's :class:`LayoutTables`): ONE
  ``pack_rows`` launch over all chunks of the write.  Rows of a chunk no
  source covers are zero;
* what is left for the host (the blocks' bytes, then the JAX package's
  ``assemble_chunk``) is a layout in which two sources of one chunk
  overlap: there the reference's source order decides which bytes win.

The blocks enter the kernel flat, back to back; a lone contiguous source
(an unsharded checkpoint leaf) enters as it is, uncopied.  The assembled
chunks then cross to pinned host memory in one copy, and the engine writes
them as the JAX package would: same bytes, same index.

**Read** (:func:`read_linearized`, for ``Dataset.read`` of a whole
variable): the engine reads every stored extent into one pinned flat
buffer (a span plan), which is copied to the card once; a 2-D even chunk
grid is then linearized with ``chunked_to_rowmajor``, any other layout
whose chunks tile the domain with ``pack_rows`` (the stored chunks as the
blocks of one whole-domain cluster).

**Region read** (:func:`read_regions`, for ``Dataset.read`` of a part of
a variable, any other whole-variable read of raw chunks, the checkpoint
manager's restore onto a new decomposition, ``Dataset.read_decomposed``'s
readers and ``reorganize``'s new chunks): the read plans of all target
regions are lowered together to one set of row tables
(:func:`~repro_torch.kernels.ref.region_row_tables`); the engine reads
each touched extent's needed bytes once, into one pinned flat buffer,
which crosses to the card in one copy, and ONE ``pack_rows`` launch
gathers every target.  Compressed chunks take the host ``read_planned``
followed by one copy to the device.

**Threads and streams.** Every copy between the host and the card passes
through the session's :class:`PinnedStaging`, which keeps one grow-only
pinned buffer for each thread that copies (a staging worker, a reader), so
no view is ever shared across threads.  Each copy through it is
synchronous, so a thread's view is free again when its call returns; a
write's view is handed to the engine and the checksums, and that thread
takes no other view before ``write_planned`` returns.  Device work runs on
the calling thread's current stream, and every wait here is on that
stream (:func:`_sync`), never on the whole device: a staging worker on its
own stream does not wait for the producer's kernels.

The route depends only on the layout and the region — never on a failure:
a kernel that fails raises.  Tensors on the CPU take the same route, with
the kernels' plain versions, which is how the tests cover this module.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Mapping

import numpy as np
import torch

from ..core.blocks import Block
from ..core.clustering import Cluster
from ..core.layouts import LayoutPlan
from ..core.merge import plan_from_clusters
from ..interop import to_numpy
from ..kernels.ops import pack_tables
from ..kernels.ref import (chunk_row_tables, plan_row_tables,
                           region_row_tables)
from ..kernels.relayout import chunked_to_rowmajor, rowmajor_to_chunked
from .engine import assemble_chunk
from .format import DatasetIndex
from .planner import build_read_plan, build_span_plan

__all__ = ["PinnedStaging", "LayoutTables", "GATHER_BATCH_BYTES",
           "assemble_chunks",
           "read_route", "read_linearized", "read_regions", "gather_regions",
           "gather_batches", "to_host"]

#: the most bytes of target chunks ``reorganize`` gathers in one
#: :func:`gather_regions` call.  A batch holds its engine span and its
#: gathered chunks on the card and in two sessions' pinned staging buffers
#: at once, so this bounds the pinned host memory (which the allocator
#: rounds up to a power of two) and the card memory a reorganization takes
#: whatever the variable's size; at 1 GiB each batch's fixed costs (one
#: engine call, one copy each way, one launch: milliseconds) stay well
#: under 1% of its transfers.
GATHER_BATCH_BYTES = 1 << 30


def gather_batches(layout: LayoutPlan, itemsize: int) -> list:
    """``layout.chunks`` positions in order, cut into runs of whole chunks
    of at most :data:`GATHER_BATCH_BYTES` each (a larger chunk alone): the
    batches ``reorganize`` gathers, one :func:`gather_regions` call each."""
    out, cur, size = [], [], 0
    for i, cp in enumerate(layout.chunks):
        nbytes = cp.chunk.volume * itemsize
        if cur and size + nbytes > GATHER_BATCH_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    return out + [cur] if cur else out


class PinnedStaging:
    """A session's grow-only pinned host buffers, one for each thread that
    copies between the host and the card (pinned memory is slow to
    allocate: tens of milliseconds for tens of MB).  :meth:`take` hands the
    calling thread a view of the first ``nbytes`` of its own buffer; the
    view is valid until that thread's next :meth:`take`."""

    def __init__(self):
        self._bufs: dict = {}                 # thread ident -> buffer
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        key = threading.get_ident()
        with self._lock:
            buf = self._bufs.get(key)
            if buf is not None and buf.numel() < nbytes:
                del self._bufs[key]           # free before growing
                buf = None
        if buf is None:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            with self._lock:
                self._bufs[key] = buf
        return buf[:nbytes]

    def buffer(self) -> torch.Tensor | None:
        """The calling thread's buffer (None before its first take)."""
        with self._lock:
            return self._bufs.get(threading.get_ident())

    def release(self) -> None:
        with self._lock:
            self._bufs.clear()


def _host_bytes(nbytes: int, device: torch.device,
                staging: PinnedStaging | None) -> torch.Tensor:
    """``nbytes`` of host memory for a copy to ``device``: a view of the
    session's pinned staging buffer for a CUDA device, else fresh memory
    (on the CPU no copy follows)."""
    if device.type == "cuda" and staging is not None:
        return staging.take(nbytes)
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _grid(shape: tuple, los: np.ndarray, his: np.ndarray):
    """``(ch, cw)`` when the boxes ``[los, his)`` are exactly the cells of
    an even 2-D grid over ``shape``; else None."""
    if len(shape) != 2 or not len(los):
        return None
    ch, cw = (int(v) for v in his[0] - los[0])
    if shape[0] % ch or shape[1] % cw:
        return None
    n_i, n_j = shape[0] // ch, shape[1] // cw
    if len(los) != n_i * n_j or ((his - los) != (ch, cw)).any() \
            or (los % (ch, cw)).any():
        return None
    cells = (los[:, 0] // ch) * n_j + los[:, 1] // cw
    if np.unique(cells).size != n_i * n_j:
        return None
    return ch, cw


def _row_counts(dst_rows: np.ndarray, n: int) -> np.ndarray:
    """How many table entries name each of the ``n`` destination rows (the
    rows lie in ``[0, n)``, as ``pack_tables`` checks)."""
    return np.bincount(dst_rows, minlength=n) if n else np.zeros(0, np.int64)


def _lower(plan):
    """Row tables of ``plan``, or None unless its destination rows are
    covered exactly once (the sources tile the clusters): ``pack_tables``
    then leaves the output unfilled."""
    tables = plan_row_tables(plan)
    width, _, dst_rows, total, _ = tables
    n = total // width
    if len(dst_rows) != n or \
            (n and (dst_rows.min() < 0 or dst_rows.max() >= n)) or \
            (n and _row_counts(dst_rows, n).max() != 1):
        return None
    return tables


class LayoutTables:
    """A session's row tables of the layouts it writes
    (:func:`~repro_torch.kernels.ref.chunk_row_tables` and each
    destination row's count), lowered once a layout while the layout lives:
    a staging executor writes the same layout every output step.
    Thread-safe; concurrent writers of one layout share one lowering."""

    def __init__(self):
        self._tables = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def get(self, layout: LayoutPlan) -> tuple:
        with self._lock:
            got = self._tables.get(layout)
            if got is None:
                tables = chunk_row_tables(layout)
                width, _, dst_rows, total, _ = tables
                got = self._tables[layout] = (
                    tables, _row_counts(dst_rows, total // width))
            return got


def _sync(dev: torch.device) -> None:
    """Wait for the calling thread's current stream on ``dev`` (never the
    whole device)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def to_host(flat: torch.Tensor,
            staging: PinnedStaging | None = None) -> np.ndarray:
    """One synchronous copy of the 1-D ``flat`` to host memory (for CUDA,
    ``staging``'s pinned buffer, or fresh pinned memory without one);
    a CPU tensor's own memory."""
    if flat.device.type == "cpu":
        return to_numpy(flat)
    host = _host_bytes(flat.numel() * flat.element_size(), flat.device,
                       staging).view(flat.dtype)
    host.copy_(flat)
    return host.numpy()


def _flat_sources(ts: list) -> torch.Tensor:
    """The tensors ``ts`` flat, back to back: a view when they already lie
    so in one tensor's memory (a lone contiguous block, or a staging
    snapshot), else one copy."""
    first = ts[0]
    ptr, nb = first.data_ptr(), first.element_size()
    base = first.untyped_storage().data_ptr()
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() != ptr \
                or t.untyped_storage().data_ptr() != base:
            return torch.cat([t.reshape(-1) for t in ts])
        ptr += t.numel() * nb
    return first.as_strided((sum(t.numel() for t in ts),), (1,))


def assemble_chunks(layout: LayoutPlan, data: Mapping[int, torch.Tensor],
                    dtype, staging: PinnedStaging | None = None,
                    lowered: LayoutTables | None = None) -> tuple:
    """The chunk buffers of ``layout`` (host ndarrays, ``layout.chunks``
    order; views of ``staging`` on the device route) from block tensors,
    and the stage times ``{"lower", "kernel", "d2h"}`` of the device route
    ({} on the host route).  ``lowered``: the session's lowered layouts."""
    dtype = np.dtype(dtype)
    want = _torch_dtype(dtype)
    sources = {s.block_id: s for cp in layout.chunks for s in cp.sources}
    devices = set()
    for bid, blk in sources.items():
        t = data[bid]
        if t.dtype != want or tuple(t.shape) != blk.shape:
            raise ValueError(f"block {bid}: tensor {t.dtype} "
                             f"{tuple(t.shape)}, layout wants {want} "
                             f"{blk.shape}")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"block tensors lie on several devices: {devices}")
    dev = devices.pop()

    t0 = time.perf_counter()
    shape = layout.global_shape
    domain = Block((0,) * len(shape), tuple(shape))
    los = np.asarray([cp.chunk.lo for cp in layout.chunks], dtype=np.int64)
    his = np.asarray([cp.chunk.hi for cp in layout.chunks], dtype=np.int64)
    tables = None
    grid = _grid(tuple(shape), los, his)
    if grid is not None and all(domain.contains(b)
                                for b in sources.values()):
        order = sorted(sources)
        tables = _lower(plan_from_clusters(
            [Cluster(domain, tuple(sources[b] for b in order))]))
        covered = True
        ch, cw = grid
        n_j = shape[1] // cw
        offsets = ((los[:, 0] // ch) * n_j + los[:, 1] // cw) * ch * cw
    if tables is None:
        grid = None
        tables, counts = (lowered or LayoutTables()).get(layout)
        order = tables[4]
        if counts.size and counts.max() > 1:
            host = {bid: to_numpy(data[bid]) for bid in sources}
            return [assemble_chunk(cp, host, dtype)
                    for cp in layout.chunks], {}
        covered = bool(counts.size) and counts.min() == 1
        vol = np.prod(his - los, axis=1)
        offsets = np.cumsum(vol) - vol
    t1 = time.perf_counter()

    flat_src = _flat_sources([data[b] for b in order])
    flat = pack_tables(flat_src, tables, _covered=covered)
    del flat_src                  # a copy of the blocks goes back at once
    if grid is not None:
        flat = rowmajor_to_chunked(flat.view(tuple(shape)),
                                   chunk=grid).reshape(-1)
    _sync(dev)
    t2 = time.perf_counter()
    host = to_host(flat, staging)
    t3 = time.perf_counter()
    bufs = [host[int(o):int(o) + cp.chunk.volume].reshape(cp.chunk.shape)
            for o, cp in zip(offsets, layout.chunks)]
    return bufs, {"lower": t1 - t0, "kernel": t2 - t1, "d2h": t3 - t2}


def read_route(index: DatasetIndex, var: str, region: Block):
    """How a read of ``region`` reaches the card: ``("relayout", (ch,
    cw))`` or ``("pack", None)`` for a whole-variable read of raw chunks
    that tile the domain, ``("region", None)`` for any other read of raw
    chunks, else None (compressed chunks: host read, then one copy)."""
    rows = index.var_rows(var)
    if rows.n == 0 or rows.codecs.any():
        return None
    shape = index.var_shape(var)
    if tuple(region.lo) != (0,) * len(shape) or tuple(region.hi) != shape:
        return ("region", None)
    vol = np.prod(rows.his - rows.los, axis=1)
    if (rows.los < 0).any() or (rows.his > np.asarray(shape)).any() \
            or int(vol.sum()) != int(np.prod(shape)) \
            or (rows.nbytes != vol * index.var_dtype(var).itemsize).any():
        return ("region", None)
    grid = _grid(shape, rows.los, rows.his)
    return ("relayout", grid) if grid is not None else ("pack", None)


def read_linearized(ds, var: str, route, device: torch.device,
                    engine=None):
    """Read ``var`` whole onto ``device`` along ``route`` (from
    :func:`read_route`).  Returns ``(tensor, ReadStats)``, or None when
    the stored chunks turn out not to tile the domain exactly.  The engine
    read is ``ds.read_planned`` of the span plan, so ``engine="auto"`` is
    resolved on the shape of that plan, the one executed."""
    t0 = time.perf_counter()
    index = ds.index
    shape = index.var_shape(var)
    dtype = index.var_dtype(var)
    rows = index.var_rows(var)
    kind, grid = route
    if kind == "relayout":
        ch, cw = grid
        order = np.argsort((rows.los[:, 0] // ch) * (shape[1] // cw)
                           + rows.los[:, 1] // cw)
    else:
        order = np.lexsort((rows.offsets, rows.subfiles))
        blocks = tuple(Block(tuple(int(v) for v in rows.los[k]),
                             tuple(int(v) for v in rows.his[k]),
                             block_id=pos)
                       for pos, k in enumerate(order))
        tables = _lower(plan_from_clusters(
            [Cluster(Block((0,) * len(shape), shape), blocks)]))
        if tables is None:
            return None
    file_lo = rows.offsets[order]
    span = build_span_plan(var, rows.subfiles[order], file_lo,
                           file_lo + rows.nbytes[order])
    lower_seconds = time.perf_counter() - t0

    host = _host_bytes(int(rows.nbytes.sum()), device, ds._staging)
    _, stats = ds.read_planned(span, out=host.numpy(), engine=engine)
    t1 = time.perf_counter()
    flat = host.to(device).view(_torch_dtype(dtype))
    t2 = time.perf_counter()
    if kind == "relayout":
        n_i, n_j = shape[0] // ch, shape[1] // cw
        out = chunked_to_rowmajor(flat.view(n_i, n_j, ch, cw), chunk=grid)
    else:
        out = pack_tables(flat, tables, _covered=True).view(shape)
    _sync(device)
    stats.lower_seconds = lower_seconds
    stats.h2d_seconds = t2 - t1
    stats.linearize_seconds = time.perf_counter() - t2
    return out, stats


def read_regions(ds, var: str, regions, device: torch.device, engine=None,
                 candidates: np.ndarray | None = None, plans=None):
    """Read ``regions`` of ``var`` (raw chunks) onto ``device`` through one
    engine read, one copy to the device and one ``pack_rows`` launch
    (:func:`gather_regions`).  Returns ``([tensor per region],
    ReadStats)``, the tensors views of one output buffer, or None when
    stored chunks overlap (a destination row named twice: the host plan
    decides which bytes win)."""
    got = gather_regions(ds, var, regions, device, engine=engine,
                         candidates=candidates, plans=plans)
    if got is None:
        return None
    out, stats = got
    views, pos = [], 0
    for r in regions:
        views.append(out[pos:pos + r.volume].view(r.shape))
        pos += r.volume
    return views, stats


def gather_regions(ds, var: str, regions, device: torch.device,
                   engine=None, candidates: np.ndarray | None = None,
                   plans=None):
    """:func:`read_regions`' gather: ``(flat, ReadStats)`` with ``flat``
    the regions row-major, back to back in ``regions`` order, on
    ``device``; or None when stored chunks overlap.

    The engine read is ``ds.read_planned`` of the span plan of the touched
    extents, so ``engine="auto"`` is resolved on the shape of that plan,
    the one executed.  ``bytes_read`` and ``chunks_touched`` are the host
    plans' (summed over the regions); ``runs`` and ``groups`` are this
    route's own: the span plan's extents, each read once.  Output rows no
    stored chunk covers are zero (``pack_tables`` fills the output unless
    every row is covered).  ``seconds`` is the engine's.  ``plans``: the
    regions' read plans, when the caller built them already."""
    t0 = time.perf_counter()
    index = ds.index
    dtype = index.var_dtype(var)
    if plans is None:
        plans = [build_read_plan(index, var, r, candidates=candidates)
                 for r in regions]
    tables = region_row_tables(plans)
    width, _, dst_rows, total, (subf, file_lo, file_hi) = tables
    n = total // width
    distinct = np.unique(dst_rows).size
    if distinct != len(dst_rows):
        return None
    span = build_span_plan(var, subf, file_lo, file_hi)
    lower_seconds = time.perf_counter() - t0

    host = _host_bytes(int((file_hi - file_lo).sum()), device, ds._staging)
    _, stats = ds.read_planned(span, out=host.numpy(), engine=engine)
    stats.bytes_read = sum(p.bytes_needed for p in plans)
    stats.chunks_touched = sum(p.num_chunks for p in plans)
    stats.probe_seconds = sum(p.probe_seconds for p in plans)
    stats.plan_seconds = sum(p.plan_seconds for p in plans)
    t1 = time.perf_counter()
    flat = host.to(device).view(_torch_dtype(dtype))
    t2 = time.perf_counter()
    out = pack_tables(flat, tables, _covered=distinct == n)
    _sync(device)
    stats.lower_seconds = lower_seconds
    stats.h2d_seconds = t2 - t1
    stats.linearize_seconds = time.perf_counter() - t2
    return out, stats
