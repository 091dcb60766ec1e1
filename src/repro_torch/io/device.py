"""Chunk assembly and whole-variable linearization on the card: the glue
between the kernels and the container.

**Write** (:func:`assemble_chunks`, which ``Dataset.write_planned`` calls
when the data are tensors):

* a 2-D layout whose chunks are the cells of an even grid (``reorganized``
  with a scheme that divides the shape) over blocks that tile the domain
  runs ``pack_rows`` from the blocks into the row-major field, then
  ``rowmajor_to_chunked``: chunk ``(i, j)`` is then one contiguous slice.
  This holds whether or not the chunk edges fall on block edges;
* any other layout whose every chunk is tiled exactly by its own sources
  (``merged_process``, ``merged_node``, ``chunked``, ``subfiled_*``) becomes
  one :class:`~repro_torch.core.merge.MergePlan` with each chunk a cluster
  and its sources the members — the layout's own clustering, never a new
  one — lowered to row tables and run as ONE ``pack_rows`` launch over all
  writers' chunks;
* any other layout (uneven grids, partial coverage) is assembled on the
  host from the blocks' bytes.

The assembled chunks then cross to pinned host memory in one copy, and the
engine writes them as the JAX package would: same bytes, same index.

**Read** (:func:`read_linearized`, for ``Dataset.read`` of a whole
variable): the engine reads every stored extent into one pinned flat
buffer (a span plan), which is copied to the card once; a 2-D even chunk
grid is then linearized with ``chunked_to_rowmajor``, any other layout
whose chunks tile the domain with ``pack_rows`` (the stored chunks as the
blocks of one whole-domain cluster).

**Region read** (:func:`read_regions`, for ``Dataset.read`` of a part of
a variable, any other whole-variable read of raw chunks, and the
checkpoint manager's restore onto a new decomposition): the read plans of
all target regions are lowered together to one set of row tables
(:func:`~repro_torch.kernels.ref.region_row_tables`); the engine reads
each touched extent's needed bytes once, into one pinned flat buffer,
which crosses to the card in one copy, and ONE ``pack_rows`` launch
gathers every target.  Compressed chunks take the host ``read_planned``
followed by one copy to the device.

The route depends only on the layout and the region — never on a failure:
a kernel that fails raises.  Tensors on the CPU take the same route, with
the kernels' plain versions, which is how the tests cover this module.
"""

from __future__ import annotations

import time
from typing import Mapping

import numpy as np
import torch

from ..core.blocks import Block
from ..core.clustering import Cluster
from ..core.layouts import LayoutPlan
from ..core.merge import plan_from_clusters
from ..interop import to_numpy
from ..kernels.ops import pack_tables
from ..kernels.ref import plan_row_tables, region_row_tables
from ..kernels.relayout import chunked_to_rowmajor, rowmajor_to_chunked
from .engine import assemble_chunk
from .format import DatasetIndex
from .planner import build_read_plan, build_span_plan

__all__ = ["assemble_chunks", "read_route", "read_linearized",
           "read_regions"]


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


def _lower(plan):
    """Row tables of ``plan``, or None unless its destination rows are
    covered exactly once (the sources tile the clusters): ``pack_tables``
    then leaves the output unfilled."""
    tables = plan_row_tables(plan)
    width, _, dst_rows, total, _ = tables
    n = total // width
    if len(dst_rows) != n or np.unique(dst_rows).size != n or \
            (n and (dst_rows.min() < 0 or dst_rows.max() >= n)):
        return None
    return tables


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_host(flat: torch.Tensor) -> np.ndarray:
    """One copy of ``flat`` to (pinned, for CUDA) host memory."""
    if flat.device.type == "cpu":
        return to_numpy(flat)
    host = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=True)
    host.copy_(flat)
    return host.numpy()


def assemble_chunks(layout: LayoutPlan, data: Mapping[int, torch.Tensor],
                    dtype) -> tuple:
    """The chunk buffers of ``layout`` (host ndarrays, ``layout.chunks``
    order) from block tensors, and the stage times
    ``{"lower", "kernel", "d2h"}`` of the device route ({} on the host
    route)."""
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
        blocks = tuple(sources[b] for b in sorted(sources))
        tables = _lower(plan_from_clusters([Cluster(domain, blocks)]))
        ch, cw = grid
        n_j = shape[1] // cw
        offsets = ((los[:, 0] // ch) * n_j + los[:, 1] // cw) * ch * cw
    elif all(cp.chunk.contains(s) for cp in layout.chunks
             for s in cp.sources):
        grid = None
        tables = _lower(plan_from_clusters(
            [Cluster(cp.chunk, tuple(cp.sources)) for cp in layout.chunks]))
        offsets = np.cumsum(np.prod(his - los, axis=1)) - \
            np.prod(his - los, axis=1)
    if tables is None:
        host = {bid: to_numpy(data[bid]) for bid in sources}
        return [assemble_chunk(cp, host, dtype) for cp in layout.chunks], {}
    t1 = time.perf_counter()

    flat = pack_tables(torch.cat([data[b].reshape(-1)
                                  for b in sorted(sources)]), tables,
                       _covered=True)
    if grid is not None:
        flat = rowmajor_to_chunked(flat.view(tuple(shape)),
                                   chunk=grid).reshape(-1)
    _sync(dev)
    t2 = time.perf_counter()
    host = _to_host(flat)
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
    the stored chunks turn out not to tile the domain exactly."""
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

    host = torch.empty(int(rows.nbytes.sum()), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
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
                 candidates: np.ndarray | None = None):
    """Read ``regions`` of ``var`` (raw chunks) onto ``device`` through one
    engine read, one copy to the device and one ``pack_rows`` launch.
    Returns ``([tensor per region], ReadStats)``, the tensors views of one
    output buffer, or None when stored chunks overlap (a destination row
    named twice: the host plan decides which bytes win).

    ``bytes_read`` and ``chunks_touched`` are the host plans' (summed over
    the regions); ``runs`` and ``groups`` are this route's own: the span
    plan's extents, each read once.  Output rows no stored chunk covers
    are zero (``pack_tables`` fills the output unless every row is
    covered)."""
    t0 = time.perf_counter()
    index = ds.index
    dtype = index.var_dtype(var)
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

    host = torch.empty(int((file_hi - file_lo).sum()), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
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
    views, pos = [], 0
    for r in regions:
        views.append(out[pos:pos + r.volume].view(r.shape))
        pos += r.volume
    return views, stats
