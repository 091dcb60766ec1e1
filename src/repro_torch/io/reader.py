"""Dataset session object: symmetric plan/execute I/O in both directions,
with the data on the card.

A :class:`Dataset` is the single handle on a dataset directory for writers
*and* readers — ``Dataset.create`` starts a new container, ``Dataset.open``
attaches to an existing one, and both directions go through the same
plan/engine split as the JAX package's session, on the same on-disk
format (a directory either package wrote opens under the other):

* **write** — ``plan_write`` turns a :class:`~repro_torch.core.layouts.
  LayoutPlan` into a :class:`~repro_torch.io.planner.WritePlan`;
  ``write_planned`` assembles the chunk buffers — on the card, through the
  copy kernels, when the data are tensors (:mod:`repro_torch.io.device`) —
  and hands the plan to the session's engine.  The index is committed only
  after every extent landed.
* **read** — ``plan_read`` + ``read_planned`` replay a region plan through
  the engine into a host array; ``read`` returns the region as a tensor on
  the session's device, linearizing whole variables and gathering parts
  of them on the card.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core.blocks import Block
from ..core.codecs import encode
from ..core.layouts import LayoutPlan
from ..device import resolve_device
from .device import (assemble_chunks, read_linearized, read_regions,
                     read_route)
from .engine import IOEngine, SubfileStore, WriteStats, assemble_chunk, \
    get_engine
from .format import ChunkRecord, DatasetIndex, extent_checksum
from .planner import ReadPlan, WritePlan, build_read_plan, build_write_plan

__all__ = ["ReadStats", "Dataset"]


@dataclasses.dataclass
class ReadStats:
    seconds: float = 0.0          # engine time
    bytes_read: int = 0
    chunks_touched: int = 0
    runs: int = 0                 # contiguous byte runs (cold-cache seeks)
    groups: int = 0               # coalesced grouped reads actually issued
    probe_seconds: float = 0.0    # spatial-index lookup time
    plan_seconds: float = 0.0     # extent planning time
    engine: str = ""              # engine that executed the plan
    #: why that engine: ``"pinned"`` when the caller named it; an
    #: ``engine="auto"`` decision record waits for the cost model (S1)
    engine_reason: str = ""
    #: ``Dataset.read`` only: lowering to row tables (device route), the
    #: one copy to the device, and the linearizing kernel
    lower_seconds: float = 0.0
    h2d_seconds: float = 0.0
    linearize_seconds: float = 0.0

    def merge(self, other: "ReadStats") -> None:
        """Add ``other``'s counts and stage seconds (not ``seconds``, which
        the caller sums, as the JAX package's callers do); engines that
        differ merge to ``"mixed"`` with both reasons kept."""
        self.bytes_read += other.bytes_read
        self.chunks_touched += other.chunks_touched
        self.runs += other.runs
        self.groups += other.groups
        self.probe_seconds += other.probe_seconds
        self.plan_seconds += other.plan_seconds
        self.lower_seconds += other.lower_seconds
        self.h2d_seconds += other.h2d_seconds
        self.linearize_seconds += other.linearize_seconds
        if not self.engine:
            self.engine = other.engine
            self.engine_reason = other.engine_reason
        elif other.engine:
            if other.engine != self.engine:
                self.engine = "mixed"
                self._merge_reason("per-plan auto decisions diverged")
            self._merge_reason(other.engine_reason)

    def _merge_reason(self, other_reason: str) -> None:
        parts = [p for p in self.engine_reason.split("; ") if p]
        for p in other_reason.split("; "):
            if p and p not in parts:
                parts.append(p)
        self.engine_reason = "; ".join(parts)

    @property
    def read_gbps(self) -> float:
        return self.bytes_read / max(self.seconds, 1e-12) / 1e9


class Dataset:
    """Read/write session on a dataset directory.

    ``Dataset(dir)`` attaches to an existing dataset (read paths work
    immediately, writes append); ``Dataset.create(dir)`` starts an empty
    one.  ``engine`` is ``"memmap"``, ``"pread"``,
    ``"overlapped"``/``"overlapped:<depth>"`` or an
    :class:`~repro_torch.io.engine.IOEngine` instance.  ``device`` is where
    :meth:`read` returns tensors: ``"cuda"`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, dirpath: str, engine: str | IOEngine = "memmap", *,
                 create: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.dirpath = dirpath
        self._engine = get_engine(engine)
        if create:
            self.index = DatasetIndex()
            os.makedirs(dirpath, exist_ok=True)
        else:
            self.index = DatasetIndex.load(dirpath)
        self._store = SubfileStore(dirpath)
        self._lock = threading.Lock()     # index mutation + append cursor
        self._cursor: dict | None = None  # subfile -> first free byte

    # -- session management --------------------------------------------------
    @classmethod
    def create(cls, dirpath: str, engine: str | IOEngine = "memmap",
               device="cuda") -> "Dataset":
        """Start a new (empty) dataset. ``index.json`` is not written until
        the first successful :meth:`write_planned` commit."""
        return cls(dirpath, engine, create=True, device=device)

    @classmethod
    def open(cls, dirpath: str, engine: str | IOEngine = "memmap",
             device="cuda") -> "Dataset":
        """Attach to an existing dataset directory."""
        return cls(dirpath, engine, device=device)

    @property
    def engine(self) -> str:
        """Name of the session's default engine."""
        return self._engine.name

    def flush(self) -> None:
        """Persist ``index.json`` (atomic replace)."""
        self.index.save(self.dirpath)

    def close(self) -> None:
        self._store.close()

    # -- write path ----------------------------------------------------------
    def _cursor_dict(self) -> dict:
        """subfile -> first free byte, log-structured append (lazy-built from
        the index, then maintained by :meth:`plan_write`). Caller holds the
        lock."""
        if self._cursor is None:
            cur: dict = {}
            for rec in self.index.chunks:
                end = rec.offset + rec.nbytes
                if end > cur.get(rec.subfile, 0):
                    cur[rec.subfile] = end
            self._cursor = cur
        return self._cursor

    def plan_write(self, var: str, layout: LayoutPlan, dtype,
                   align: int | None = None) -> WritePlan:
        """Plan (but do not execute) the append of ``var`` under ``layout``.
        Reserves the extents immediately."""
        with self._lock:
            cursor = self._cursor_dict()
            plan = build_write_plan(layout, var, dtype, align=align,
                                    base_offsets=cursor)
            for sf, end in plan.file_sizes.items():
                if end > cursor.get(sf, 0):
                    cursor[sf] = end
        return plan

    @staticmethod
    def _assemble(layout: LayoutPlan, data: Mapping, dtype) -> tuple:
        """Chunk buffers in ``layout.chunks`` order, and the device stage
        times: on the card when the data are tensors, else on the host."""
        if any(isinstance(v, torch.Tensor) for v in data.values()):
            return assemble_chunks(layout, data, dtype)
        return [assemble_chunk(cp, data, dtype) for cp in layout.chunks], {}

    def write_planned(self, plan: WritePlan, data: Mapping, *,
                      engine: str | IOEngine | None = None,
                      fsync: bool = False, flush: bool = True,
                      codec: str = "none",
                      encoded: Sequence[np.ndarray] | None = None
                      ) -> WriteStats:
        """Execute a write plan: assemble each chunk from its source blocks
        (``data``: block_id -> tensor or ndarray), run the engine over the
        extent groups, then commit the records.

        ``codec``/``encoded`` is the compressed-write contract: the caller
        passes the pre-encoded extent buffers (``layout.chunks`` order) and
        the codec they carry, and the plan was built with their sizes.
        """
        if codec != "none" and encoded is None:
            raise ValueError("codec != 'none' requires pre-encoded buffers "
                             "(use Dataset.write(..., codec=...))")
        eng = get_engine(engine) if engine is not None else self._engine
        t_start = time.perf_counter()

        t0 = time.perf_counter()
        stages = {}
        if encoded is None:
            encoded, stages = self._assemble(plan.layout, data, plan.dtype)
        buffers = [encoded[int(cid)] for cid in plan.chunk_ids]
        assemble_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        for sf, size in plan.file_sizes.items():
            self._store.ensure_size(sf, size)
        eng.write_plan(plan, buffers, self._store)
        if fsync:
            self._store.fsync()
        write_seconds = time.perf_counter() - t0

        # commit: records enter the index only after every extent landed
        with self._lock:
            if plan.var not in self.index.variables:
                self.index.add_variable(plan.var, plan.global_shape,
                                        plan.dtype, plan.strategy)
            for row in np.argsort(plan.chunk_ids):   # original layout order
                lbytes = None
                if codec != "none":
                    lbytes = int((plan.chunk_his[row]
                                  - plan.chunk_los[row]).prod()) \
                        * plan.dtype.itemsize
                self.index.chunks.append(ChunkRecord(
                    var=plan.var, lo=tuple(int(v) for v in plan.chunk_los[row]),
                    hi=tuple(int(v) for v in plan.chunk_his[row]),
                    subfile=int(plan.subfiles[row]),
                    offset=int(plan.file_lo[row]),
                    nbytes=int(plan.nbytes[row]),
                    checksum=extent_checksum(
                        np.ascontiguousarray(buffers[row])),
                    codec=codec, lbytes=lbytes))
            cursor = self._cursor_dict()
            for sf, end in plan.file_sizes.items():   # plans built directly
                if end > cursor.get(sf, 0):
                    cursor[sf] = end
            self.index.num_subfiles = max(self.index.num_subfiles,
                                          len(cursor))
            if flush:
                self.flush()

        return WriteStats(assemble_seconds=assemble_seconds,
                          write_seconds=write_seconds,
                          total_seconds=time.perf_counter() - t_start,
                          bytes_written=int(plan.bytes_total),
                          num_extents=plan.num_chunks,
                          num_subfiles=len(plan.file_sizes),
                          groups=plan.num_groups,
                          plan_seconds=plan.plan_seconds, engine=eng.name,
                          lower_seconds=stages.get("lower", 0.0),
                          kernel_seconds=stages.get("kernel", 0.0),
                          d2h_seconds=stages.get("d2h", 0.0))

    def write(self, var: str, layout: LayoutPlan, dtype, data: Mapping, *,
              align: int | None = None, fsync: bool = False,
              codec: str = "none") -> WriteStats:
        """Plan + execute in one call.  Argument order mirrors
        :meth:`plan_write`.  ``codec`` compresses every extent with the
        named codec from :mod:`repro_torch.core.codecs` (append offsets
        depend on the encoded sizes, so encoding happens before planning).
        """
        if codec == "none":
            return self.write_planned(self.plan_write(var, layout, dtype,
                                                      align=align),
                                      data, fsync=fsync)
        dtype = np.dtype(dtype)
        t0 = time.perf_counter()
        bufs, _ = self._assemble(layout, data, dtype)
        enc = [np.frombuffer(encode(codec, np.ascontiguousarray(b)),
                             dtype=np.uint8) for b in bufs]
        encode_seconds = time.perf_counter() - t0
        sizes = np.asarray([b.nbytes for b in enc], dtype=np.int64)
        with self._lock:
            cursor = self._cursor_dict()
            plan = build_write_plan(layout, var, dtype, align=align,
                                    base_offsets=cursor, sizes=sizes)
            for sf, end in plan.file_sizes.items():
                if end > cursor.get(sf, 0):
                    cursor[sf] = end
        wstats = self.write_planned(plan, data, fsync=fsync,
                                    codec=codec, encoded=enc)
        wstats.assemble_seconds += encode_seconds
        wstats.total_seconds += encode_seconds
        return wstats

    # -- read path -----------------------------------------------------------
    def plan_read(self, var: str, region: Block,
                  candidates: np.ndarray | None = None,
                  coalesce_gap: int = 0) -> ReadPlan:
        """Plan (but do not execute) a region read; see
        :func:`repro_torch.io.planner.build_read_plan`."""
        return build_read_plan(self.index, var, region,
                               candidates=candidates,
                               coalesce_gap=coalesce_gap)

    def read_planned(self, plan: ReadPlan, out: np.ndarray | None = None,
                     engine: str | IOEngine | None = None) -> tuple:
        """Execute a read plan into a host array.  Returns (array,
        ReadStats)."""
        if out is None:
            out = np.empty(plan.region.shape, dtype=plan.dtype)
        eng = get_engine(engine) if engine is not None else self._engine
        stats = ReadStats(chunks_touched=plan.num_chunks, runs=plan.runs,
                          groups=plan.num_groups,
                          bytes_read=plan.bytes_needed,
                          probe_seconds=plan.probe_seconds,
                          plan_seconds=plan.plan_seconds, engine=eng.name,
                          engine_reason="pinned")
        t0 = time.perf_counter()
        eng.read_plan(plan, self._store, out)
        stats.seconds = time.perf_counter() - t0
        return out, stats

    def read(self, var: str, region: Block,
             candidates: np.ndarray | None = None,
             engine: str | IOEngine | None = None,
             device=None) -> tuple:
        """``region`` of ``var`` as a tensor on ``device`` (default: the
        session's).  Returns (tensor, ReadStats).

        A whole-variable read of raw chunks that tile the domain reads the
        stored extents flat, copies them to the device once and linearizes
        them there with the copy kernels; any other read of raw chunks (a
        part of the variable) reads each touched extent's needed bytes
        once, copies them to the device once and gathers the region with
        one ``pack_rows`` launch.  Compressed chunks take the host plan and
        one copy of the result (see :mod:`repro_torch.io.device`).
        """
        dev = self.device if device is None else resolve_device(device)
        route = read_route(self.index, var, region) if candidates is None \
            else None
        if route is not None:
            if route[0] == "region":
                got = read_regions(self, var, [region], dev, engine=engine)
                if got is not None:
                    return got[0][0], got[1]
            else:
                got = read_linearized(self, var, route, dev, engine=engine)
                if got is not None:
                    return got
        plan = self.plan_read(var, region, candidates=candidates)
        arr, stats = self.read_planned(plan, engine=engine)
        t0 = time.perf_counter()
        out = torch.from_numpy(arr).to(dev)
        stats.h2d_seconds = time.perf_counter() - t0
        return out, stats
