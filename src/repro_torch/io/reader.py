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
  of them on the card; ``read_decomposed`` / ``read_pattern`` read the
  paper's Fig.-6 patterns split over N readers, all readers' sub-regions
  in one gather on the card.
* **reorganize** — :func:`reorganize` gathers every chunk of a new layout
  on the card and writes them as the reference's post-hoc reorganization
  does (paper §5.1), out of place or in place; ``layout="auto"`` asks the
  :class:`~repro_torch.core.policy.LayoutPolicy` built from the source's
  ``access_log.json`` which layout (and codec) the observed mix favors.
* **served batches** — ``read_super_planned`` executes a coalesced
  :class:`~repro_torch.serve.coalesce.SuperPlan` (the multi-tenant read
  service's batch): one engine read of the merged spans, one copy to the
  card and ONE ``pack_rows`` launch for every member of raw chunks.
* **telemetry** — ``read`` / ``read_decomposed`` / ``read_pattern`` (and
  each served request) append one pattern fingerprint each to
  ``access_log.json`` next to ``index.json``
  (:class:`~repro_torch.core.policy.AccessLog`), stamped by the session's
  ``clock``; ``telemetry=False`` turns it off.
* **trace capture** — an attached :class:`~repro_torch.io.trace.
  TraceRecorder` (:meth:`Dataset.attach_trace`) journals every read, served
  request and write commit losslessly, as the JAX package's session does;
  ``reorganize(trace=)`` journals the reorganization.

Engines are interchangeable per session or per call, and ``engine="auto"``
defers the choice to plan-execution time: the session loads (or
micro-probes and persists, as ``calibration.json``) an
:class:`~repro_torch.core.cost_model.EngineCalibration` and asks
:func:`~repro_torch.core.cost_model.choose_engine` for an engine and queue
depth from the shape of the plan it executes.  The decision is recorded in
``ReadStats``/``WriteStats`` (``engine``, ``engine_reason``,
``predicted_seconds``); after persistently divergent auto plans the
calibration is dropped and re-probed (recalibrate-on-drift).
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
from ..core.codecs import available_codecs, encode
from ..core.cost_model import (CalibrationDrift, EngineCalibration,
                               EngineChoice, choose_engine,
                               invalidate_calibration, observe_reorg_overhead,
                               storage_calibration)
from ..core.layouts import ChunkPlan, LayoutPlan
from ..core.policy import AccessLog, AccessRecord, LayoutPolicy
from ..core.read_patterns import best_decompositions, decompose_region
from ..device import resolve_device
from ..interop import to_numpy, to_tensor
from .device import (LayoutTables, PinnedStaging, _sync, assemble_chunks,
                     gather_batches, gather_regions, read_linearized,
                     read_regions, read_route, read_super, to_host)
from .engine import (IOEngine, SubfileStore, WriteStats, assemble_chunk,
                     resolve_engine)
from .format import (BF16_STORAGE, ChunkRecord, DatasetIndex, INDEX_NAME,
                     dtype_name, extent_checksum, storage_dtype)
from .patterns import resolve_pattern
from .planner import (ReadPlan, WritePlan, build_read_plan, build_write_plan,
                      subset_write_plan)

__all__ = ["ReadStats", "Dataset", "reorganize", "choose_reorg_layout"]


@dataclasses.dataclass
class ReadStats:
    seconds: float = 0.0          # engine time (decomposed reads: wall)
    bytes_read: int = 0
    chunks_touched: int = 0
    runs: int = 0                 # contiguous byte runs (cold-cache seeks)
    groups: int = 0               # coalesced grouped reads actually issued
    probe_seconds: float = 0.0    # spatial-index lookup time
    plan_seconds: float = 0.0     # extent planning time
    engine: str = ""              # engine spec that executed the plan
    engine_reason: str = ""       # auto decision record, or "pinned"
    predicted_seconds: float = 0.0  # cost-model prediction (engine="auto")
    #: the device route's stages: lowering to row tables, the one copy to
    #: the device, and the kernel (a served batch's host scatter too)
    lower_seconds: float = 0.0
    h2d_seconds: float = 0.0
    linearize_seconds: float = 0.0
    #: a served member's route (``read_super_planned``): ``"device"`` when
    #: ``pack_rows`` gathered it, ``"host"`` when the host scattered it
    route: str = ""

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
        self.predicted_seconds += other.predicted_seconds
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
    ``"overlapped"``/``"overlapped:<depth>"``, ``"uring"``/
    ``"uring:<depth>"``, ``"odirect"``, ``"auto"`` or an
    :class:`~repro_torch.io.engine.IOEngine` instance; a kernel-bypass
    engine this host or filesystem cannot run degrades as
    :func:`~repro_torch.io.engine.resolve_engine` says, and the reason
    enters every stats record.  With ``"auto"`` the session picks an engine
    *per plan* from the plan's shape and a storage calibration
    (``calibration.json`` next to ``index.json``, micro-probed and
    persisted on first use; ``calibration`` injects one, which drift never
    drops).  ``index`` starts the session on an in-memory index, which it
    never refreshes.  ``device`` is where :meth:`read` returns tensors:
    ``"cuda"`` unless ``"cpu"`` is asked for.  ``telemetry=False`` turns
    off the access-log appends; ``clock`` stamps the access records (and
    the log's TTL check).
    """

    def __init__(self, dirpath: str, engine: str | IOEngine = "memmap", *,
                 create: bool = False, index: DatasetIndex | None = None,
                 calibration: EngineCalibration | None = None,
                 telemetry: bool = True, clock=None, device="cuda"):
        self.device = resolve_device(device)
        self.dirpath = dirpath
        self._auto = isinstance(engine, str) and engine == "auto"
        self._engine = None
        self._fallback_reason = ""
        self._calibration = calibration
        # drift tracking only applies to calibrations this session loaded or
        # probed itself — an explicitly injected calibration is pinned
        self._drift_enabled = calibration is None
        self._drift = CalibrationDrift()
        self._drift_lock = threading.Lock()
        self._telemetry = telemetry
        self._clock = clock if clock is not None else time.time
        self._trace = None            # attached TraceRecorder, if capturing
        self._access_log: AccessLog | None = None
        self._index_stat = None
        if index is not None:
            self.index = index
        elif create:
            self.index = DatasetIndex()
        else:
            self.index = DatasetIndex.load(dirpath)
            self._index_stat = self._stat_index()
        if create or index is not None:
            os.makedirs(dirpath, exist_ok=True)
        if not self._auto:
            self._engine, self._fallback_reason = \
                resolve_engine(engine, dirpath=dirpath)
        self._store = SubfileStore(dirpath)
        self._lock = threading.Lock()     # index mutation + append cursor
        self._cal_lock = threading.Lock()  # one probe even with many workers
        self._cursor: dict | None = None  # subfile -> first free byte
        self._staging = PinnedStaging()   # copies to and from the card,
        #                                   one pinned buffer a thread
        self._tables = LayoutTables()     # lowered layouts, while they live

    # -- session management --------------------------------------------------
    @classmethod
    def create(cls, dirpath: str, engine: str | IOEngine = "memmap",
               calibration: EngineCalibration | None = None,
               telemetry: bool = True, clock=None,
               device="cuda") -> "Dataset":
        """Start a new (empty) dataset. ``index.json`` is not written until
        the first successful :meth:`write_planned` commit."""
        return cls(dirpath, engine, create=True, calibration=calibration,
                   telemetry=telemetry, clock=clock, device=device)

    @classmethod
    def open(cls, dirpath: str, engine: str | IOEngine = "memmap",
             calibration: EngineCalibration | None = None,
             telemetry: bool = True, clock=None,
             device="cuda") -> "Dataset":
        """Attach to an existing dataset directory."""
        return cls(dirpath, engine, calibration=calibration,
                   telemetry=telemetry, clock=clock, device=device)

    @property
    def engine(self) -> str:
        """Name of the session's default engine (``"auto"`` when the choice
        is deferred to plan-execution time)."""
        return "auto" if self._auto else self._engine.name

    @property
    def generation(self) -> int:
        """The index's layout generation — bumped every time a
        reorganization republishes relocated extents."""
        return self.index.generation

    def _stat_index(self):
        """Cheap identity of the on-disk ``index.json`` (atomic replace
        changes the inode, appends change mtime/size)."""
        try:
            st = os.stat(os.path.join(self.dirpath, INDEX_NAME))
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def refresh(self) -> bool:
        """Reload ``index.json`` iff another session republished it (a
        reorganization commit, or a writer's append flush).  Returns True
        when the index was reloaded.  Sessions created around an in-memory
        index never refresh: their index IS the truth."""
        if self._index_stat is None:
            return False
        st = self._stat_index()
        if st is None or st == self._index_stat:
            return False
        with self._lock:
            self.index = DatasetIndex.load(self.dirpath)
            self._index_stat = st
            self._cursor = None
        # subfiles may have grown past any cached memmap's length, and an
        # in-place reorganization appended extents the old maps cannot see
        self._store.invalidate_all()
        return True

    def calibration(self) -> EngineCalibration:
        """The session's storage calibration (lazy: ``calibration.json`` if
        fresh, the per-device cache, else a micro-probe that is persisted
        next to ``index.json``).  Thread-safe: concurrent first users share
        one probe."""
        if self._calibration is None:
            with self._cal_lock:
                if self._calibration is None:
                    self._calibration = storage_calibration(self.dirpath)
        return self._calibration

    @property
    def access_log(self) -> AccessLog:
        """The dataset's persistent access log (``access_log.json``) — the
        pattern history :class:`~repro_torch.core.policy.LayoutPolicy`
        scores candidate layouts against.  Appends are batched;
        :meth:`flush` / :meth:`close` drain the buffer."""
        if self._access_log is None:
            self._access_log = AccessLog(self.dirpath, flush_every=8,
                                         clock=self._clock)
        return self._access_log

    # -- trace capture -------------------------------------------------------
    def attach_trace(self, recorder) -> None:
        """Attach a :class:`~repro_torch.io.trace.TraceRecorder`: every
        read (plain / decomposed / pattern / served) and write commit — and,
        through their ``trace=`` parameters, staging submits, reorganizations
        and checkpoint operations — is journaled losslessly to its sidecar,
        on top of (never instead of) the ring-bounded access log."""
        self._trace = recorder

    def detach_trace(self):
        """Stop capturing; returns the recorder that was attached."""
        rec, self._trace = self._trace, None
        return rec

    def _record_access(self, var: str, region: Block, stats: "ReadStats",
                       kind: str = "read", tenant: str = "",
                       trace_kind: str | None = None,
                       trace_params: dict | None = None,
                       parts=None) -> None:
        """Append one pattern fingerprint; telemetry never breaks a read.
        The record's ``runs``/``groups`` are the executed route's own (see
        :class:`ReadStats`).  ``tenant`` namespaces the record (the read
        service).  ``trace_kind``/``trace_params`` name the event an
        attached trace recorder journals (schema-checked, so unlike the
        ring append it raises on misuse); its ``runs``/``groups`` are the
        host read plans' of ``parts`` (the regions the read was split
        into), as the JAX package's session records them, whatever route
        ran."""
        if not self._telemetry:
            return
        try:
            self.access_log.append(AccessRecord.from_stats(
                var, kind, region, self.index.var_shape(var), stats,
                tenant=tenant, ts=self._clock()))
        except Exception:               # noqa: BLE001 — telemetry only
            pass
        if self._trace is not None:
            if parts is not None:
                plans = [self.plan_read(var, p) for p in parts]
                stats = dataclasses.replace(
                    stats, runs=sum(p.runs for p in plans),
                    groups=sum(p.num_groups for p in plans))
            self._trace.record_read(trace_kind or kind, var, region, stats,
                                    tenant=tenant, **(trace_params or {}))

    def _note_drift(self, choice: EngineChoice | None,
                    measured_seconds: float) -> None:
        """Recalibrate-on-drift: after persistently divergent auto plans,
        drop the calibration so the next auto decision re-probes."""
        if choice is None or not self._drift_enabled:
            return
        with self._drift_lock:
            tripped = self._drift.note(choice.predicted_seconds,
                                       measured_seconds)
        if tripped:
            invalidate_calibration(self.dirpath)
            with self._cal_lock:
                self._calibration = None

    def _resolve_engine(self, override, *, groups: int, runs: int,
                        bytes_moved: int, span_bytes: int,
                        direction: str) -> tuple:
        """Resolve a per-call ``engine`` override (or the session default)
        to an engine instance; returns ``(engine, EngineChoice | None,
        pinned_reason)``.  ``"auto"`` — per call or as the session default
        — consults the cost model with this plan's shape.  Pinned specs
        that the kernel/filesystem cannot honor degrade through
        :func:`~repro_torch.io.engine.resolve_engine`, and
        ``pinned_reason`` carries the fallback explanation into the stats
        record."""
        spec = override if override is not None else \
            ("auto" if self._auto else self._engine)
        if isinstance(spec, str) and spec == "auto":
            choice = choose_engine(self.calibration(), groups=groups,
                                   runs=runs, bytes_moved=bytes_moved,
                                   span_bytes=span_bytes,
                                   direction=direction)
            eng, fb = resolve_engine(choice.engine, dirpath=self.dirpath)
            if fb:
                # a calibration probed elsewhere promised support this
                # host lacks (copied calibration.json): degrade, but keep
                # the decision record honest about what actually ran
                choice = dataclasses.replace(choice, engine=eng.name,
                                             reason=f"{choice.reason}; "
                                                    f"{fb}")
            return eng, choice, ""
        if override is not None:
            eng, fb = resolve_engine(spec, dirpath=self.dirpath)
            return eng, None, fb or "pinned"
        return self._engine, None, self._fallback_reason or "pinned"

    def flush(self) -> None:
        """Persist ``index.json`` (atomic replace) and any buffered
        access-log records."""
        self.index.save(self.dirpath)
        if self._access_log is not None:
            self._access_log.flush()

    def close(self) -> None:
        if self._access_log is not None:
            self._access_log.flush()
        self._store.close()
        self._staging.release()

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

    def _assemble(self, layout: LayoutPlan, data: Mapping, dtype) -> tuple:
        """Chunk buffers in ``layout.chunks`` order, and the device stage
        times: on the card when the data are tensors (the buffers then
        views of the session's pinned staging buffer), else on the
        host."""
        if any(isinstance(v, torch.Tensor) for v in data.values()):
            return assemble_chunks(layout, data, dtype, self._staging,
                                   self._tables)
        if dtype_name(dtype) == "bfloat16":     # the bits, never a cast
            data = {k: np.asarray(v).view(BF16_STORAGE)
                    for k, v in data.items()}
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
        passes the pre-encoded extent buffers (indexed by ``layout.chunks``
        position) and the codec they carry, and the plan was built with
        their sizes.  ``codec="none"`` with ``encoded`` writes buffers
        assembled already (``reorganize``'s gathered chunks).
        """
        if codec != "none" and encoded is None:
            raise ValueError("codec != 'none' requires pre-encoded buffers "
                             "(use Dataset.write(..., codec=...))")
        eng, choice, pinned_reason = self._resolve_engine(
            engine, groups=plan.num_groups, runs=plan.num_chunks,
            bytes_moved=plan.bytes_total, span_bytes=plan.span_bytes,
            direction="write")
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

        self._note_drift(choice, write_seconds)
        wstats = WriteStats(assemble_seconds=assemble_seconds,
                            write_seconds=write_seconds,
                            total_seconds=time.perf_counter() - t_start,
                            bytes_written=int(plan.bytes_total),
                            num_extents=plan.num_chunks,
                            num_subfiles=len(plan.file_sizes),
                            groups=plan.num_groups,
                            plan_seconds=plan.plan_seconds,
                            engine=choice.engine if choice else eng.name,
                            engine_reason=choice.reason if choice
                            else pinned_reason,
                            predicted_seconds=choice.predicted_seconds
                            if choice else 0.0,
                            lower_seconds=stages.get("lower", 0.0),
                            kernel_seconds=stages.get("kernel", 0.0),
                            d2h_seconds=stages.get("d2h", 0.0))
        if self._trace is not None and plan.num_chunks:
            extra = {"codec": codec} if codec != "none" else {}
            self._trace.record_write("write", plan, wstats, **extra)
        return wstats

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
        dtype = storage_dtype(dtype)
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
                     engine: str | IOEngine | None = None,
                     note_drift: bool = True) -> tuple:
        """Execute a read plan into a host array.  Returns (array,
        ReadStats); the stats record which engine ran and — under
        ``"auto"`` — the decision rationale.  ``note_drift=False`` keeps
        this plan out of recalibrate-on-drift accounting."""
        if out is None:
            out = np.empty(plan.region.shape, dtype=plan.dtype)
        eng, choice, pinned_reason = self._resolve_engine(
            engine, groups=plan.num_groups, runs=plan.runs,
            bytes_moved=plan.bytes_needed, span_bytes=plan.span_bytes,
            direction="read")
        stats = ReadStats(chunks_touched=plan.num_chunks, runs=plan.runs,
                          groups=plan.num_groups,
                          bytes_read=plan.bytes_needed,
                          probe_seconds=plan.probe_seconds,
                          plan_seconds=plan.plan_seconds,
                          engine=choice.engine if choice else eng.name,
                          engine_reason=choice.reason if choice
                          else pinned_reason,
                          predicted_seconds=choice.predicted_seconds
                          if choice else 0.0)
        t0 = time.perf_counter()
        eng.read_plan(plan, self._store, out)
        stats.seconds = time.perf_counter() - t0
        if note_drift:
            self._note_drift(choice, stats.seconds)
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
        one copy of the result (see :mod:`repro_torch.io.device`).  The
        read is appended to the access log.
        """
        out, stats = self._read(var, region, candidates, engine, device)
        self._record_access(var, region, stats, trace_kind="read",
                            parts=[region])
        return out, stats

    def _read(self, var: str, region: Block, candidates, engine,
              device=None) -> tuple:
        """:meth:`read` without the access record."""
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
        out = to_tensor(arr, dev)
        stats.h2d_seconds = time.perf_counter() - t0
        return out, stats

    def read_super_planned(self, sp, outs: Sequence[torch.Tensor] | None = None,
                           engine: str | IOEngine | None = None,
                           device=None) -> tuple:
        """Execute a :class:`~repro_torch.serve.coalesce.SuperPlan` on
        ``device`` (default: the session's): ONE engine read of the merged byte spans, one
        copy to the device, ONE ``pack_rows`` launch gathering every member
        of raw chunks (:func:`~repro_torch.io.device.read_super`).  A
        member with compressed or overlapping stored chunks is scattered on
        the host from the same fetch buffer, as the JAX package scatters
        it, and copied to the device once.

        Returns ``(outs, fetch_stats, member_stats)`` — a region-shaped
        tensor per member (the same bytes as independent :meth:`read`
        calls; rows no stored chunk covers are zero), the ``ReadStats`` of
        the shared fetch (the JAX package's: ``bytes_read ==
        sp.fetch_bytes``, the spans' runs and groups, the engine), and one
        ``ReadStats`` per member whose structural fields are the member's
        own plan's, whose ``seconds`` apportion the batch wall time by
        payload bytes and whose ``route`` says which route it took.
        ``outs``: tensors to copy the results into (and return).  Returns
        once the calling thread's stream has finished the launch."""
        dev = self.device if device is None else resolve_device(device)
        t0 = time.perf_counter()
        got, fstats, host = read_super(self, sp, dev, engine=engine)
        if outs is not None:
            for dst, src in zip(outs, got):
                dst.copy_(src)
            _sync(dev)
        else:
            outs = got
        wall = time.perf_counter() - t0
        fstats.probe_seconds += sp.probe_seconds
        fstats.plan_seconds += sp.plan_seconds
        total = max(1, sum(int(p.bytes_needed) for p in sp.members))
        member_stats = []
        for plan, on_host in zip(sp.members, host):
            member_stats.append(ReadStats(
                seconds=wall * plan.bytes_needed / total,
                bytes_read=plan.bytes_needed,
                chunks_touched=plan.num_chunks, runs=plan.runs,
                groups=plan.num_groups, engine=fstats.engine,
                engine_reason=fstats.engine_reason,
                route="host" if on_host else "device"))
        return outs, fstats, member_stats

    def read_decomposed(self, var: str, region: Block,
                        scheme: Sequence[int],
                        materialize: bool = True,
                        candidates: np.ndarray | None = None,
                        engine: str | IOEngine | None = None,
                        log_access: bool = True) -> ReadStats:
        """Read of ``region`` split over ``prod(scheme)`` readers (paper
        Fig. 5).  Returns aggregated stats; ``seconds`` is wall time, ended
        by a device synchronize.

        The spatial index is probed once for the whole region, and every
        reader's sub-region is gathered in ONE :func:`~repro_torch.io.
        device.gather_regions` call on the session's device: one engine
        read of each touched extent, however many readers share it, one
        copy, one ``pack_rows`` launch.  ``bytes_read`` and
        ``chunks_touched`` are the reference's (the sub-plans' sums);
        ``runs`` and ``groups`` are the gather's own.  Compressed or
        overlapping chunks take the host plan a reader, each result copied
        to the device, as :meth:`read` does.  ``materialize`` is the
        reference's signature.  ``log_access=False`` suppresses the access
        record (:meth:`read_pattern`'s sweep is one logical access).
        """
        parts = decompose_region(region, scheme)
        agg = ReadStats()
        t0 = time.perf_counter()
        if candidates is None:
            tp = time.perf_counter()
            candidates = self.index.spatial_index(var).query(region.lo,
                                                             region.hi)
            agg.probe_seconds += time.perf_counter() - tp
        got = None
        if read_route(self.index, var, region) is not None:
            got = gather_regions(self, var, parts, self.device,
                                 engine=engine, candidates=candidates)
        if got is None:
            for p in parts:
                _, st = self._read(var, p, candidates, engine)
                agg.merge(st)
        else:
            agg.merge(got[1])
        _sync(self.device)
        agg.seconds = time.perf_counter() - t0
        if log_access:
            self._record_access(
                var, region, agg, trace_kind="read_decomposed",
                trace_params={"scheme": [int(k) for k in scheme]},
                parts=parts)
        return agg

    def read_pattern(self, var: str, pattern: str,
                     num_readers: int = 1,
                     slab_thickness: int | None = None,
                     engine: str | IOEngine | None = None) -> tuple:
        """Read a Fig.-6 pattern with the best decomposition for
        ``num_readers`` (the paper reports best-of over schemes).
        Returns (best_scheme, ReadStats of best).

        One index probe serves the whole best-of-schemes sweep: every scheme
        shares the region's candidate set.
        """
        shape = self.index.var_shape(var)
        region = resolve_pattern(shape, pattern, slab_thickness)
        tp = time.perf_counter()
        candidates = self.index.spatial_index(var).query(region.lo, region.hi)
        probe_seconds = time.perf_counter() - tp
        best = None
        for scheme in best_decompositions(num_readers, ndim=len(shape)):
            st = self.read_decomposed(var, region, scheme,
                                      candidates=candidates, engine=engine,
                                      log_access=False)
            if best is None or st.seconds < best[1].seconds:
                best = (scheme, st)
        # the one shared index probe is attributed to the reported best;
        # the whole best-of-schemes sweep is ONE logical access pattern
        best[1].probe_seconds += probe_seconds
        trace_params = {"pattern": pattern, "num_readers": int(num_readers),
                        "best_scheme": [int(k) for k in best[0]]}
        if slab_thickness is not None:
            trace_params["slab_thickness"] = int(slab_thickness)
        self._record_access(var, region, best[1], trace_kind="read_pattern",
                            trace_params=trace_params,
                            parts=decompose_region(region, best[0]))
        return best

    # -- integrity -----------------------------------------------------------
    def verify_checksums(self, var: str | None = None) -> tuple:
        """Re-read every stored extent that carries a CRC and validate it.
        Returns ``(checked, bad)`` — the number of records validated and
        the list of record positions (rows into ``index.chunks``) whose
        stored bytes no longer match.  Records without a checksum are
        skipped."""
        checked = 0
        bad = []
        for i, rec in enumerate(self.index.chunks):
            if rec.checksum is None or (var is not None and rec.var != var):
                continue
            fd = self._store.fd(rec.subfile)
            buf = os.pread(fd, rec.nbytes, rec.offset)
            checked += 1
            if len(buf) != rec.nbytes or extent_checksum(buf) != rec.checksum:
                bad.append(i)
        return checked, bad


def sample_codec_ratios(src: Dataset, var: str, *,
                        max_bytes: int = 4 << 20) -> dict:
    """Measure each available codec's stored/logical size ratio on a sample
    of ``var``'s actual data (the first stored chunk, capped at
    ``max_bytes`` along its leading axis) — what the layout policy scores
    compressibility with.  Returns ``{}`` when the variable has no
    extents or every codec fails."""
    rows = src.index.var_rows(var)
    if rows.n == 0:
        return {}
    lo = np.array(rows.los[0], dtype=np.int64)
    hi = np.array(rows.his[0], dtype=np.int64)
    itemsize = src.index.var_dtype(var).itemsize
    vol = int((hi - lo).prod()) * itemsize
    if vol > max_bytes and hi[0] - lo[0] > 1:
        keep = max(1, int((hi[0] - lo[0]) * max_bytes // vol))
        hi = hi.copy()
        hi[0] = lo[0] + keep
    try:
        arr, _ = src.read(var, Block(tuple(int(v) for v in lo),
                                     tuple(int(v) for v in hi)))
    except (OSError, ValueError, KeyError):
        return {}
    raw = np.ascontiguousarray(to_numpy(arr.cpu()))
    if raw.nbytes == 0:
        return {}
    ratios = {}
    for name in available_codecs():
        if name == "none":
            continue
        try:
            ratios[name] = len(encode(name, raw)) / raw.nbytes
        except Exception:
            continue
    return ratios


def _gather(src: Dataset, var: str, regions: list, dtype,
            staging: PinnedStaging) -> tuple:
    """The ``regions`` of ``var`` as host arrays, the gather's ReadStats
    and the seconds of its copy back to the host: raw chunks gathered on
    ``src``'s device by :func:`~repro_torch.io.device.gather_regions` and
    copied to the host once, through ``staging``; compressed or
    overlapping ones by the host plans, straight into host memory (the
    data are bound for the disk)."""
    got = None
    if read_route(src.index, var, regions[0]) is not None:
        got = gather_regions(src, var, regions, src.device)
    d2h = 0.0
    if got is None:
        host = np.empty(sum(r.volume for r in regions), dtype=dtype)
        st, pos = ReadStats(), 0
        for r in regions:
            _, s = src.read_planned(
                src.plan_read(var, r),
                out=host[pos:pos + r.volume].reshape(r.shape))
            st.merge(s)
            st.seconds += s.seconds
            pos += r.volume
    else:
        flat, st = got
        t0 = time.perf_counter()
        host = to_host(flat, staging)
        d2h = time.perf_counter() - t0
    bufs, pos = [], 0
    for r in regions:
        bufs.append(host[pos:pos + r.volume].reshape(r.shape))
        pos += r.volume
    return bufs, st, d2h


def choose_reorg_layout(src: Dataset, var: str, *,
                        align: int | None = None,
                        policy: LayoutPolicy | None = None,
                        prior: str | None = None,
                        expected_reads: float | None = None,
                        codec_ratios: dict | None = None,
                        now: float | None = None):
    """The ``layout="auto"`` decision :func:`reorganize` makes: ask the
    source dataset's :class:`~repro_torch.core.policy.LayoutPolicy` (its
    access log + calibration + learned reorganization overhead) which
    target layout the observed pattern mix favors, charging each candidate
    the cost of gathering out of the source's *current* extents.  Returns
    the :class:`~repro_torch.core.policy.PolicyDecision`."""
    pol = policy if policy is not None else \
        LayoutPolicy.for_dataset(src.dirpath)
    if prior is not None:
        pol = pol.with_prior(prior)
    rows = src.index.var_rows(var)
    blocks = [Block(tuple(int(v) for v in rows.los[i]),
                    tuple(int(v) for v in rows.his[i]),
                    owner=int(rows.subfiles[i]), block_id=i)
              for i in range(rows.n)]
    return pol.choose_layout(var, blocks, src.index.var_shape(var),
                             num_stagers=max(1, src.index.num_subfiles),
                             align=align, current_extents=rows,
                             expected_reads=expected_reads,
                             codec_ratios=codec_ratios, now=now)


def reorganize(src_dir: str, dst_dir: str, var: str,
               layout: LayoutPlan | str = "auto", *,
               engine: str | IOEngine = "memmap",
               align: int | None = None,
               policy: LayoutPolicy | None = None,
               prior: str | None = None,
               expected_reads: float | None = None,
               now: float | None = None,
               clock=None, trace=None, device="cuda") -> tuple:
    """Post-hoc reorganization (paper §5.1) on the card: gather every chunk
    of the new ``layout`` out of ``src_dir`` and write the reorganized
    dataset to ``dst_dir`` — the same subfiles and ``index.json`` as the
    JAX package's ``reorganize`` with the same layout or decision.

    ``layout="auto"`` (the default) asks :func:`choose_reorg_layout` —
    the source's access history, its calibration and measured
    reorganization overhead, each candidate charged its lifecycle cost
    (paper §5.2) — which layout, and which codec
    (:func:`sample_codec_ratios` measures them on the variable's data), the
    observed read mix favors; ``policy`` injects a prepared policy,
    ``prior`` seeds it with a previous run's history, ``expected_reads``
    pins the amortization horizon and ``now`` the recency reference.  The
    decision is persisted in the destination's ``index.json`` under
    ``attrs["policy"][var]``.

    The new chunks, in ``layout.chunks`` order, are the target regions of
    :func:`~repro_torch.io.device.gather_regions` on ``device`` (``"cuda"``
    unless ``"cpu"`` is asked for): one engine read of each touched stored
    extent, once, one copy to the card and ONE ``pack_rows`` launch — a
    call per batch of whole chunks of at most :data:`~repro_torch.io.
    device.GATHER_BATCH_BYTES`.  Its output is the new chunks, row-major,
    back to back, so it crosses to the host once.  Raw chunks are written
    as they are: ``write_planned`` of the identity plan's rows with the
    chunk views as ``encoded`` and ``codec="none"``, no second kernel pass,
    and the index is committed once, after the last batch.  With a codec
    the stored sizes decide the append offsets, so each batch's chunks are
    encoded on the host as they arrive, and the write plan is built from
    the encoded sizes and written once, after the last batch.

    With ``dst_dir == src_dir`` the reorganization happens **in place,
    online**: the new extents are appended past the live ones, and the
    index is republished in one atomic replace with its generation bumped
    and the other variables' records carried over.  A concurrent reader
    holds either the old index (whose extents are intact) or the new one;
    :meth:`Dataset.refresh` picks up the new one.

    Returns ``(read_seconds, Dataset, WriteStats)`` — the gather's wall
    seconds, a session open on the destination, and the write's stats,
    whose ``gather`` is the gather's merged ``ReadStats`` (engine read,
    lowering, copy to the card, kernel) and ``d2h_seconds`` its copy back.
    The measured per-chunk overhead (gather minus engine seconds) is
    folded into the source's ``reorg_stats.json``.  ``clock`` stamps the
    destination session's records; ``trace`` journals one ``reorganize``
    event — layout request, chosen scheme, decision audit — to an attached
    :class:`~repro_torch.io.trace.TraceRecorder` after the commit, as the
    JAX package's ``reorganize`` does.
    """
    if isinstance(layout, str) and layout != "auto":
        raise ValueError(f"layout must be a LayoutPlan or 'auto', "
                         f"got {layout!r}")
    dev = resolve_device(device)
    in_place = os.path.abspath(src_dir) == os.path.abspath(dst_dir)
    requested = layout if isinstance(layout, str) else {
        "strategy": layout.strategy,
        "chunks": [[[int(v) for v in c.chunk.lo],
                    [int(v) for v in c.chunk.hi], int(c.subfile)]
                   for c in layout.chunks]}
    # the source session's bulk chunk reads are mechanical, not an
    # application access pattern: keep them out of the telemetry
    src = Dataset.open(src_dir, engine=engine, telemetry=False, clock=clock,
                       device=dev)
    try:
        decision = None
        if isinstance(layout, str):
            decision = choose_reorg_layout(
                src, var, align=align, policy=policy, prior=prior,
                expected_reads=expected_reads,
                codec_ratios=sample_codec_ratios(src, var), now=now)
            layout = decision.layout
        codec = decision.codec if decision is not None else "none"
        # rewrite with chunk == source identity
        synth = [Block(cp.chunk.lo, cp.chunk.hi, owner=cp.writer,
                       block_id=i) for i, cp in enumerate(layout.chunks)]
        ident = LayoutPlan(
            strategy=layout.strategy, global_shape=layout.global_shape,
            chunks=tuple(ChunkPlan(chunk=b, sources=(b,), writer=b.owner,
                                   subfile=cp.subfile)
                         for b, cp in zip(synth, layout.chunks)),
            num_subfiles=layout.num_subfiles,
            inter_process_moved=layout.inter_process_moved,
            intra_node_moved=layout.intra_node_moved)
        dtype = src.index.var_dtype(var)
        if in_place:
            # the fresh index starts with only the OTHER variables'
            # records (they don't move), the new extents are appended past
            # the current cursor so live readers' old extents stay
            # byte-identical, and the one flush below is the atomic index
            # replace that flips readers
            new_index = DatasetIndex(num_subfiles=src.index.num_subfiles,
                                     attrs=dict(src.index.attrs),
                                     generation=src.index.generation + 1)
            for name, meta in src.index.variables.items():
                if name != var:
                    new_index.variables[name] = dict(meta)
            for rec in src.index.chunks:
                if rec.var != var:
                    new_index.chunks.append(dataclasses.replace(rec))
            with src._lock:
                cursor = dict(src._cursor_dict())
            dst = Dataset(dst_dir, engine=engine, index=new_index,
                          clock=clock, device=dev)
            dst._cursor = cursor              # append past the live extents
        else:
            dst = Dataset.create(dst_dir, engine=engine, clock=clock,
                                 device=dev)
            # layout lineage: the destination supersedes the source's layout
            dst.index.generation = src.index.generation + 1
        plan = None
        if codec == "none":
            plan = dst.plan_write(var, ident, dtype, align=align)
            row_of = np.argsort(plan.chunk_ids)     # each chunk's plan row
        read_seconds = d2h_seconds = encode_seconds = 0.0
        gather = ReadStats()
        parts, enc = [], []
        for batch in gather_batches([cp.chunk.volume * dtype.itemsize
                                     for cp in layout.chunks]) or [[]]:
            bufs = []
            if batch:
                t0 = time.perf_counter()
                bufs, st, d2h = _gather(src, var, [layout.chunks[i].chunk
                                                   for i in batch], dtype,
                                        dst._staging)
                read_seconds += time.perf_counter() - t0
                d2h_seconds += d2h
                gather.merge(st)
                gather.seconds += st.seconds
            if plan is None:
                # the views are the staging buffer's: encode before the
                # next batch takes it
                t0 = time.perf_counter()
                enc.extend(np.frombuffer(
                    encode(codec, np.ascontiguousarray(b)), dtype=np.uint8)
                    for b in bufs)
                encode_seconds += time.perf_counter() - t0
                continue
            parts.append(dst.write_planned(
                subset_write_plan(plan, row_of[batch]), {},
                encoded=dict(zip(batch, bufs)), flush=False))
        if plan is None:
            sizes = np.asarray([b.nbytes for b in enc], dtype=np.int64)
            with dst._lock:
                cursor = dst._cursor_dict()
                plan = build_write_plan(ident, var, dtype, align=align,
                                        base_offsets=cursor, sizes=sizes)
                for sf, end in plan.file_sizes.items():
                    if end > cursor.get(sf, 0):
                        cursor[sf] = end
            parts.append(dst.write_planned(plan, {}, codec=codec,
                                           encoded=enc, flush=False))
            parts[-1].assemble_seconds += encode_seconds
            parts[-1].total_seconds += encode_seconds
        if decision is not None:
            dst.index.attrs.setdefault("policy", {})[var] = \
                decision.to_json()
        dst.flush()
        wstats = WriteStats(
            assemble_seconds=sum(w.assemble_seconds for w in parts),
            write_seconds=sum(w.write_seconds for w in parts),
            total_seconds=sum(w.total_seconds for w in parts),
            bytes_written=int(plan.bytes_total),
            num_extents=plan.num_chunks, num_subfiles=len(plan.file_sizes),
            groups=sum(w.groups for w in parts),
            plan_seconds=plan.plan_seconds,
            engine=parts[0].engine if len({w.engine for w in parts}) == 1
            else "mixed",
            engine_reason="; ".join(dict.fromkeys(w.engine_reason
                                                  for w in parts)),
            predicted_seconds=sum(w.predicted_seconds for w in parts),
            d2h_seconds=d2h_seconds, gather=gather)
    finally:
        src.close()
    # learned per-chunk reorganization overhead: what the gather paid on
    # top of raw engine time, folded into the source's reorg_stats.json
    # only after the destination committed
    if len(layout.chunks):
        observe_reorg_overhead(
            src_dir, max(0.0, read_seconds - wstats.gather.seconds)
            / len(layout.chunks), num_chunks=len(layout.chunks))
    if trace is not None:
        trace.record(
            "reorganize", var=var,
            seconds=read_seconds + wstats.total_seconds,
            engine=wstats.engine, nbytes=wstats.bytes_written,
            dst="" if in_place else os.path.basename(
                os.path.abspath(dst_dir)),
            layout=requested, align=align,
            decision=decision.to_json() if decision is not None else None)
    return read_seconds, dst, wstats
