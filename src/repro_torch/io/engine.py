"""I/O execution engines: the host half of the plan/execute split.

An :class:`IOEngine` executes *either plan kind* — :class:`~repro_torch.io.
planner.ReadPlan` or :class:`~repro_torch.io.planner.WritePlan` — against a
dataset directory's subfiles.  Plans carry every byte offset; engines are
pure mechanism and never do offset arithmetic.

Engines (copied from the JAX package; ``engine="auto"`` is resolved per
plan by the :class:`~repro_torch.io.reader.Dataset` session):

* ``memmap``     — zero-copy strided gathers/scatters through per-subfile
  memory maps (default; hot page cache);
* ``pread``      — explicit ``os.preadv``/``os.pwritev`` vectored syscalls,
  one per coalesced group, issued serially in ``(subfile, offset)`` order;
* ``overlapped`` — the ``pread`` mechanism with up to ``depth`` group
  transfers in flight at once on a persistent submission pool;
* ``uring``      — true async submission through a raw ``io_uring`` ring:
  one SQE per coalesced group, batched submit/reap at a configurable queue
  depth, a registered fixed-buffer pool for zero-copy gathers;
* ``odirect``    — ``O_DIRECT`` kernel-bypass transfers for large
  sequential extents: page-cache double-buffering is skipped, ragged
  head/tail bytes around the planner's ``align`` boundaries go through
  small aligned bounce buffers (reads) or buffered edge writes (writes),
  never a read-modify-write of a neighbor's bytes.

On the card's routes (:mod:`repro_torch.io.device`) the host buffers an
engine reads into are views of the session's pinned staging buffer, so the
bytes land where the one copy to the card starts.  The kernel-bypass
engines feature-detect at probe time: :func:`resolve_engine` degrades
``uring`` to ``overlapped`` and ``odirect`` to ``pread`` where the kernel
or filesystem lacks support and reports the reason, which the Dataset
session surfaces as ``ReadStats.engine_reason``.

File handles live in a :class:`SubfileStore` (per-``Dataset`` session):
read-mostly fd/memmap caches, growth via ``ftruncate`` with map
invalidation, all thread-safe.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Sequence

import numpy as np

from ..core.codecs import CODEC_NONE, decode
from ..core.layouts import ChunkPlan
from .direct import (DIRECT_ALIGN, aligned_empty, odirect_available,
                     open_direct, pread_into_direct, pwrite_direct)
from .format import subfile_name
from .planner import ReadPlan, WritePlan
from .uring import (OP_READ, OP_READ_FIXED, OP_WRITE, OP_WRITE_FIXED,
                    IoUring, UringUnavailable, uring_available)

__all__ = ["IOEngine", "MemmapEngine", "PreadEngine",
           "OverlappedPreadEngine", "UringEngine", "ODirectEngine",
           "SubfileStore", "WriteStats",
           "ENGINES", "get_engine", "resolve_engine", "validate_engine_spec",
           "assemble_chunk", "scatter_row"]

#: Linux caps one preadv/pwritev at IOV_MAX iovecs
_IOV_MAX = 1024

#: default queue depth of the overlapped engine
DEFAULT_QUEUE_DEPTH = 8

#: default queue depth of the uring engine (SQEs in flight per batch)
DEFAULT_URING_DEPTH = 16

#: registered fixed-buffer slot size: depth x this much memory is pinned
#: (counted against RLIMIT_MEMLOCK — containers commonly cap it at 8 MiB,
#: so the default pool stays well under; registration failure degrades to
#: unregistered async reads, never an error)
URING_BUF_BYTES = 256 << 10


@dataclasses.dataclass
class WriteStats:
    assemble_seconds: float = 0.0     # data rearrangement (memcpy analogue)
    write_seconds: float = 0.0        # wall time of the write phase
    total_seconds: float = 0.0
    bytes_written: int = 0
    num_extents: int = 0
    num_subfiles: int = 0
    groups: int = 0                   # coalesced vectored writes issued
    plan_seconds: float = 0.0
    engine: str = ""                  # engine spec that executed the plan
    engine_reason: str = ""           # why (auto decision record / "pinned")
    predicted_seconds: float = 0.0    # cost-model prediction (engine="auto")
    #: device route only (``repro_torch.io.device``): lowering the layout
    #: to row tables, the kernels, and the one copy to pinned host memory
    lower_seconds: float = 0.0
    kernel_seconds: float = 0.0
    d2h_seconds: float = 0.0
    #: ``reorganize`` only: its gather's merged ``ReadStats`` (engine read,
    #: lowering, copy to the card, the ``pack_rows`` launch)
    gather: object = None

    @property
    def write_gbps(self) -> float:
        return self.bytes_written / max(self.write_seconds, 1e-12) / 1e9


def assemble_chunk(cp: ChunkPlan, data: Mapping[int, np.ndarray],
                   dtype) -> np.ndarray:
    """Build the chunk buffer from its source blocks (zero-copy when the
    chunk IS a single contiguous source block)."""
    if len(cp.sources) == 1 and cp.sources[0].lo == cp.chunk.lo \
            and cp.sources[0].hi == cp.chunk.hi:
        arr = data[cp.sources[0].block_id]
        return np.ascontiguousarray(arr)
    buf = np.empty(cp.chunk.shape, dtype=dtype)
    for src in cp.sources:
        inter = cp.chunk.intersect(src)
        if inter is None:
            continue
        src_arr = data[src.block_id]
        buf[inter.slices(origin=cp.chunk.lo)] = \
            src_arr[inter.slices(origin=src.lo)]
    return buf


class SubfileStore:
    """Thread-safe per-subfile file handles for one dataset directory."""

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        self._fds: dict = {}          # (subfile, writable) -> fd
        self._dfds: dict = {}         # (subfile, writable) -> O_DIRECT fd
        self._maps: dict = {}         # subfile -> read np.memmap
        self._wmaps: dict = {}        # subfile -> (write np.memmap, size)
        self._lock = threading.Lock()

    def path(self, k: int) -> str:
        return os.path.join(self.dirpath, subfile_name(k))

    def fd(self, k: int, writable: bool = False) -> int:
        with self._lock:
            # a cached O_RDWR handle serves reads too; a cached read-only
            # handle is never closed while the session lives (concurrent
            # reader threads may be mid-pread on it)
            fd = self._fds.get((k, True))
            if fd is None and not writable:
                fd = self._fds.get((k, False))
            if fd is not None:
                return fd
            flags = (os.O_RDWR | os.O_CREAT) if writable else os.O_RDONLY
            fd = os.open(self.path(k), flags)
            self._fds[(k, writable)] = fd
            return fd

    def direct_fd(self, k: int, writable: bool = False) -> int:
        """An ``O_DIRECT`` handle for subfile ``k`` (cached like
        :meth:`fd`).  Raises ``OSError`` where the filesystem refuses
        direct I/O — callers fall back to the buffered path."""
        with self._lock:
            fd = self._dfds.get((k, True))
            if fd is None and not writable:
                fd = self._dfds.get((k, False))
            if fd is not None:
                return fd
            fd = open_direct(self.path(k), writable=writable)
            self._dfds[(k, writable)] = fd
            return fd

    def read_map(self, k: int) -> np.memmap:
        with self._lock:
            mm = self._maps.get(k)
            if mm is None:
                mm = self._maps[k] = np.memmap(self.path(k), dtype=np.uint8,
                                               mode="r")
            return mm

    def write_map(self, k: int) -> np.memmap:
        size = os.fstat(self.fd(k, writable=True)).st_size
        with self._lock:
            ent = self._wmaps.get(k)
            if ent is None or ent[1] != size:
                ent = (np.memmap(self.path(k), dtype=np.uint8, mode="r+",
                                 shape=(size,)), size)
                self._wmaps[k] = ent
            return ent[0]

    def ensure_size(self, k: int, size: int) -> None:
        """Grow subfile ``k`` to at least ``size`` bytes (holes stay zero)."""
        fd = self.fd(k, writable=True)
        with self._lock:
            if os.fstat(fd).st_size < size:
                os.ftruncate(fd, size)
                # any cached map of the old length is stale for the new tail
                self._maps.pop(k, None)
                self._wmaps.pop(k, None)

    def invalidate(self, k: int) -> None:
        """Drop cached read maps after out-of-band writes to ``k``."""
        with self._lock:
            self._maps.pop(k, None)

    def invalidate_all(self) -> None:
        """Drop every cached map — used by ``Dataset.refresh`` after another
        session republished the index (subfiles may have grown past the
        cached map lengths)."""
        with self._lock:
            self._maps.clear()
            self._wmaps.clear()

    def fsync(self) -> None:
        with self._lock:
            for (k, writable), fd in self._fds.items():
                if writable:
                    os.fsync(fd)
            for (k, writable), fd in self._dfds.items():
                # O_DIRECT bypasses the page cache for data, but metadata
                # (size from the plan-time ftruncate) still needs the sync
                if writable:
                    os.fsync(fd)

    def close(self) -> None:
        # every cached handle is closed even if one close raises (EIO on
        # flush): stopping at the first failure would leak the rest
        with self._lock:
            first_exc = None
            for fd in list(self._fds.values()) + list(self._dfds.values()):
                try:
                    os.close(fd)
                except OSError as e:
                    if first_exc is None:
                        first_exc = e
            self._fds.clear()
            self._dfds.clear()
            self._maps.clear()
            self._wmaps.clear()
        if first_exc is not None:
            raise first_exc


def scatter_row(plan: ReadPlan, row: int, span: np.ndarray,
                out: np.ndarray) -> None:
    """Strided-gather plan row ``row`` from its byte span into ``out``.

    This is the single decode point for per-chunk codecs (index v4):
    a compressed row's span is its WHOLE stored extent, bounce-decoded to
    logical bytes here, then gathered with the same strided view.  Raw
    rows take the original zero-copy path untouched — memmap spans stay
    views straight into the page cache.
    """
    itemsize = plan.dtype.itemsize
    if plan.codecs is not None and plan.codecs[row] != CODEC_NONE:
        shape = plan.chunk_his[row] - plan.chunk_los[row]
        logical = int(shape.prod()) * itemsize
        raw = decode(int(plan.codecs[row]), span, logical)
        first = int(((plan.inter_los[row] - plan.chunk_los[row])
                     * plan.strides[row]).sum())
        elems = np.frombuffer(raw, dtype=plan.dtype, offset=first * itemsize)
    else:
        elems = span.view(plan.dtype)
    ishape = tuple(int(s) for s in
                   (plan.inter_his[row] - plan.inter_los[row]))
    byte_strides = tuple(int(s) * itemsize for s in plan.strides[row])
    view = np.lib.stride_tricks.as_strided(elems, shape=ishape,
                                           strides=byte_strides)
    out[plan.out_slices(row)] = view


def _flat_bytes(buf: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(buf).reshape(-1).view(np.uint8)


class IOEngine:
    """Executes read and write extent plans. Subclass per I/O mechanism."""

    name = "abstract"

    def read_plan(self, plan: ReadPlan, store: SubfileStore,
                  out: np.ndarray) -> None:
        raise NotImplementedError

    def write_plan(self, plan: WritePlan, buffers: Sequence[np.ndarray],
                   store: SubfileStore) -> None:
        """Write ``buffers`` (row-aligned with ``plan`` rows) to their
        extents.  Subfiles are already sized to ``plan.file_sizes``."""
        raise NotImplementedError


class MemmapEngine(IOEngine):
    """Zero-copy strided access through per-subfile memory maps."""

    name = "memmap"

    def read_plan(self, plan, store, out):
        for row in range(plan.num_chunks):
            raw = store.read_map(int(plan.subfiles[row]))
            span = raw[plan.file_lo[row]:plan.file_hi[row]]
            scatter_row(plan, row, span, out)

    def write_plan(self, plan, buffers, store):
        for row in range(plan.num_chunks):
            mm = store.write_map(int(plan.subfiles[row]))
            mm[int(plan.file_lo[row]):int(plan.file_hi[row])] = \
                _flat_bytes(buffers[row])
        for k in plan.file_sizes:
            store.invalidate(k)


def _pread_into(fd: int, buf: np.ndarray, offset: int) -> None:
    mv = memoryview(buf)
    while mv:
        data = os.pread(fd, len(mv), offset)
        if not data:
            raise IOError(f"short read at offset {offset}")
        mv[:len(data)] = data
        mv = mv[len(data):]
        offset += len(data)


def _pwrite_all(fd: int, mv: memoryview, offset: int) -> None:
    while mv:
        n = os.pwrite(fd, mv, offset)
        mv = mv[n:]
        offset += n


class PreadEngine(IOEngine):
    """Vectored syscalls, one ``preadv``/``pwritev`` per coalesced group,
    issued serially in ``(subfile, offset)`` order."""

    name = "pread"

    # -- reads ---------------------------------------------------------------
    def _fetch_group(self, plan: ReadPlan, g: int,
                     store: SubfileStore) -> np.ndarray:
        """Pull group ``g``'s byte span into a staging buffer (pure I/O,
        GIL-free in the syscalls — safe to overlap across threads)."""
        gb = plan.group_bounds
        s, e = int(gb[g]), int(gb[g + 1])
        fd = store.fd(int(plan.subfiles[s]))
        glo = int(plan.file_lo[s])
        ghi = int(plan.file_hi[e - 1])
        buf = np.empty(ghi - glo, dtype=np.uint8)
        # vectored read: one iovec per member extent when they tile the
        # span exactly (gap coalescing leaves holes -> read span whole)
        views, pos, tiled = [], glo, True
        for row in range(s, e):
            if int(plan.file_lo[row]) != pos:
                tiled = False
                break
            views.append(buf[int(plan.file_lo[row]) - glo:
                             int(plan.file_hi[row]) - glo])
            pos = int(plan.file_hi[row])
        if tiled and pos == ghi and hasattr(os, "preadv"):
            off = glo
            for i in range(0, len(views), _IOV_MAX):
                batch = views[i:i + _IOV_MAX]
                got = os.preadv(fd, batch, off)
                want = sum(v.nbytes for v in batch)
                off += got
                if got != want:
                    # preadv may legally return short; the views tile
                    # buf, so finish the tail with plain preads
                    _pread_into(fd, buf[off - glo:], off)
                    break
        else:
            _pread_into(fd, buf, glo)
        return buf

    def _scatter_group(self, plan: ReadPlan, g: int, buf: np.ndarray,
                       out: np.ndarray) -> None:
        gb = plan.group_bounds
        s, e = int(gb[g]), int(gb[g + 1])
        glo = int(plan.file_lo[s])
        for row in range(s, e):
            span = buf[int(plan.file_lo[row]) - glo:
                       int(plan.file_hi[row]) - glo]
            scatter_row(plan, row, span, out)

    def read_plan(self, plan, store, out):
        for g in range(plan.num_groups):
            self._scatter_group(plan, g, self._fetch_group(plan, g, store),
                                out)

    # -- writes --------------------------------------------------------------
    def _write_group(self, plan: WritePlan, g: int,
                     buffers: Sequence[np.ndarray],
                     store: SubfileStore) -> None:
        gb = plan.group_bounds
        s, e = int(gb[g]), int(gb[g + 1])
        fd = store.fd(int(plan.subfiles[s]), writable=True)
        views = [memoryview(_flat_bytes(buffers[row])) for row in range(s, e)]
        if hasattr(os, "pwritev"):
            off = int(plan.file_lo[s])
            done = 0                  # extents fully written so far
            while done < len(views):
                batch = views[done:done + _IOV_MAX]
                put = os.pwritev(fd, batch, off)
                off += put
                # pwritev may return short: finish partially-written extent
                # with plain pwrites, then continue the batch after it
                for v in batch:
                    if put >= len(v):
                        put -= len(v)
                        done += 1
                    else:
                        _pwrite_all(fd, v[put:], off)
                        off += len(v) - put
                        put = 0
                        done += 1
        else:                         # pragma: no cover - non-posix fallback
            for row, v in zip(range(s, e), views):
                _pwrite_all(fd, v, int(plan.file_lo[row]))
        # a group tiles its span by construction (gaps split groups), so no
        # holes need zero-fill beyond the plan-time ftruncate

    def write_plan(self, plan, buffers, store):
        for k in plan.file_sizes:
            store.fd(k, writable=True)
        for g in range(plan.num_groups):
            self._write_group(plan, g, buffers, store)
        for k in plan.file_sizes:
            store.invalidate(k)


class OverlappedPreadEngine(PreadEngine):
    """``pread`` mechanism with up to ``depth`` group transfers in flight
    (io_uring-style queue depth on a persistent submission pool), in both
    directions.

    Each in-flight unit is one coalesced group: on reads its ``preadv`` and
    its strided scatter both run on the pool (syscalls and large numpy
    copies release the GIL, so groups genuinely overlap); on writes each
    group's ``pwritev`` is submitted the same way.  The pool width IS the
    queue depth.  Distinct plan rows scatter to disjoint output slices and
    distinct write groups cover disjoint extents, so no synchronization is
    needed on the data.
    """

    name = "overlapped"

    def __init__(self, depth: int = DEFAULT_QUEUE_DEPTH):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()

    def _executor(self) -> ThreadPoolExecutor:
        # persistent: pool startup must not count against every read
        if self._pool is None:
            with self._pool_lock:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=self.depth,
                        thread_name_prefix="overlapped-io")
        return self._pool

    def _read_group(self, plan: ReadPlan, g: int, store: SubfileStore,
                    out: np.ndarray) -> None:
        self._scatter_group(plan, g, self._fetch_group(plan, g, store), out)

    @staticmethod
    def _drain(futures) -> None:
        """Await every in-flight group before surfacing the first failure:
        returning with stragglers still on the pool would let a caller
        close the SubfileStore under an active transfer."""
        first_exc = None
        for f in futures:
            try:
                f.result()
            except BaseException as e:     # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc

    def read_plan(self, plan, store, out):
        if plan.num_groups <= 1:
            return super().read_plan(plan, store, out)
        self._drain([self._executor().submit(self._read_group, plan, g,
                                             store, out)
                     for g in range(plan.num_groups)])

    def write_plan(self, plan, buffers, store):
        if plan.num_groups <= 1:
            return super().write_plan(plan, buffers, store)
        # open every target fd on the submitting thread (SubfileStore is
        # thread-safe, but this keeps O_CREAT ordering deterministic)
        for k in plan.file_sizes:
            store.fd(k, writable=True)
        try:
            self._drain([self._executor().submit(self._write_group, plan, g,
                                                 buffers, store)
                         for g in range(plan.num_groups)])
        finally:
            for k in plan.file_sizes:
                store.invalidate(k)


class _Transfer:
    """One in-flight SQE's bookkeeping inside :class:`UringEngine`.

    ``want`` is the total transfer length, ``need`` the minimum acceptable
    (direct-mode read windows may legally stop short at EOF inside their
    alignment padding), ``done`` the progress so far — short completions
    re-prep the remainder and go back in flight."""

    __slots__ = ("opcode", "fd", "base_addr", "file_off", "want", "need",
                 "done", "slot", "buf", "g", "buf_index")

    def prep(self, ring: IoUring, user_data: int) -> None:
        ring.prep(self.opcode, self.fd, self.base_addr + self.done,
                  self.want - self.done, self.file_off + self.done,
                  user_data, self.buf_index)


class UringEngine(PreadEngine):
    """True async submission through a raw ``io_uring`` ring.

    One SQE per coalesced group, batched submit/reap with up to ``depth``
    groups in flight — the same plan-group iteration as the overlapped
    engine, but the queue depth lives in the kernel instead of a thread
    pool, so there is no per-group dispatch handoff and no GIL traffic.
    Groups whose span fits a slot of the registered fixed-buffer pool go
    through ``IORING_OP_READ_FIXED``/``WRITE_FIXED`` (the kernel DMAs into
    pre-pinned pages — the zero-copy gather); larger groups use plain
    ``READ``/``WRITE`` SQEs on a per-group buffer.

    ``direct=True`` additionally routes *reads* through ``O_DIRECT`` file
    handles (aligned windows, page cache bypassed) — a cold read
    whatever the page cache holds.  Writes always go
    buffered: direct writes belong to :class:`ODirectEngine`, whose
    ragged-edge handling this engine does not duplicate.

    The ring is a single-submitter structure; concurrent plans from other
    threads (decomposed reads) take the serial ``pread`` path instead of
    queueing behind the lock.  Ring creation failure at execution time
    degrades to the inherited ``pread`` mechanics — :func:`resolve_engine`
    normally catches unsupported kernels before an instance exists, this
    is the in-engine safety net (seccomp mid-session, fd exhaustion).
    """

    name = "uring"

    def __init__(self, depth: int = DEFAULT_URING_DEPTH,
                 buf_bytes: int = URING_BUF_BYTES,
                 register: bool = True, direct: bool = False):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        if depth > 1024:
            raise ValueError(f"queue depth must be <= 1024, got {depth}")
        self.depth = depth
        # fixed slots must hold whole aligned windows in direct mode
        self.buf_bytes = -(-int(buf_bytes) // DIRECT_ALIGN) * DIRECT_ALIGN
        self.register = register
        self.direct = direct
        self._lock = threading.Lock()   # single submitter
        self._ring: IoUring | None = None
        self._ring_error: str | None = None
        self._pool = None
        self._slot_views: list = []
        self._free_slots: list = []
        self._fixed = False

    # -- ring lifecycle ------------------------------------------------------
    def _ensure_ring(self) -> IoUring:
        if self._ring is not None:
            return self._ring
        if self._ring_error is not None:
            raise UringUnavailable(self._ring_error)
        try:
            ring = IoUring(entries=max(self.depth, 8))
        except UringUnavailable as e:
            self._ring_error = str(e)
            raise
        pool = aligned_empty(self.depth * self.buf_bytes)
        views = [pool[i * self.buf_bytes:(i + 1) * self.buf_bytes]
                 for i in range(self.depth)]
        fixed = False
        if self.register:
            try:
                ring.register_buffers(views)
                fixed = True
            except UringUnavailable:
                # RLIMIT_MEMLOCK too small to pin the pool: plain READ/
                # WRITE SQEs are still fully async, just not zero-copy
                fixed = False
        self._pool, self._slot_views = pool, views
        self._free_slots = list(range(self.depth))
        self._fixed = fixed
        self._ring = ring
        return ring

    def close(self) -> None:
        with self._lock:
            if self._ring is not None:
                self._ring.close()
                self._ring = None
            self._pool, self._slot_views, self._free_slots = None, [], []

    def _take_slot(self, want: int) -> int | None:
        if want <= self.buf_bytes and self._free_slots:
            return self._free_slots.pop()
        return None

    def _release(self, it: _Transfer) -> None:
        if it.slot is not None:
            self._free_slots.append(it.slot)
        it.buf = None                   # drop the keep-alive reference

    # -- the submit/reap driver ----------------------------------------------
    def _drive(self, ring: IoUring, n_items: int, make_item,
               finish_item) -> None:
        """Keep up to ``depth`` transfers in flight: prep from
        ``make_item(i)``, batched ``io_uring_enter``, complete through
        ``finish_item``.  Short transfers resubmit their remainder.  On
        any failure every in-flight CQE is still reaped before the first
        error surfaces — returning with SQEs pending would let a caller
        free buffers under an active kernel transfer."""
        inflight: dict = {}
        redo: list = []
        next_i = user_data = 0
        err: BaseException | None = None
        while True:
            submitted = 0
            if err is None:
                while redo and ring.sq_space() > 0:
                    it = redo.pop()
                    it.prep(ring, user_data)
                    inflight[user_data] = it
                    user_data += 1
                    submitted += 1
                while (next_i < n_items and len(inflight) < self.depth
                       and ring.sq_space() > 0):
                    try:
                        it = make_item(next_i)
                    except BaseException as e:  # noqa: BLE001 — drain first
                        err = e
                        break
                    next_i += 1
                    it.prep(ring, user_data)
                    inflight[user_data] = it
                    user_data += 1
                    submitted += 1
            if not inflight:
                break
            ring.submit(submitted, wait_for=1)
            for ud, res in ring.reap():
                it = inflight.pop(ud)
                if err is not None:     # draining: discard, free the slot
                    self._release(it)
                    continue
                if res < 0:
                    err = OSError(-res, f"io_uring transfer failed on "
                                        f"group {it.g}: {os.strerror(-res)}")
                    self._release(it)
                    continue
                it.done += res
                if res == 0 or it.done >= it.want:
                    if it.done < it.need:
                        err = IOError(f"short io_uring transfer: group "
                                      f"{it.g} moved {it.done} of "
                                      f"{it.need} bytes")
                        self._release(it)
                        continue
                    try:
                        finish_item(it)
                    except BaseException as e:  # noqa: BLE001 — drain first
                        err = e
                    self._release(it)
                else:
                    redo.append(it)     # short: continue where it stopped
        if err is not None:
            raise err

    # -- reads ---------------------------------------------------------------
    def _run_read(self, ring: IoUring, plan: ReadPlan, store: SubfileStore,
                  out: np.ndarray) -> None:
        gb = plan.group_bounds
        A = DIRECT_ALIGN

        def make(g: int) -> _Transfer:
            s, e = int(gb[g]), int(gb[g + 1])
            sf = int(plan.subfiles[s])
            glo, ghi = int(plan.file_lo[s]), int(plan.file_hi[e - 1])
            it = _Transfer()
            it.g, it.done = g, 0
            if self.direct:
                it.fd = store.direct_fd(sf)
                lo, hi = (glo // A) * A, -(-ghi // A) * A
            else:
                it.fd = store.fd(sf)
                lo, hi = glo, ghi
            want = hi - lo
            slot = self._take_slot(want)
            if slot is not None:
                it.slot = slot
                it.buf = self._slot_views[slot][:want]
                it.opcode = OP_READ_FIXED if self._fixed else OP_READ
                it.buf_index = slot if self._fixed else 0
            else:
                it.slot = None
                it.buf = aligned_empty(want) if self.direct \
                    else np.empty(want, dtype=np.uint8)
                it.opcode, it.buf_index = OP_READ, 0
            it.base_addr = it.buf.ctypes.data
            it.file_off, it.want = lo, want
            it.need = ghi - lo          # EOF may clip the alignment pad
            return it

        def finish(it: _Transfer) -> None:
            s = int(gb[it.g])
            glo = int(plan.file_lo[s])
            self._scatter_group(plan, it.g, it.buf[glo - it.file_off:], out)

        self._drive(ring, plan.num_groups, make, finish)

    def read_plan(self, plan, store, out):
        if plan.num_groups == 0:
            return
        if not self._lock.acquire(blocking=False):
            # the ring is busy on another thread (decomposed reads):
            # serial pread beats queueing behind a foreign plan
            return super().read_plan(plan, store, out)
        try:
            try:
                ring = self._ensure_ring()
            except UringUnavailable:
                return super().read_plan(plan, store, out)
            if self.direct:
                try:        # one probe: all subfiles share the filesystem
                    store.direct_fd(int(plan.subfiles[0]))
                except OSError:
                    return super().read_plan(plan, store, out)
            self._run_read(ring, plan, store, out)
        finally:
            self._lock.release()

    # -- writes --------------------------------------------------------------
    def _prepare_write_group(self, plan: WritePlan, g: int,
                             buffers: Sequence[np.ndarray]) -> np.ndarray:
        """Assemble group ``g``'s contiguous payload (groups tile their
        span by construction).  Separate hook so fault-injection tests can
        kill between group submissions."""
        gb = plan.group_bounds
        s, e = int(gb[g]), int(gb[g + 1])
        if e - s == 1:
            return _flat_bytes(buffers[s])
        glo = int(plan.file_lo[s])
        payload = np.empty(int(plan.file_hi[e - 1]) - glo, dtype=np.uint8)
        for row in range(s, e):
            payload[int(plan.file_lo[row]) - glo:
                    int(plan.file_hi[row]) - glo] = _flat_bytes(buffers[row])
        return payload

    def _run_write(self, ring: IoUring, plan: WritePlan,
                   buffers: Sequence[np.ndarray],
                   store: SubfileStore) -> None:
        gb = plan.group_bounds

        def make(g: int) -> _Transfer:
            s = int(gb[g])
            payload = self._prepare_write_group(plan, g, buffers)
            it = _Transfer()
            it.g, it.done = g, 0
            it.fd = store.fd(int(plan.subfiles[s]), writable=True)
            want = payload.nbytes
            slot = self._take_slot(want)
            if slot is not None:
                view = self._slot_views[slot][:want]
                view[:] = payload
                it.slot, it.buf = slot, view
                it.opcode = OP_WRITE_FIXED if self._fixed else OP_WRITE
                it.buf_index = slot if self._fixed else 0
            else:
                it.slot = None
                it.buf = np.ascontiguousarray(payload)
                it.opcode, it.buf_index = OP_WRITE, 0
            it.base_addr = it.buf.ctypes.data
            it.file_off = int(plan.file_lo[s])
            it.want = it.need = want
            return it

        self._drive(ring, plan.num_groups, make, lambda it: None)

    def write_plan(self, plan, buffers, store):
        if not self._lock.acquire(blocking=False):
            return super().write_plan(plan, buffers, store)
        try:
            try:
                ring = self._ensure_ring()
            except UringUnavailable:
                return super().write_plan(plan, buffers, store)
            for k in plan.file_sizes:
                store.fd(k, writable=True)
            try:
                self._run_write(ring, plan, buffers, store)
            finally:
                for k in plan.file_sizes:
                    store.invalidate(k)
        finally:
            self._lock.release()


class ODirectEngine(PreadEngine):
    """``O_DIRECT`` transfers for large sequential extents.

    Reads fetch each coalesced group through an aligned window
    ``[align_down(lo), align_up(hi))`` into an aligned bounce buffer — the
    page cache never stages the bytes, so a cold read costs one device
    pass instead of device → cache → user.  Writes push the aligned middle
    of each group span direct and finish the ragged head/tail bytes with
    small buffered edge writes: never a read-modify-write of neighbouring
    bytes, so concurrent disjoint writers (distributed reorg workers)
    stay correct.  Plans built with the planner's ``align`` machinery
    (``GPFS_BLOCK`` spans) have no ragged edges at all.

    Filesystems that refuse ``O_DIRECT`` (tmpfs) degrade per group to the
    inherited buffered ``pread`` mechanics; :func:`resolve_engine` catches
    the common case up front and records the fallback reason.
    """

    name = "odirect"

    def __init__(self, align: int = DIRECT_ALIGN):
        if align < 512 or align & (align - 1):
            raise ValueError(f"align must be a power-of-two >= 512, "
                             f"got {align}")
        self.align = int(align)

    # -- reads ---------------------------------------------------------------
    def _fetch_group(self, plan: ReadPlan, g: int,
                     store: SubfileStore) -> np.ndarray:
        gb = plan.group_bounds
        s, e = int(gb[g]), int(gb[g + 1])
        glo = int(plan.file_lo[s])
        ghi = int(plan.file_hi[e - 1])
        try:
            dfd = store.direct_fd(int(plan.subfiles[s]))
        except OSError:
            return super()._fetch_group(plan, g, store)
        A = self.align
        alo, ahi = (glo // A) * A, -(-ghi // A) * A
        buf = aligned_empty(ahi - alo, A)
        got = pread_into_direct(dfd, buf, alo)
        if got < ghi - alo:             # EOF may only clip the pad bytes
            raise IOError(f"short direct read: group {g} got {got} of "
                          f"{ghi - alo} required bytes")
        return buf[glo - alo:ghi - alo]

    # -- writes --------------------------------------------------------------
    def _write_group(self, plan: WritePlan, g: int,
                     buffers: Sequence[np.ndarray],
                     store: SubfileStore) -> None:
        gb = plan.group_bounds
        s, e = int(gb[g]), int(gb[g + 1])
        sf = int(plan.subfiles[s])
        glo = int(plan.file_lo[s])
        ghi = int(plan.file_hi[e - 1])
        A = self.align
        head = -(-glo // A) * A         # align_up(glo)
        tail = (ghi // A) * A           # align_down(ghi)
        if tail - head < A:             # no aligned middle: buffered
            return super()._write_group(plan, g, buffers, store)
        try:
            dfd = store.direct_fd(sf, writable=True)
        except OSError:
            return super()._write_group(plan, g, buffers, store)
        abuf = aligned_empty(tail - head, A)
        edges = []                      # (offset, bytes) outside [head,tail)
        for row in range(s, e):
            flo, fhi = int(plan.file_lo[row]), int(plan.file_hi[row])
            fb = _flat_bytes(buffers[row])
            mlo, mhi = max(flo, head), min(fhi, tail)
            if mlo < mhi:
                abuf[mlo - head:mhi - head] = fb[mlo - flo:mhi - flo]
            if flo < head:
                edges.append((flo, fb[:min(fhi, head) - flo]))
            if fhi > tail:
                tlo = max(flo, tail)
                edges.append((tlo, fb[tlo - flo:]))
        try:
            pwrite_direct(dfd, abuf, head)
        except OSError:
            # a filesystem that opened O_DIRECT but refuses the transfer
            # (alignment quirk): rewrite the whole group buffered
            return super()._write_group(plan, g, buffers, store)
        if edges:
            # ragged head/tail bytes: small buffered writes — the direct
            # region is page-aligned on both sides, so the dirtied edge
            # pages never overlap the direct extent
            fd = store.fd(sf, writable=True)
            for off, chunk in edges:
                _pwrite_all(fd, memoryview(chunk), off)


ENGINES = {
    "memmap": MemmapEngine,
    "pread": PreadEngine,
    "overlapped": OverlappedPreadEngine,
    "uring": UringEngine,
    "odirect": ODirectEngine,
}

#: engines whose spec accepts a ":<depth>" queue-depth suffix
_DEPTH_ENGINES = {"overlapped", "uring"}
_DEFAULT_DEPTHS = {"overlapped": DEFAULT_QUEUE_DEPTH,
                   "uring": DEFAULT_URING_DEPTH}

_instances: dict = {}
_instances_lock = threading.Lock()


def validate_engine_spec(engine) -> str:
    """Validate an engine spec *including* ``"auto"`` and return it
    normalized to a string.  Raises ``ValueError`` on anything unknown —
    callers (benchmark harnesses, CLIs) use this to fail loudly instead of
    silently falling back to a default engine.
    """
    if isinstance(engine, IOEngine):
        return engine.name
    name = str(engine)
    base, sep, arg = name.partition(":")
    if sep:
        if base not in _DEPTH_ENGINES:
            raise ValueError(f"engine {engine!r} takes no ':<depth>' "
                             f"argument")
        try:
            depth = int(arg)
        except ValueError:
            raise ValueError(f"bad queue depth in engine spec {engine!r}")
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
    if base != "auto" and base not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of "
                         f"{sorted(ENGINES) + ['auto']} or an IOEngine "
                         f"instance")
    return name


def get_engine(engine, **kwargs) -> IOEngine:
    """Resolve an engine spec: an :class:`IOEngine` instance (returned
    as-is), or a registry name — ``"memmap"``, ``"pread"``, ``"overlapped"``,
    ``"uring"``, ``"odirect"`` (``"overlapped:<depth>"`` / ``"uring:<depth>"``
    set the queue depth; other constructor knobs pass as kwargs).

    Named engines are process-wide singletons keyed on the *resolved*
    ``(name, kwargs)`` pair — ``"overlapped"`` and ``"overlapped:8"`` share
    one instance (one submission pool), while differently-configured
    requests (another depth, an unregistered-buffer uring) get distinct
    instances instead of silently sharing a mis-sized pool.  A spec-string
    depth that contradicts an explicit ``depth=`` kwarg is an error, not a
    silent preference.
    """
    if isinstance(engine, IOEngine):
        return engine
    name = str(engine)
    if name.partition(":")[0] == "auto":
        raise ValueError("engine 'auto' is resolved per plan by Dataset "
                         "(pass engine='auto' to Dataset.create/open or to "
                         "read_planned/write_planned), not by get_engine")
    if ":" in name:
        name, arg = name.split(":", 1)
        if name not in _DEPTH_ENGINES:
            raise ValueError(f"engine {engine!r} takes no ':<depth>' "
                             f"argument")
        spec_depth = int(arg)
        if spec_depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {spec_depth}")
        if "depth" in kwargs and int(kwargs["depth"]) != spec_depth:
            raise ValueError(f"conflicting queue depths: spec {engine!r} "
                             f"vs depth={kwargs['depth']}")
        kwargs = dict(kwargs)
        kwargs["depth"] = spec_depth
    if name in _DEPTH_ENGINES:
        kwargs = dict(kwargs)
        kwargs.setdefault("depth", _DEFAULT_DEPTHS[name])
    cls = ENGINES.get(name)
    if cls is None:
        raise ValueError(f"unknown engine {engine!r}; one of "
                         f"{sorted(ENGINES)} or an IOEngine instance")
    key = (name, tuple(sorted(kwargs.items())))
    with _instances_lock:
        inst = _instances.get(key)
        if inst is None:
            inst = _instances[key] = cls(**kwargs)
        return inst


def resolve_engine(engine, dirpath: str | None = None,
                   **kwargs) -> tuple:
    """:func:`get_engine` plus kernel feature detection:
    returns ``(engine, fallback_reason)`` where ``fallback_reason`` is
    ``""`` when the spec resolved as requested.

    ``uring`` degrades to ``overlapped`` (same queue depth) where
    ``io_uring`` is unavailable (old kernel, seccomp, sysctl); ``odirect``
    degrades to ``pread`` where ``dirpath``'s filesystem refuses
    ``O_DIRECT`` (tmpfs).  The reason string is what Dataset sessions
    surface as ``ReadStats.engine_reason`` so fallbacks are observable,
    never silent.  With ``dirpath=None`` the odirect probe is skipped —
    the engine still degrades per group internally, it just can't report.
    """
    if isinstance(engine, IOEngine):
        return engine, ""
    name = str(engine)
    base, sep, arg = name.partition(":")
    if base == "uring":
        ok, why = uring_available()
        if not ok:
            spec = "overlapped" + (f":{arg}" if sep else "")
            kw = {k: v for k, v in kwargs.items() if k == "depth"}
            return get_engine(spec, **kw), f"uring -> overlapped: {why}"
    elif base == "odirect" and dirpath is not None:
        ok, why = odirect_available(dirpath)
        if not ok:
            return get_engine("pread"), f"odirect -> pread: {why}"
    return get_engine(engine, **kwargs), ""
