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
  transfers in flight at once on a persistent submission pool.

The kernel-bypass engines ``uring`` and ``odirect`` are not ported yet (S6
in ``ROADMAP.md`` queue 1): :func:`validate_engine_spec` accepts their
spellings, :func:`get_engine` refuses them, and :func:`resolve_engine`
degrades them as the reference does on a host without io_uring or
O_DIRECT — ``uring[:d]`` to ``overlapped[:d]``, ``odirect`` to ``pread`` —
with a reason every stats record carries.

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
from .format import subfile_name
from .planner import ReadPlan, WritePlan

__all__ = ["IOEngine", "MemmapEngine", "PreadEngine",
           "OverlappedPreadEngine", "SubfileStore", "WriteStats",
           "ENGINES", "get_engine", "resolve_engine", "validate_engine_spec",
           "assemble_chunk", "scatter_row"]

#: Linux caps one preadv/pwritev at IOV_MAX iovecs
_IOV_MAX = 1024

#: default queue depth of the overlapped engine
DEFAULT_QUEUE_DEPTH = 8


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

    def close(self) -> None:
        # every cached handle is closed even if one close raises (EIO on
        # flush): stopping at the first failure would leak the rest
        with self._lock:
            first_exc = None
            for fd in list(self._fds.values()):
                try:
                    os.close(fd)
                except OSError as e:
                    if first_exc is None:
                        first_exc = e
            self._fds.clear()
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


ENGINES = {
    "memmap": MemmapEngine,
    "pread": PreadEngine,
    "overlapped": OverlappedPreadEngine,
}

#: engines whose spec accepts a ":<depth>" queue-depth suffix
_DEPTH_ENGINES = {"overlapped", "uring"}
#: the reference's kernel-bypass engines, not ported yet: each degrades to
#: the engine the reference falls back to without kernel support, and why
_NOT_PORTED = {"uring": ("overlapped", "io_uring engine not ported yet (S6)"),
               "odirect": ("pread", "O_DIRECT engine not ported yet (S6)")}

_instances: dict = {}
_instances_lock = threading.Lock()


def validate_engine_spec(engine) -> str:
    """Validate an engine spec *including* ``"auto"`` and the reference's
    kernel-bypass spellings (``"uring[:<depth>]"``, ``"odirect"``), and
    return it normalized to a string.  Raises ``ValueError`` on anything
    unknown — callers use this to fail loudly instead of silently falling
    back to a default engine.
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
    if base != "auto" and base not in ENGINES and base not in _NOT_PORTED:
        raise ValueError(f"unknown engine {engine!r}; one of "
                         f"{sorted([*ENGINES, *_NOT_PORTED]) + ['auto']} or "
                         f"an IOEngine instance")
    return name


def get_engine(engine, **kwargs) -> IOEngine:
    """Resolve an engine spec: an :class:`IOEngine` instance (returned
    as-is), or a registry name — ``"memmap"``, ``"pread"``, ``"overlapped"``
    (``"overlapped:<depth>"`` sets the queue depth).  ``"auto"`` is the
    session's to resolve, per plan; ``"uring"`` and ``"odirect"`` raise
    ``NotImplementedError`` (S6: use :func:`resolve_engine`, which
    degrades them).

    Named engines are process-wide singletons keyed on the resolved
    ``(name, kwargs)`` pair, so ``"overlapped"`` and ``"overlapped:8"``
    share one submission pool.  A spec-string depth that contradicts an
    explicit ``depth=`` kwarg is an error.
    """
    if isinstance(engine, IOEngine):
        return engine
    name = str(engine)
    base = name.partition(":")[0]
    if base == "auto":
        raise ValueError("engine 'auto' is resolved per plan by Dataset "
                         "(pass engine='auto' to Dataset.create/open or to "
                         "read_planned/write_planned), not by get_engine")
    if base in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet: it waits for the "
            f"kernel-bypass engines (S6 in ROADMAP.md queue 1); "
            f"resolve_engine degrades it to {_NOT_PORTED[base][0]!r}")
    if ":" in name:
        name, arg = name.split(":", 1)
        if name != "overlapped":
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
    if name == "overlapped":
        kwargs = dict(kwargs)
        kwargs.setdefault("depth", DEFAULT_QUEUE_DEPTH)
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
    """:func:`get_engine` plus the reference's degrade path: returns
    ``(engine, fallback_reason)``, ``fallback_reason`` ``""`` when the spec
    resolved as requested.

    ``uring[:<depth>]`` degrades to ``overlapped[:<depth>]`` and
    ``odirect`` to ``pread`` — what the reference does on a host without
    io_uring or O_DIRECT — because neither engine is ported yet (S6); the
    reason names it.  ``dirpath`` is accepted for the reference's
    signature (its O_DIRECT probe is per filesystem)."""
    if isinstance(engine, IOEngine):
        return engine, ""
    name = str(engine)
    base, sep, arg = name.partition(":")
    if base in _NOT_PORTED:
        validate_engine_spec(name)
        fallback, why = _NOT_PORTED[base]
        kw = {k: v for k, v in kwargs.items() if k == "depth"}
        return get_engine(fallback + (f":{arg}" if sep else ""), **kw), \
            f"{base} -> {fallback}: {why}"
    return get_engine(engine, **kwargs), ""
