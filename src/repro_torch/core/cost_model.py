"""Cost models for layout reorganization and engine selection.

Two related models live here:

1. the paper's **resource-utilization model** for online vs. post-hoc
   layout reorganization (§5.2, Table 1/2) — ``StagingTimings`` and the
   ``*_utilization`` / ``breakeven_*`` functions below;
2. the **per-engine cost model** behind ``engine="auto"``:
   an :class:`EngineCalibration` measured by a short micro-probe against
   the actual storage target (:func:`probe_storage`), persisted as
   ``calibration.json`` next to ``index.json``, and
   :func:`choose_engine`, which predicts per-engine wall time from plan
   shape (coalesced groups, contiguous runs, bytes) and picks an engine
   plus a queue depth.

Symbols (paper Table 1):
  t_c   computation time between two outputs
  t_w() time to write one output to the PFS (writer-dependent)
  t_r() time to read one output back from the PFS
  t_s() time to stage one output (simulation -> staging nodes)
  n, p  compute nodes / processes-per-node used by the simulation
  m, q  nodes / processes-per-node used for reorganization (staging)
  S     size of each output;  N  number of outputs
  U     resource utilization in node-seconds (chip-seconds on TPU)

Model (paper §5.2):
  post-hoc:   U_p = n*N*(t_c + t_w(n,p,S)) + m*(t_r(m,q,N*S) + t_w(m,q,N*S))
              with the paper's measured linearity t_x(m,q,N*S) = N * t_x(m,q,S).
  on-the-fly, non-blocking (t_s + t_w_m <= t_c):
              U_o = (n+m) * (N*t_c + t_s + t_w_m)
  on-the-fly, blocking (t_s + t_w_m > t_c):
              U_o = (n+m) * (t_c + N*(t_s + t_w_m))

The PAPER_TIMINGS fixture is Table 2 verbatim; the worked examples in the
paper (N>=26 break-even at t_c=40; post-hoc always wins at t_c=20; the
31.66 < t_c < 33 window; the t_c bound for N>=50) are reproduced by the
functions below.

A copy of the JAX package's cost model: the same calibrations give the same
predictions, choices and ``calibration.json``.  The kernel-bypass engines
(``uring``, ``odirect``) are not ported yet (S6 in ``ROADMAP.md`` queue 1),
so this copy's probes always leave their "unsupported" sentinels, exactly
as the reference's do on a host without io_uring or O_DIRECT; an injected
calibration that carries their terms still prices them, and the session
then degrades the choice (:func:`repro_torch.io.engine.resolve_engine`).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import mmap
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["StagingTimings", "PAPER_TIMINGS", "posthoc_utilization",
           "onthefly_utilization", "is_blocking", "breakeven_outputs",
           "tc_lower_bound_blocking", "tc_upper_bound_nonblocking",
           "recommend",
           # engine selection
           "EngineCalibration", "EngineChoice", "CALIBRATION_NAME",
           "CALIBRATION_TTL_S", "CALIBRATION_VERSION",
           "SUPPORTED_CALIBRATION_VERSIONS", "URING_REG_AMORT",
           "FALLBACK_CALIBRATION", "probe_storage",
           "save_calibration", "load_calibration", "storage_calibration",
           "predict_seconds", "choose_engine", "predict_best_seconds",
           # lifecycle scoring
           "REORG_CHUNK_OVERHEAD_S", "predict_lifecycle_seconds",
           "predict_best_seconds_batch",
           # learned reorg overhead
           "REORG_STATS_NAME", "ReorgStats", "observe_reorg_overhead",
           "load_reorg_stats", "load_reorg_overhead",
           # recalibrate-on-drift
           "CalibrationDrift", "invalidate_calibration"]


@dataclasses.dataclass(frozen=True)
class StagingTimings:
    """Measured per-output timings for a fixed (n,p,m,q,S) setup."""

    t_s: float        # stage one output, sim nodes -> staging nodes
    t_w_stage: float  # staging nodes write one (reorganized) output
    t_w_sim: float    # sim nodes write one output directly (write-optimized)
    t_r_stage: float  # staging nodes read one output back (post-hoc path)
    n: int            # simulation nodes
    m: int            # staging nodes


#: Table 2 (Summit, WarpX, S = 256 GB, n=256,p=6,m=2,q=32)
PAPER_TIMINGS = StagingTimings(t_s=19.4, t_w_stage=13.6, t_w_sim=1.4,
                               t_r_stage=11.1, n=256, m=2)


def is_blocking(t: StagingTimings, t_c: float) -> bool:
    return t.t_s + t.t_w_stage > t_c


def posthoc_utilization(t: StagingTimings, t_c: float, N: int) -> float:
    return (t.n * N * (t_c + t.t_w_sim)
            + t.m * N * (t.t_r_stage + t.t_w_stage))


def onthefly_utilization(t: StagingTimings, t_c: float, N: int) -> float:
    pipe = t.t_s + t.t_w_stage
    if pipe <= t_c:                       # non-blocking
        return (t.n + t.m) * (N * t_c + pipe)
    return (t.n + t.m) * (t_c + N * pipe)  # blocking: sim stalls each output


def breakeven_outputs(t: StagingTimings, t_c: float,
                      n_max: int = 10_000_000) -> int | None:
    """Smallest N with U_o < U_p (paper: N >= 26 for t_c=40), else None.

    Closed form: both U's are affine in N, so solve a*N + b < c*N.
    """
    pipe = t.t_s + t.t_w_stage
    c = t.n * (t_c + t.t_w_sim) + t.m * (t.t_r_stage + t.t_w_stage)
    if pipe <= t_c:
        a, b = (t.n + t.m) * t_c, (t.n + t.m) * pipe
    else:
        a, b = (t.n + t.m) * pipe, (t.n + t.m) * t_c
    if a >= c:
        return None                       # on-the-fly never catches up
    n = math.floor(b / (c - a)) + 1       # smallest integer with a*n+b < c*n
    return n if n <= n_max else None


def tc_lower_bound_blocking(t: StagingTimings) -> float:
    """In the blocking regime, U_o < U_p eventually requires
    t_c > (n+m)*pipe - n*t_w_sim - m*(t_r+t_w) ) / n   (paper: 31.66 s)."""
    pipe = t.t_s + t.t_w_stage
    return ((t.n + t.m) * pipe - t.n * t.t_w_sim
            - t.m * (t.t_r_stage + t.t_w_stage)) / t.n


def tc_upper_bound_nonblocking(t: StagingTimings, N: int) -> float:
    """Non-blocking regime: largest t_c so that U_o < U_p for given N.

    From (n+m)(N t_c + pipe) < n N (t_c + t_w_sim) + m N (t_r + t_w):
        t_c < (n*t_w_sim*N + m*(t_r+t_w)*N - (n+m)*pipe) / (m*N)
    (paper's worked example: with Table 2 numbers and N=50 the bound
    evaluates to 118.76 s; the paper prints 150.26 — an arithmetic slip in
    the paper, its own formula (407.8N-8514)/(2N) gives 118.76 at N=50.)
    """
    pipe = t.t_s + t.t_w_stage
    num = t.n * t.t_w_sim * N + t.m * (t.t_r_stage + t.t_w_stage) * N \
        - (t.n + t.m) * pipe
    return num / (t.m * N)


# ---------------------------------------------------------------------------
# Per-engine cost model + storage micro-probe (engine="auto")
# ---------------------------------------------------------------------------

#: file persisted next to index.json
CALIBRATION_NAME = "calibration.json"
#: v2 added the kernel-bypass terms (uring_*/odirect_*); v3
#: the per-codec compress/decompress bandwidths (*_comp_bps /
#: *_decomp_bps)
CALIBRATION_VERSION = 3
#: persisted versions that still load: an older file is *not* stale — its
#: new fields default to the "unsupported" sentinels, so the kernel-bypass
#: engines (v1) and compressed-layout candidates (v2) simply don't compete
#: until the TTL re-probe upgrades it
SUPPORTED_CALIBRATION_VERSIONS = (1, 2, 3)
#: persisted calibrations older than this are re-probed
CALIBRATION_TTL_S = 7 * 24 * 3600.0
#: probe file size — small enough that calibration costs tens of ms
PROBE_BYTES = 4 << 20
#: queue depths `choose_engine` evaluates for the overlapped/uring engines
DEPTH_CANDIDATES = (2, 4, 8, 16, 32)
#: plans a uring ring + registered-buffer pool setup amortizes over when
#: its one-time cost is charged per plan — small plans shouldn't pay the
#: whole setup, long sessions shouldn't pretend it was free
URING_REG_AMORT = 64

#: disambiguates concurrent probe scratch files within one process
_probe_counter = itertools.count()

#: per-group submission-pool handoff cost (submit + worker wakeup) charged
#: to the overlapped engine: when the probe measures no parallel benefit
#: and per-group latency is already tiny, this is what makes serial pread
#: win — overlap must buy more than its bookkeeping
DISPATCH_OVERHEAD_S = 25e-6


@dataclasses.dataclass(frozen=True)
class EngineCalibration:
    """Measured storage behavior of one dataset directory's device.

    All quantities come from :func:`probe_storage`'s micro-probe against a
    scratch file in the dataset directory, so they reflect the *actual*
    storage target — page-cache-hot local disk and genuinely cold network
    storage yield very different constants, which is exactly what makes the
    engine choice flip between regimes.
    """

    seek_latency_s: float           # one small random pread (seek + syscall)
    preadv_group_overhead_s: float  # extra cost of a vectored group call
    seq_read_bps: float             # sequential pread bandwidth
    seq_write_bps: float            # sequential buffered pwrite bandwidth
    memmap_bps: float               # bulk copy through a memory map
    page_miss_s: float              # one page touch through a map (C speed)
    parallel_scaling: float         # measured speedup of 4-way threaded reads
    probe_bytes: int = PROBE_BYTES
    created_at: float = 0.0         # wall-clock seconds (time.time())
    version: int = CALIBRATION_VERSION
    memmap_write_bps: float = 0.0   # store into fresh (fault-on-dirty) pages;
    # 0.0 (a pre-field calibration.json) falls back to memmap_bps
    # -- kernel-bypass terms (v2); negative sentinel = the probe
    # found no support, so the engine never competes under this calibration
    uring_sqe_s: float = -1.0       # per-SQE cost of a batched small read
    uring_reg_s: float = 0.0        # ring + registered-buffer pool setup
    odirect_seq_read_bps: float = -1.0   # O_DIRECT sequential read (device)
    odirect_seq_write_bps: float = -1.0  # O_DIRECT sequential write (device)
    odirect_align_s: float = 0.0    # one aligned 4 KiB direct read — the
    # bounce-block penalty a ragged group edge costs
    # -- per-codec bandwidth terms (v3), measured over a
    # low-entropy probe buffer (logical bytes per second); negative
    # sentinel = the codec is unavailable in this process, so compressed
    # candidates carrying it predict inf and never win
    zlib_comp_bps: float = -1.0
    zlib_decomp_bps: float = -1.0
    lz4_comp_bps: float = -1.0
    lz4_decomp_bps: float = -1.0

    def codec_bps(self, codec: str, direction: str = "read") -> float:
        """Measured bandwidth of ``codec`` for this direction (decompress
        on reads, compress on writes); ``-1.0`` when unmeasured or
        unavailable, ``inf`` for the identity codec."""
        if codec == "none":
            return math.inf
        return float(getattr(self, f"{codec}_decomp_bps" if direction ==
                             "read" else f"{codec}_comp_bps", -1.0))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "EngineCalibration":
        fields = {f.name for f in dataclasses.fields(EngineCalibration)}
        return EngineCalibration(**{k: v for k, v in d.items()
                                    if k in fields})

    def age_s(self, now: float | None = None) -> float:
        return (time.time() if now is None else now) - self.created_at

    def is_stale(self, max_age_s: float = CALIBRATION_TTL_S,
                 now: float | None = None) -> bool:
        return (self.version not in SUPPORTED_CALIBRATION_VERSIONS
                or self.age_s(now) > max_age_s or self.age_s(now) < 0)


@dataclasses.dataclass(frozen=True)
class EngineChoice:
    """The selection-decision record surfaced through Read/WriteStats."""

    engine: str                 # engine spec, e.g. "memmap" / "overlapped:8"
    depth: int | None           # queue depth when overlapped was picked
    predicted_seconds: float
    predictions: dict           # engine spec -> predicted seconds
    reason: str                 # human-readable why


def _timed_calls(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def probe_storage(dirpath: str,
                  probe_bytes: int = PROBE_BYTES) -> EngineCalibration:
    """Micro-probe ``dirpath``'s storage: write a scratch file, measure
    sequential read/write bandwidth, small-random-read latency, vectored
    group-call overhead, memory-map bandwidth/page-touch cost, and the
    achieved speedup of 4-way threaded reads.  The scratch file is removed
    before returning.  Total cost is tens of milliseconds.
    """
    # unique scratch name: concurrent probes (two sessions, two processes,
    # a shared temp dir) must never truncate each other's file mid-mmap
    path = os.path.join(dirpath, f".calibration_probe.{os.getpid()}."
                                 f"{next(_probe_counter)}.bin")
    rng = random.Random(0x5EED)
    chunk = os.urandom(1 << 20)
    nchunks = max(1, probe_bytes // len(chunk))
    size = nchunks * len(chunk)
    fd = None
    try:
        # sequential buffered write bandwidth (engines don't fsync by
        # default, so neither does the probe's timed section)
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
        t0 = time.perf_counter()
        for _ in range(nchunks):
            os.write(fd, chunk)
        seq_write_bps = size / max(time.perf_counter() - t0, 1e-9)

        # sequential read bandwidth (1 MiB preads)
        t0 = time.perf_counter()
        off = 0
        while off < size:
            off += len(os.pread(fd, 1 << 20, off))
        seq_read_bps = size / max(time.perf_counter() - t0, 1e-9)

        # small-random-read latency (seek + syscall)
        offsets = [rng.randrange(0, size - 4096) & ~4095 for _ in range(128)]
        it = iter(offsets * 4)
        seek_latency_s = _timed_calls(lambda: os.pread(fd, 4096, next(it)),
                                      128)

        # vectored group overhead: an 8-iovec preadv vs a single pread
        bufs = [bytearray(4096) for _ in range(8)]
        it2 = iter(offsets * 4)
        if hasattr(os, "preadv"):
            per_group = _timed_calls(
                lambda: os.preadv(fd, bufs, next(it2)), 64)
        else:                        # pragma: no cover - non-posix fallback
            per_group = seek_latency_s
        preadv_group_overhead_s = max(per_group - seek_latency_s, 0.0)

        # memory-map bulk bandwidth + per-page touch cost.  Page touches are
        # measured at C speed (one strided numpy pass over every page), not
        # per Python call — the engines' strided scatters run inside numpy,
        # so Python call overhead must not be attributed to the map.
        import numpy as _np
        mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        t0 = time.perf_counter()
        bytes(mm)
        memmap_bps = size / max(time.perf_counter() - t0, 1e-9)
        view = _np.frombuffer(mm, dtype=_np.uint8)
        pages = view[::4096]
        t0 = time.perf_counter()
        reps = 4
        for _ in range(reps):
            int(pages.sum())
        page_miss_s = (time.perf_counter() - t0) / (reps * len(pages))
        del pages, view       # release buffer exports so the map can close
        mm.close()

        # memory-map store bandwidth into fresh pages: extend the file and
        # dirty never-touched pages through a writable map (fault + zero
        # fill + dirty accounting — the memmap engine's write-side cost)
        os.ftruncate(fd, 2 * size)
        wmm = mmap.mmap(fd, 2 * size)
        try:
            t0 = time.perf_counter()
            wmm[size:2 * size] = b"\0" * size
            memmap_write_bps = size / max(time.perf_counter() - t0, 1e-9)
        finally:
            wmm.close()
        os.ftruncate(fd, size)

        # achieved speedup of 4 concurrent 256 KiB reads vs serial
        read_offs = [rng.randrange(0, size - (1 << 18)) for _ in range(16)]
        t0 = time.perf_counter()
        for o in read_offs:
            os.pread(fd, 1 << 18, o)
        serial = time.perf_counter() - t0
        with ThreadPoolExecutor(max_workers=4) as ex:
            t0 = time.perf_counter()
            list(ex.map(lambda o: os.pread(fd, 1 << 18, o), read_offs))
            threaded = time.perf_counter() - t0
        parallel_scaling = min(8.0, max(1.0, serial / max(threaded, 1e-9)))

        # -- kernel-bypass terms (v2).  Both feature-detect by
        # doing: a failed probe leaves the "unsupported" sentinels, which
        # keeps the engine out of choose_engine's competition entirely.
        uring_sqe_s, uring_reg_s = _probe_uring(fd, offsets)
        (odirect_seq_read_bps, odirect_seq_write_bps,
         odirect_align_s) = _probe_odirect(path + ".direct")

        # -- per-codec bandwidths (v3): CPU-side, no file needed
        codec_bps = _probe_codecs()
    finally:
        if fd is not None:
            os.close(fd)
        try:
            os.unlink(path)
        except OSError:
            pass
    return EngineCalibration(
        seek_latency_s=seek_latency_s,
        preadv_group_overhead_s=preadv_group_overhead_s,
        seq_read_bps=seq_read_bps, seq_write_bps=seq_write_bps,
        memmap_bps=memmap_bps, page_miss_s=page_miss_s,
        parallel_scaling=parallel_scaling, probe_bytes=size,
        created_at=time.time(), memmap_write_bps=memmap_write_bps,
        uring_sqe_s=uring_sqe_s, uring_reg_s=uring_reg_s,
        odirect_seq_read_bps=odirect_seq_read_bps,
        odirect_seq_write_bps=odirect_seq_write_bps,
        odirect_align_s=odirect_align_s,
        zlib_comp_bps=codec_bps.get("zlib", (-1.0, -1.0))[0],
        zlib_decomp_bps=codec_bps.get("zlib", (-1.0, -1.0))[1],
        lz4_comp_bps=codec_bps.get("lz4", (-1.0, -1.0))[0],
        lz4_decomp_bps=codec_bps.get("lz4", (-1.0, -1.0))[1])


def _probe_uring(fd: int, offsets) -> tuple:
    """io_uring submission overhead + registered-buffer setup: ``(-1.0,
    0.0)``, the "unsupported" sentinels, because the io_uring engine is not
    ported yet (S6) — what the reference's probe returns on a host without
    io_uring."""
    return -1.0, 0.0


#: codec-probe buffer size: big enough to amortize call overhead into a
#: stable bandwidth, small enough to keep the probe at a few milliseconds
_CODEC_PROBE_BYTES = 2 << 20


def _probe_codecs() -> dict:
    """Measure each registered codec's compress/decompress bandwidth over
    a low-entropy buffer (quantized-science-data stand-in) — returns
    ``{name: (comp_bps, decomp_bps)}`` for every codec except ``none``.
    Codecs absent from this process simply don't appear, leaving their
    calibration fields at the "unavailable" sentinel."""
    try:
        from .codecs import CODECS, decode
    except Exception:                   # pragma: no cover - import guard
        return {}
    import numpy as _np
    rng = _np.random.default_rng(0x5EED)
    buf = rng.integers(0, 16, size=_CODEC_PROBE_BYTES,
                       dtype=_np.uint8).tobytes()
    out = {}
    for name, codec in CODECS.items():
        if name == "none":
            continue
        try:
            t0 = time.perf_counter()
            enc = codec.compress(buf)
            comp_bps = len(buf) / max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            decode(name, enc, len(buf))
            decomp_bps = len(buf) / max(time.perf_counter() - t0, 1e-9)
        except Exception:               # pragma: no cover - defensive
            continue
        out[name] = (comp_bps, decomp_bps)
    return out


def _probe_odirect(path: str) -> tuple:
    """O_DIRECT sequential bandwidth + aligned-block latency: all-sentinel,
    because the O_DIRECT engine is not ported yet (S6) — what the
    reference's probe returns where the filesystem refuses direct I/O."""
    return -1.0, -1.0, 0.0


def save_calibration(cal: EngineCalibration, dirpath: str) -> None:
    """Persist ``calibration.json`` next to ``index.json`` (atomic replace)."""
    tmp = os.path.join(dirpath, CALIBRATION_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(cal.to_json(), f)
    os.replace(tmp, os.path.join(dirpath, CALIBRATION_NAME))


def load_calibration(dirpath: str,
                     max_age_s: float = CALIBRATION_TTL_S
                     ) -> EngineCalibration | None:
    """Load a persisted calibration; ``None`` when missing, unparseable,
    version-mismatched, or older than ``max_age_s`` (staleness)."""
    path = os.path.join(dirpath, CALIBRATION_NAME)
    try:
        with open(path) as f:
            cal = EngineCalibration.from_json(json.load(f))
    except (OSError, ValueError, TypeError, KeyError):
        return None
    return None if cal.is_stale(max_age_s) else cal


#: one calibration per storage device (st_dev) — datasets on the same
#: filesystem share a probe instead of re-measuring per directory
_device_cache: dict = {}

#: last resort when nothing is probeable (read-only dataset on a read-only
#: machine): hot-page-cache-shaped constants, which make `auto` behave like
#: the historical memmap default — conservative, never a crash
FALLBACK_CALIBRATION = EngineCalibration(
    seek_latency_s=5e-6, preadv_group_overhead_s=2e-6, seq_read_bps=2e9,
    seq_write_bps=1e9, memmap_bps=4e9, page_miss_s=2e-7,
    parallel_scaling=2.0, probe_bytes=0, created_at=0.0)


def storage_calibration(dirpath: str,
                        max_age_s: float = CALIBRATION_TTL_S,
                        probe_bytes: int = PROBE_BYTES,
                        use_cache: bool = True) -> EngineCalibration:
    """The calibration for ``dirpath``: persisted file if fresh, else the
    per-device cache, else a fresh :func:`probe_storage` (persisted
    best-effort).  Never raises for an unprobeable (e.g. read-only
    archival) directory: it falls back to probing scratch space, then to
    :data:`FALLBACK_CALIBRATION` — reads on read-only media must work."""
    cal = load_calibration(dirpath, max_age_s) if use_cache else None
    if cal is not None:
        return cal
    try:
        dev = os.stat(dirpath).st_dev
    except OSError:
        dev = None
    if use_cache and dev is not None:
        cal = _device_cache.get(dev)
        if cal is not None and not cal.is_stale(max_age_s):
            try:                     # persist next to this dataset's index
                save_calibration(cal, dirpath)
            except OSError:
                pass
            return cal
    try:
        cal = probe_storage(dirpath, probe_bytes=probe_bytes)
    except OSError:
        # read-only dataset dir: probe scratch space instead (possibly a
        # different device — still far better than crashing the read path)
        import tempfile
        try:
            cal = probe_storage(tempfile.gettempdir(),
                                probe_bytes=probe_bytes)
        except OSError:
            return FALLBACK_CALIBRATION
        if dev is not None:          # don't re-pay the probe every session
            _device_cache[dev] = cal
        return cal
    if dev is not None:
        _device_cache[dev] = cal
    try:
        save_calibration(cal, dirpath)
    except OSError:                  # read-only dataset dir: stay in-memory
        pass
    return cal


def predict_seconds(cal: EngineCalibration, engine: str, *, groups: int,
                    runs: int, bytes_moved: int, span_bytes: int,
                    direction: str = "read", codec: str = "none",
                    codec_bytes: int = 0) -> float:
    """Predicted wall seconds for one plan execution under ``engine``.

    The model has two terms.  A **latency** term: grouped engines pay one
    device round trip per coalesced group (``seek + preadv overhead``),
    which the overlapped engine divides by its queue depth; the memmap
    engine instead pays one page-touch per contiguous run (page faults are
    what a map pays per discontiguity — measured hot they are tens of
    nanoseconds, on cold storage they cost a full seek).  A **streaming**
    term: grouped reads move ``span_bytes`` through the device sequentially
    plus one memcpy of the payload out of the staging buffer; grouped
    writes stream their span straight from the assembled buffers; memmap
    moves the payload once through the map (reads at ``memmap_bps``, writes
    at ``memmap_write_bps`` — dirtying fresh pages is much slower than
    copying out of warm ones).  The overlapped engine's streaming term is
    divided by the *measured* 4-way ``parallel_scaling`` (clamped to its
    depth) — overlap helps exactly as much as the device/memory system
    actually delivered in the probe.

    The kernel-bypass engines (v2 terms) reuse the same structure.
    ``uring`` is the overlapped shape with the thread-pool handoff
    replaced by the *measured* per-SQE cost plus an amortized share of
    the ring/registered-buffer setup — at low group counts that overhead
    is what keeps it honest against serial ``pread``.  ``odirect``
    streams at the *device* bandwidth the direct probe measured (no page
    cache on either side) but pays a measured aligned-block penalty per
    group — ragged extents are what keep it honest against the buffered
    engines.  Both return ``inf`` when their calibration terms carry the
    "unsupported" sentinel, so they never win where the probe found no
    kernel/filesystem support.

    ``codec``/``codec_bytes`` (v3 terms) add the CPU cost of the codec
    pass — ``codec_bytes`` *logical* bytes decompressed on reads or
    compressed on writes at the measured bandwidth.  The term is
    engine-independent (the bounce-decode runs in the shared scatter, the
    encode before planning), so it shifts every engine's prediction
    equally; an unmeasured or unavailable codec predicts ``inf``, keeping
    compressed candidates out of the competition entirely.
    """
    codec_s = 0.0
    if codec != "none" and codec_bytes > 0:
        cbw = cal.codec_bps(codec, direction)
        if cbw <= 0:
            return math.inf
        codec_s = codec_bytes / cbw
    base, _, arg = engine.partition(":")
    if base == "memmap":
        bw = cal.memmap_bps if direction == "read" else \
            (cal.memmap_write_bps or cal.memmap_bps)
        return runs * cal.page_miss_s + bytes_moved / bw + codec_s
    latency = groups * (cal.seek_latency_s + cal.preadv_group_overhead_s)
    if direction == "read":
        stream = span_bytes / cal.seq_read_bps + bytes_moved / cal.memmap_bps
    else:
        stream = span_bytes / cal.seq_write_bps
    if base == "pread":
        return latency + stream + codec_s
    if base == "overlapped":
        depth = int(arg) if arg else 8
        dd = max(1, min(depth, groups))
        par = max(1.0, min(cal.parallel_scaling, float(dd)))
        return latency / dd + stream / par + groups * DISPATCH_OVERHEAD_S \
            + codec_s
    if base == "uring":
        if cal.uring_sqe_s < 0:
            return math.inf
        depth = int(arg) if arg else 16
        dd = max(1, min(depth, groups))
        par = max(1.0, min(cal.parallel_scaling, float(dd)))
        return (latency / dd + stream / par + groups * cal.uring_sqe_s
                + cal.uring_reg_s / URING_REG_AMORT + codec_s)
    if base == "odirect":
        bw = cal.odirect_seq_read_bps if direction == "read" \
            else cal.odirect_seq_write_bps
        if bw <= 0:
            return math.inf
        # device pass + the payload copy through the bounce buffer (both
        # directions: reads scatter out of it, writes assemble into it)
        stream_d = span_bytes / bw + bytes_moved / cal.memmap_bps
        return groups * (cal.seek_latency_s + cal.odirect_align_s) \
            + stream_d + codec_s
    raise ValueError(f"unknown engine {engine!r}")


def choose_engine(cal: EngineCalibration, *, groups: int, runs: int,
                  bytes_moved: int, span_bytes: int,
                  direction: str = "read",
                  depths: tuple = DEPTH_CANDIDATES,
                  codec: str = "none", codec_bytes: int = 0) -> EngineChoice:
    """Pick the engine (and queue depth) with the lowest predicted wall time
    for a plan of this shape.  Ties prefer the simpler engine (memmap over
    pread over overlapped, shallower queue over deeper).

    >>> cold = EngineCalibration(seek_latency_s=1e-3,
    ...     preadv_group_overhead_s=5e-6, seq_read_bps=2e9,
    ...     seq_write_bps=1e9, memmap_bps=8e9, page_miss_s=1e-3,
    ...     parallel_scaling=8.0, created_at=0.0)
    >>> choose_engine(cold, groups=44, runs=4096, bytes_moved=64 << 20,
    ...               span_bytes=64 << 20).engine
    'overlapped:32'
    >>> hot = EngineCalibration(seek_latency_s=3e-6,
    ...     preadv_group_overhead_s=2e-6, seq_read_bps=4e9,
    ...     seq_write_bps=3e9, memmap_bps=6e9, page_miss_s=3e-7,
    ...     parallel_scaling=2.0, created_at=0.0)
    >>> choose_engine(hot, groups=44, runs=4096, bytes_moved=64 << 20,
    ...               span_bytes=64 << 20).engine
    'memmap'
    """
    if groups <= 0 or bytes_moved <= 0:
        return EngineChoice(engine="memmap", depth=None,
                            predicted_seconds=0.0, predictions={},
                            reason="empty plan")
    shape = dict(groups=groups, runs=runs, bytes_moved=bytes_moved,
                 span_bytes=span_bytes, direction=direction,
                 codec=codec, codec_bytes=codec_bytes)
    preds = {"memmap": predict_seconds(cal, "memmap", **shape),
             "pread": predict_seconds(cal, "pread", **shape)}
    for d in depths:
        preds[f"overlapped:{d}"] = predict_seconds(cal, f"overlapped:{d}",
                                                   **shape)
    # kernel-bypass engines compete only where the probe measured support
    # (sentinel terms predict inf) — auto never selects an engine that
    # would immediately fall back
    if cal.uring_sqe_s >= 0:
        for d in depths:
            preds[f"uring:{d}"] = predict_seconds(cal, f"uring:{d}",
                                                  **shape)
    odirect_bw = cal.odirect_seq_read_bps if direction == "read" \
        else cal.odirect_seq_write_bps
    if odirect_bw > 0:
        preds["odirect"] = predict_seconds(cal, "odirect", **shape)
    best = min(preds, key=lambda k: preds[k])   # insertion order breaks ties
    alts = sorted((k for k in preds if k != best), key=lambda k: preds[k])
    runner = alts[0]
    base, _, arg = best.partition(":")
    reason = (f"{direction} plan: groups={groups} runs={runs} "
              f"bytes={bytes_moved}; predicted {best}="
              f"{preds[best] * 1e3:.3f}ms vs {runner}="
              f"{preds[runner] * 1e3:.3f}ms")
    return EngineChoice(engine=best, depth=int(arg) if arg else None,
                        predicted_seconds=preds[best], predictions=preds,
                        reason=reason)


def predict_best_seconds(cal: EngineCalibration, *, groups: int, runs: int,
                         bytes_moved: int, span_bytes: int,
                         direction: str = "read", codec: str = "none",
                         codec_bytes: int = 0) -> float:
    """Best achievable predicted wall time over all engines for a plan of
    this shape — the per-layout read-cost the layout policy scores candidate layouts with (each candidate is assumed
    to run under whatever engine ``engine="auto"`` would pick for it)."""
    if groups <= 0 or bytes_moved <= 0:
        return 0.0
    return choose_engine(cal, groups=groups, runs=runs,
                         bytes_moved=bytes_moved, span_bytes=span_bytes,
                         direction=direction, codec=codec,
                         codec_bytes=codec_bytes).predicted_seconds


# ---------------------------------------------------------------------------
# Lifecycle scoring: one number for "build this layout, then read
# it back ``expected_reads`` times"
# ---------------------------------------------------------------------------

#: per-target-chunk overhead of materializing a layout through
#: ``reorganize`` / staging: one planned region read (probe + plan + Python
#: dispatch) and one buffer assembly per chunk.  This is what makes a
#: 256-chunk candidate honestly more expensive to *build* than an 8-chunk
#: one even when both move the same bytes — the paper's write-side cost
#: that read-only scoring ignored.  The bytes- and seek-dependent parts of
#: a chunk's build are priced by the gather/write estimates; this covers
#: only the fixed per-call dispatch.  This constant is the *cold-start
#: default*: every ``reorganize`` measures its actual per-chunk dispatch
#: cost and folds it into a persisted :class:`ReorgStats` EMA
#: (:func:`observe_reorg_overhead`), which the layout policy prefers over
#: the constant once observations exist.
REORG_CHUNK_OVERHEAD_S = 5e-5

#: file persisted next to index.json / calibration.json holding the
#: measured per-chunk reorganization overhead
REORG_STATS_NAME = "reorg_stats.json"
REORG_STATS_VERSION = 1
#: EMA weight of each new reorganize observation (recent builds dominate,
#: one outlier cannot swing the estimate)
REORG_STATS_ALPHA = 0.3


@dataclasses.dataclass(frozen=True)
class ReorgStats:
    """Measured per-chunk reorganization overhead for one dataset
    directory, learned across ``reorganize`` runs.

    ``chunk_overhead_s`` is an EMA over observed runs of the *fixed*
    per-target-chunk cost (probe + plan + Python dispatch + buffer
    assembly), i.e. exactly what :data:`REORG_CHUNK_OVERHEAD_S` hard-coded
    before it was learned.  Persisted with the same atomic-replace
    discipline as ``calibration.json``; corrupt or absent files degrade to
    "nothing learned yet".
    """

    chunk_overhead_s: float
    num_observations: int = 0
    updated_at: float = 0.0
    version: int = REORG_STATS_VERSION

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "ReorgStats":
        fields = {f.name for f in dataclasses.fields(ReorgStats)}
        return ReorgStats(**{k: v for k, v in d.items() if k in fields})


def load_reorg_stats(dirpath: str) -> ReorgStats | None:
    """The directory's persisted reorg overhead stats; ``None`` when
    missing, unparseable, version-mismatched, or non-positive."""
    path = os.path.join(dirpath, REORG_STATS_NAME)
    try:
        with open(path) as f:
            st = ReorgStats.from_json(json.load(f))
    except (OSError, ValueError, TypeError, KeyError):
        return None
    if st.version != REORG_STATS_VERSION or not st.chunk_overhead_s > 0 \
            or st.num_observations < 1:
        return None
    return st


def load_reorg_overhead(dirpath: str) -> float | None:
    """The learned per-chunk overhead for ``dirpath``, or ``None`` when no
    reorganize has been measured there yet (callers fall back to
    :data:`REORG_CHUNK_OVERHEAD_S`)."""
    st = load_reorg_stats(dirpath)
    return st.chunk_overhead_s if st is not None else None


def observe_reorg_overhead(dirpath: str, overhead_s: float,
                           num_chunks: int = 1) -> ReorgStats | None:
    """Fold one measured reorganize's per-chunk overhead into the
    directory's persisted EMA (atomic replace; best-effort — read-only
    media degrade to no learning, never an error).  ``overhead_s`` is the
    measured fixed cost *per target chunk*; ``num_chunks`` records how many
    chunks backed the observation (observations from bigger builds are not
    weighted extra — the EMA already favors recency)."""
    if not (overhead_s > 0) or num_chunks < 1:
        return None
    prev = load_reorg_stats(dirpath)
    if prev is None:
        ema = float(overhead_s)
        n = 1
    else:
        ema = (REORG_STATS_ALPHA * float(overhead_s)
               + (1.0 - REORG_STATS_ALPHA) * prev.chunk_overhead_s)
        n = prev.num_observations + 1
    st = ReorgStats(chunk_overhead_s=ema, num_observations=n,
                    updated_at=time.time())
    tmp = os.path.join(dirpath, f"{REORG_STATS_NAME}.tmp.{os.getpid()}."
                                f"{next(_probe_counter)}")
    try:
        with open(tmp, "w") as f:
            json.dump(st.to_json(), f)
        os.replace(tmp, os.path.join(dirpath, REORG_STATS_NAME))
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return st


def predict_best_seconds_batch(cal: EngineCalibration, *,
                               groups, runs, bytes_moved, span_bytes,
                               direction: str = "read",
                               codec: str = "none", codec_bytes=0):
    """Vectorized :func:`predict_best_seconds`: element-wise best-engine
    predicted wall time over arrays of plan shapes (one entry per plan).
    Exactly the scalar model's arithmetic, evaluated with numpy — the
    layout policy prices hundreds of hypothetical gather plans per
    candidate with this.

    ``codec`` is a scalar (one codec per candidate layout) and
    ``codec_bytes`` an array of per-plan logical bytes run through it; the
    codec term is engine-independent, so it is added after the per-engine
    minimum.  An unavailable codec yields ``inf`` for every non-empty
    plan."""
    import numpy as np
    g = np.asarray(groups, dtype=np.float64)
    r = np.asarray(runs, dtype=np.float64)
    b = np.asarray(bytes_moved, dtype=np.float64)
    sp = np.asarray(span_bytes, dtype=np.float64)
    if direction == "read":
        mm = r * cal.page_miss_s + b / cal.memmap_bps
        stream = sp / cal.seq_read_bps + b / cal.memmap_bps
    else:
        mm = r * cal.page_miss_s + b / (cal.memmap_write_bps
                                        or cal.memmap_bps)
        stream = sp / cal.seq_write_bps
    latency = g * (cal.seek_latency_s + cal.preadv_group_overhead_s)
    best = np.minimum(mm, latency + stream)
    for depth in DEPTH_CANDIDATES:
        dd = np.maximum(1.0, np.minimum(float(depth), g))
        par = np.maximum(1.0, np.minimum(cal.parallel_scaling, dd))
        best = np.minimum(best, latency / dd + stream / par
                          + g * DISPATCH_OVERHEAD_S)
        if cal.uring_sqe_s >= 0:
            best = np.minimum(best, latency / dd + stream / par
                              + g * cal.uring_sqe_s
                              + cal.uring_reg_s / URING_REG_AMORT)
    odirect_bw = cal.odirect_seq_read_bps if direction == "read" \
        else cal.odirect_seq_write_bps
    if odirect_bw > 0:
        best = np.minimum(best, g * (cal.seek_latency_s
                                     + cal.odirect_align_s)
                          + sp / odirect_bw + b / cal.memmap_bps)
    if codec != "none":
        cbw = cal.codec_bps(codec, direction)
        cb = np.asarray(codec_bytes, dtype=np.float64)
        best = best + (cb / cbw if cbw > 0 else np.where(cb > 0, math.inf,
                                                         0.0))
    return np.where((g <= 0) | (b <= 0), 0.0, best)


def predict_lifecycle_seconds(cal: EngineCalibration, *,
                              write: dict, reads: float,
                              expected_reads: float = 1.0,
                              num_chunks: int = 0,
                              gather: float = 0.0,
                              chunk_overhead_s: float | None = None
                              ) -> float:
    """Predicted wall seconds of a candidate layout's whole I/O lifecycle:

    ``gather + write_cost + num_chunks * chunk_overhead
    + expected_reads * reads``

    ``write`` is a plan-shape dict (``groups``/``runs``/``bytes_moved``/
    ``span_bytes``) priced as a write under the best engine; ``reads`` is
    the already-priced per-replay cost of the observed read mix against the
    candidate; ``gather`` is the priced cost of pulling the candidate's
    chunk regions out of the *current* layout (zero for staged writes,
    where the data arrives in memory).  ``expected_reads`` is how many
    future mix replays the one-time build cost amortizes over.
    ``chunk_overhead_s`` is the per-target-chunk dispatch cost — pass the
    dataset's *learned* value (:func:`load_reorg_overhead`) when one
    exists; ``None`` falls back to :data:`REORG_CHUNK_OVERHEAD_S`.
    """
    if chunk_overhead_s is None:
        chunk_overhead_s = REORG_CHUNK_OVERHEAD_S
    w = predict_best_seconds(cal, direction="write", **write)
    return (gather + w + max(0, num_chunks) * chunk_overhead_s
            + max(0.0, expected_reads) * reads)


# ---------------------------------------------------------------------------
# Recalibrate-on-drift: invalidate a calibration the measurements
# stopped agreeing with
# ---------------------------------------------------------------------------

#: measured/predicted (either way) beyond this ratio counts as divergent
DRIFT_RATIO = 2.0
#: plans where both predicted and measured are below this are noise —
#: microsecond-scale hot reads jitter far beyond 2x without meaning the
#: calibration is wrong
DRIFT_MIN_SECONDS = 1e-3
#: consecutive divergent plans before the calibration is invalidated
DRIFT_TRIP_COUNT = 5
#: observations ignored after a trip, so one bad probe cannot thrash
#: probe -> trip -> probe every few plans
DRIFT_COOLDOWN = 50


class CalibrationDrift:
    """Tracks predicted-vs-measured agreement of ``engine="auto"`` plans.

    ``note(predicted, measured)`` returns ``True`` when ``trip_count``
    *consecutive* plans diverged by more than ``ratio`` (in either
    direction) above the ``min_seconds`` noise floor — the caller should
    then :func:`invalidate_calibration` so the next auto decision re-probes
    the storage.  A single agreeing plan resets the streak: drift must be
    *persistent*, not sporadic.  Not thread-safe by itself; callers
    serialize (the Dataset session notes under its own accounting).
    """

    def __init__(self, ratio: float = DRIFT_RATIO,
                 min_seconds: float = DRIFT_MIN_SECONDS,
                 trip_count: int = DRIFT_TRIP_COUNT,
                 cooldown: int = DRIFT_COOLDOWN):
        self.ratio = ratio
        self.min_seconds = min_seconds
        self.trip_count = trip_count
        self.cooldown = cooldown
        self._streak = 0
        self._cooldown_left = 0
        self.trips = 0

    def note(self, predicted: float, measured: float) -> bool:
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return False
        if max(predicted, measured) < self.min_seconds:
            return False                       # noise floor: don't count
        lo, hi = sorted((max(predicted, 1e-12), max(measured, 1e-12)))
        if hi / lo > self.ratio:
            self._streak += 1
        else:
            self._streak = 0
        if self._streak >= self.trip_count:
            self._streak = 0
            self._cooldown_left = self.cooldown
            self.trips += 1
            return True
        return False


def invalidate_calibration(dirpath: str) -> None:
    """Drop every cached copy of ``dirpath``'s calibration: the persisted
    ``calibration.json`` and the per-device in-process cache.  The next
    :func:`storage_calibration` call re-probes the storage."""
    try:
        os.unlink(os.path.join(dirpath, CALIBRATION_NAME))
    except OSError:
        pass
    try:
        _device_cache.pop(os.stat(dirpath).st_dev, None)
    except OSError:
        pass


def recommend(t: StagingTimings, t_c: float, N: int) -> dict:
    """Policy decision the asynchronous checkpointer makes: which
    reorganization mode minimizes chip-seconds for this run."""
    u_o = onthefly_utilization(t, t_c, N)
    u_p = posthoc_utilization(t, t_c, N)
    return {
        "on_the_fly": u_o,
        "post_hoc": u_p,
        "blocking": is_blocking(t, t_c),
        "choose": "on_the_fly" if u_o < u_p else "post_hoc",
        "breakeven_N": breakeven_outputs(t, t_c),
    }
