"""Access-pattern telemetry and the lifecycle-aware layout policy — a copy
of the JAX package's module: the same history, calibration and clock give
the same decisions, scores and ``access_log.json``.

The paper's headline claim — "by understanding application I/O patterns and
carefully designing data layouts we can increase read performance by more
than 80%" — needs a feedback loop, not a hard-coded 4x4x4 target.  This
module closes it:

* **Telemetry** — every ``Dataset.read`` / ``read_decomposed`` /
  ``read_pattern`` and every ``CheckpointManager.restore`` appends a compact
  :class:`AccessRecord` (region shape class, runs/groups/bytes, measured vs
  predicted seconds, chosen engine) to an :class:`AccessLog` persisted as
  ``access_log.json`` next to ``index.json``/``calibration.json`` — same
  atomic-replace + version/TTL discipline, bounded ring of
  :data:`ACCESS_LOG_CAPACITY` records.  A corrupt or absent log is simply an
  empty history, never an error.

* **Policy** — :class:`LayoutPolicy.choose_layout` scores every candidate
  layout (``reorganized`` schemes of several chunk-count levels and
  aspects, ``merged_node``, ``chunked``) on its *whole I/O lifecycle*::

      gather + write + num_chunks * overhead + expected_reads * read_mix

  The read term prices the observed pattern mix against the candidate via
  :func:`estimate_read_shape` (the planner's exact run/group/coalescing
  formulas, evaluated against a hypothetical chunking) and
  :func:`repro_torch.core.cost_model.predict_best_seconds`; the build terms come
  from :func:`estimate_write_shape` (the ``WritePlan``-shape analog) priced
  as a write, plus — when the current stored extents are known, i.e. for
  post-hoc ``reorganize`` — the cost of gathering each candidate chunk out
  of the *current* layout.  A layout that wins the read matrix can still
  lose end-to-end once its build cost is charged; that is the paper's
  central write-vs-read tradeoff, now inside the decision.

* **Weighting** — records are weighted by recency (exponential decay,
  half-life :data:`ACCESS_RECENCY_HALF_LIFE_S`) and by *measured cost*
  (an access that took 50 ms steers harder than one that took 50 µs)
  instead of pure frequency; ``expected_reads`` — how many future mix
  replays amortize the one-time build — defaults to the decayed record
  mass of the history.

* **Cross-run priors** — :meth:`AccessLog.export_prior` snapshots a run's
  history; :meth:`LayoutPolicy.with_prior` seeds a *fresh* dataset's (or a
  new checkpoint root's) decision from it.  Prior records carry
  :data:`PRIOR_MASS` total weight that decays as live telemetry
  accumulates, so yesterday's pattern steers the cold start and today's
  measurements take over.

``reorganize(..., layout="auto", prior=...)``, ``StagingExecutor.submit(...,
plan="auto")`` and ``CheckpointManager(strategy="auto")`` all route through
this object; with no usable history every path degrades to the
dimension-aware default scheme with the reason recorded
(``PolicyDecision.reason``).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Iterable, Sequence

import numpy as np

from .blocks import Block, regular_decomposition
from .cost_model import (EngineCalibration, FALLBACK_CALIBRATION,
                         load_calibration, load_reorg_overhead,
                         predict_best_seconds_batch,
                         predict_lifecycle_seconds)
from .layouts import LayoutPlan, default_reorg_scheme, plan_layout
from .read_patterns import best_decompositions

__all__ = ["ACCESS_LOG_NAME", "ACCESS_LOG_CAPACITY", "ACCESS_LOG_TTL_S",
           "ACCESS_PRIOR_NAME", "ACCESS_RECENCY_HALF_LIFE_S", "PRIOR_MASS",
           "AccessRecord", "AccessLog", "load_prior_records",
           "classify_region", "estimate_read_shape", "estimate_write_shape",
           "estimate_gather_shapes", "append_extent_offsets",
           "candidate_schemes", "PolicyDecision", "LayoutPolicy"]

#: file persisted next to index.json / calibration.json
ACCESS_LOG_NAME = "access_log.json"
ACCESS_LOG_VERSION = 1
#: default filename of an exported cross-run prior snapshot
ACCESS_PRIOR_NAME = "access_prior.json"
#: bounded ring: at most this many records survive in the file
ACCESS_LOG_CAPACITY = 256
#: records older than this are dropped at load time (stale access history
#: should not steer today's layout)
ACCESS_LOG_TTL_S = 30 * 24 * 3600.0

#: recency weighting: a record this old counts half as much as a fresh one
ACCESS_RECENCY_HALF_LIFE_S = 7 * 24 * 3600.0
#: cost-weighting floor: untimed records (and sub-10µs page-cache blips)
#: all weigh this much, so a history without measurements degrades to the
#: pure-frequency behavior
MIN_RECORD_COST_S = 1e-5
#: total live-record-equivalents a cross-run prior starts with; its share
#: is PRIOR_MASS / (PRIOR_MASS + n_live), so live telemetry takes over as
#: it accumulates
PRIOR_MASS = 8.0

#: an axis covered at or below this fraction of its extent reads as "thin"
THIN_FRAC = 0.25

#: a codec must save at least this fraction of stored bytes (measured
#: ratio <= 1 - MIN_CODEC_SAVING) to become a layout candidate — below it
#: the "win" is whole-chunk-fetch seek geometry, not compression
MIN_CODEC_SAVING = 0.05

#: disambiguates concurrent atomic-replace temp files (two sessions, two
#: processes): each writer replaces from its own temp name, so the log file
#: itself is always one complete JSON document
_tmp_counter = itertools.count()


def classify_region(region: Block, global_shape: Sequence[int]) -> str:
    """Human-readable shape class of a read region: ``whole_domain``,
    ``sub_area``, ``slab(axis=d)`` (thin along one axis — the paper's
    plane patterns), ``pencil(axis=d)`` (wide along one axis only), or
    ``thin(axes=...)`` / ``point`` for the remaining corners.  Rank-generic:
    works for 1-D..N-D variables."""
    fracs = [(h - l) / max(1, g)
             for l, h, g in zip(region.lo, region.hi, global_shape)]
    nd = len(fracs)
    thin = [d for d, f in enumerate(fracs) if f <= THIN_FRAC]
    if not thin:
        return "whole_domain" if min(fracs) >= 0.999 else "sub_area"
    if len(thin) == nd:
        return "point"
    if len(thin) == 1:
        return f"slab(axis={thin[0]})"
    if len(thin) == nd - 1:
        wide = next(d for d in range(nd) if d not in thin)
        return f"pencil(axis={wide})"
    return "thin(axes=" + ",".join(str(d) for d in thin) + ")"


@dataclasses.dataclass(frozen=True)
class AccessRecord:
    """One observed access: the pattern fingerprint the policy learns from."""

    var: str
    kind: str                    # "read" | "restore"
    shape_class: str             # classify_region() of the read region
    lo: tuple                    # region bounds (exact — scoring intersects
    hi: tuple                    # them with candidate chunk grids)
    runs: int = 0                # contiguous byte runs of the executed plan
    groups: int = 0              # coalesced groups actually issued
    nbytes: int = 0              # payload bytes moved
    seconds: float = 0.0         # measured wall seconds
    predicted_seconds: float = 0.0   # cost-model prediction (engine="auto")
    engine: str = ""             # engine spec that executed the plan
    ts: float = 0.0              # wall clock (time.time()) at record time
    source: str = "live"         # "live" | "prior" (loaded cross-run)
    #: tenant namespace (multi-tenant read service); "" = untagged legacy
    #: records and single-reader sessions.  The policy always scores the
    #: AGGREGATE mix across tenants — the tag exists so per-tenant slices
    #: can be inspected and exported (``export_prior(tenant=...)``), never
    #: so one tenant's traffic overwrites another's.
    tenant: str = ""

    @property
    def ndim(self) -> int:
        return len(self.lo)

    @property
    def region(self) -> Block:
        return Block(tuple(self.lo), tuple(self.hi))

    def to_json(self) -> dict:
        d = {"var": self.var, "kind": self.kind, "cls": self.shape_class,
             "lo": [int(v) for v in self.lo],
             "hi": [int(v) for v in self.hi],
             "runs": int(self.runs), "groups": int(self.groups),
             "bytes": int(self.nbytes), "sec": float(self.seconds),
             "pred": float(self.predicted_seconds), "eng": self.engine,
             "ts": float(self.ts)}
        if self.source != "live":      # pre-prior files stay byte-compatible
            d["src"] = self.source
        if self.tenant:                # untagged records stay byte-compatible
            d["tn"] = self.tenant
        return d

    @staticmethod
    def from_json(d: dict) -> "AccessRecord":
        return AccessRecord(var=d["var"], kind=d["kind"],
                            shape_class=d["cls"], lo=tuple(d["lo"]),
                            hi=tuple(d["hi"]), runs=d.get("runs", 0),
                            groups=d.get("groups", 0),
                            nbytes=d.get("bytes", 0),
                            seconds=d.get("sec", 0.0),
                            predicted_seconds=d.get("pred", 0.0),
                            engine=d.get("eng", ""), ts=d.get("ts", 0.0),
                            source=d.get("src", "live"),
                            tenant=d.get("tn", ""))

    @classmethod
    def from_stats(cls, var: str, kind: str, region: Block,
                   global_shape: Sequence[int], stats,
                   tenant: str = "", ts: float | None = None
                   ) -> "AccessRecord":
        """Fingerprint one executed read: ``stats`` is any object with the
        ``ReadStats`` telemetry fields (runs/groups/bytes_read/seconds/
        predicted_seconds/engine) — the one constructor both the Dataset
        session and the checkpoint restore path record through.
        ``tenant`` namespaces the record for multi-tenant serving; ``ts``
        pins the record time (replay drives a deterministic clock through
        here; trace replay, S3, is not ported yet)."""
        return cls(var=var, kind=kind,
                   shape_class=classify_region(region, global_shape),
                   lo=tuple(int(v) for v in region.lo),
                   hi=tuple(int(v) for v in region.hi),
                   runs=stats.runs, groups=stats.groups,
                   nbytes=stats.bytes_read, seconds=stats.seconds,
                   predicted_seconds=stats.predicted_seconds,
                   engine=stats.engine,
                   ts=time.time() if ts is None else float(ts),
                   tenant=tenant)


class AccessLog:
    """Bounded, persistent ring of :class:`AccessRecord` s for one dataset
    directory (``access_log.json``).

    Durability discipline matches ``calibration.json``: atomic
    rename-replace from a writer-unique temp file, a version field, and a
    TTL applied at load.  Each flush re-reads the file, merges, trims to
    ``capacity`` and replaces — concurrent writers (staging workers and
    reader threads, or two processes) can lose each other's most recent
    in-flight records on an exact race, but the file is always one complete
    JSON document.  ``flush_every > 1`` batches appends in memory (the
    per-read telemetry mode: a hot read must not pay a full ring rewrite),
    at the cost of up to ``flush_every - 1`` in-flight records on a crash;
    :meth:`flush` drains the buffer and is called by ``Dataset.flush`` /
    ``close``.  All I/O errors degrade to "no history": telemetry must
    never break a read path.
    """

    def __init__(self, dirpath: str, capacity: int = ACCESS_LOG_CAPACITY,
                 max_age_s: float = ACCESS_LOG_TTL_S,
                 flush_every: int = 1, clock=None):
        self.dirpath = dirpath
        self.capacity = capacity
        self.max_age_s = max_age_s
        self.flush_every = max(1, flush_every)
        #: time source for the load-time TTL; replay injects a
        #: deterministic clock so records stamped against a fixed epoch
        #: are not TTL-killed by the real wall clock
        self.clock = clock if clock is not None else time.time
        self._pending: list = []
        self._lock = threading.Lock()

    @property
    def path(self) -> str:
        return os.path.join(self.dirpath, ACCESS_LOG_NAME)

    def load(self) -> list:
        """Records currently on disk (oldest first).  Corrupt, absent,
        version-mismatched files and stale records all degrade to []."""
        try:
            with open(self.path) as f:
                payload = json.load(f)
            if payload.get("version") != ACCESS_LOG_VERSION:
                return []
            recs = [AccessRecord.from_json(r) for r in payload["records"]]
        except (OSError, ValueError, TypeError, KeyError):
            return []
        now = self.clock()
        return [r for r in recs if 0 <= now - r.ts <= self.max_age_s]

    def _save(self, recs: list) -> None:
        payload = {"version": ACCESS_LOG_VERSION,
                   "records": [r.to_json() for r in recs]}
        tmp = os.path.join(
            self.dirpath,
            f"{ACCESS_LOG_NAME}.tmp.{os.getpid()}.{next(_tmp_counter)}")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def append(self, rec: AccessRecord) -> None:
        self.extend([rec])

    def extend(self, recs: Iterable[AccessRecord]) -> None:
        recs = list(recs)
        if not recs:
            return
        with self._lock:
            self._pending.extend(recs)
            if len(self._pending) >= self.flush_every:
                self._flush_locked()

    def flush(self) -> None:
        """Persist any buffered records (no-op when the buffer is empty)."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        try:
            merged = (self.load() + self._pending)[-self.capacity:]
            self._save(merged)
            self._pending.clear()
        except OSError:
            # read-only media: telemetry is optional; cap the dead buffer
            del self._pending[:-self.capacity]

    def records(self, var: str | None = None,
                tenant: str | None = None) -> list:
        """History slice: ``var`` filters by variable, ``tenant`` by the
        multi-tenant namespace tag (``""`` selects untagged records;
        ``None`` — the default — returns the aggregate mix across all
        tenants, which is what layout decisions score)."""
        with self._lock:
            recs = (self.load() + self._pending)[-self.capacity:]
        if var is not None:
            recs = [r for r in recs if r.var == var]
        if tenant is not None:
            recs = [r for r in recs if r.tenant == tenant]
        return recs

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def export_prior(self, path: str | None = None,
                     tenant: str | None = None) -> str:
        """Snapshot the current history (disk + pending) as a *cross-run
        prior*: a plain JSON file a future run's
        :meth:`LayoutPolicy.with_prior` can seed its decisions from.
        Returns the path written (default ``access_prior.json`` in the log's
        directory).  ``tenant`` restricts the snapshot to one tenant's
        traffic (default: the aggregate mix).  Unlike the live ring, a
        prior is a one-shot artifact — TTL does not apply to it at load
        time; its influence decays against live telemetry instead
        (:data:`PRIOR_MASS`)."""
        recs = self.records(tenant=tenant)
        if path is None:
            path = os.path.join(self.dirpath, ACCESS_PRIOR_NAME)
        payload = {"version": ACCESS_LOG_VERSION, "prior": True,
                   "records": [r.to_json() for r in recs]}
        tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


def load_prior_records(path: str, now: float | None = None) -> list:
    """Load a cross-run prior: ``path`` is an :meth:`AccessLog.export_prior`
    snapshot, a raw ``access_log.json``, or a dataset/checkpoint directory
    containing one.  Records come back marked ``source="prior"`` and
    re-stamped to ``now`` — a prior's age is *not* the individual records'
    wall-clock age (that would TTL-kill any prior older than a month);
    decay against live telemetry is the policy's job.  Corrupt, absent or
    version-mismatched files degrade to ``[]``, never an error."""
    if os.path.isdir(path):
        prior = os.path.join(path, ACCESS_PRIOR_NAME)
        path = prior if os.path.exists(prior) \
            else os.path.join(path, ACCESS_LOG_NAME)
    ts = time.time() if now is None else now
    try:
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != ACCESS_LOG_VERSION:
            return []
        recs = [AccessRecord.from_json(r) for r in payload["records"]]
    except (OSError, ValueError, TypeError, KeyError):
        return []
    return [dataclasses.replace(r, ts=ts, source="prior") for r in recs]


# ---------------------------------------------------------------------------
# Plan-shape estimation for a hypothetical chunking (no I/O, no index)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanShapeEstimate:
    """What a plan against a candidate chunk set would look like."""

    groups: int          # coalesced groups the plan would issue (without
    #                      extent offsets: chunks touched, an upper bound)
    runs: int            # contiguous byte runs (cold-storage seeks)
    bytes_needed: int    # payload bytes
    span_bytes: int      # bytes spanned inside the touched groups

    def shape_kwargs(self) -> dict:
        """The :func:`repro_torch.core.cost_model.predict_seconds` plan-shape
        keywords for this estimate."""
        return dict(groups=self.groups, runs=self.runs,
                    bytes_moved=self.bytes_needed,
                    span_bytes=self.span_bytes)


def append_extent_offsets(nbytes: np.ndarray, subfiles: np.ndarray,
                          align: int | None = None,
                          base_offsets: dict | None = None) -> np.ndarray:
    """Byte offset each extent would get from a log-structured append —
    the exact assignment :func:`repro_torch.io.planner.build_write_plan` makes:
    per subfile, in input order, each start aligned up to ``align`` on top
    of the (aligned-up) base offset."""
    m = len(nbytes)
    a = int(align) if align else 1
    aligned_nb = -(-np.asarray(nbytes, dtype=np.int64) // a) * a
    subfiles = np.asarray(subfiles, dtype=np.int64)
    stable = np.argsort(subfiles, kind="stable")
    s_sorted = subfiles[stable]
    new_seg = np.concatenate(([True], s_sorted[1:] != s_sorted[:-1])) \
        if m else np.empty(0, dtype=bool)
    seg_first = np.flatnonzero(new_seg)
    cs = np.cumsum(aligned_nb[stable]) - aligned_nb[stable]
    seg_id = np.cumsum(new_seg.astype(np.int64)) - 1 if m \
        else np.empty(0, dtype=np.int64)
    base = np.zeros(len(seg_first), dtype=np.int64)
    if base_offsets:
        for i, f in enumerate(seg_first):
            b = int(base_offsets.get(int(s_sorted[f]), 0))
            base[i] = -(-b // a) * a
    starts_sorted = base[seg_id] + (cs - cs[seg_first][seg_id])
    file_lo = np.empty(m, dtype=np.int64)
    file_lo[stable] = starts_sorted
    return file_lo


def _coalesce(subf: np.ndarray, file_lo: np.ndarray, file_hi: np.ndarray):
    """Sort extents by ``(subfile, offset)`` and coalesce byte-adjacent
    ones, exactly like both planners.  Returns ``(order, group_count,
    span_bytes, adjacent_mask)`` — ``adjacent_mask[i]`` marks sorted row
    ``i+1`` starting exactly at sorted row ``i``'s end within one group."""
    m = len(subf)
    order = np.lexsort((file_lo, subf))
    s_o, lo_o, hi_o = subf[order], file_lo[order], file_hi[order]
    new_group = np.empty(m, dtype=bool)
    new_group[0] = True
    if m > 1:
        new_group[1:] = (s_o[1:] != s_o[:-1]) | (lo_o[1:] > hi_o[:-1])
    bounds = np.concatenate((np.flatnonzero(new_group), [m]))
    span = int((hi_o[bounds[1:] - 1] - lo_o[bounds[:-1]]).sum())
    adjacent = (~new_group[1:]) & (lo_o[1:] == hi_o[:-1]) if m > 1 \
        else np.empty(0, dtype=bool)
    return order, len(bounds) - 1, span, adjacent


def estimate_read_shape(chunk_los: np.ndarray, chunk_his: np.ndarray,
                        region: Block, itemsize: int,
                        subfiles: np.ndarray | None = None,
                        offsets: np.ndarray | None = None
                        ) -> PlanShapeEstimate:
    """Analytic plan shape of reading ``region`` from chunks stored
    row-major — the same trailing fully-covered-suffix run formula
    :func:`repro_torch.io.planner.build_read_plan` evaluates on real plans, but
    against a *hypothetical* chunking, so candidate layouts can be priced
    without writing a byte.

    With ``subfiles``/``offsets`` (per-chunk extent placement — real
    ``VarRows`` columns, or :func:`append_extent_offsets` for a chunking
    that does not exist yet) the estimate additionally reproduces the
    planner's cross-chunk behavior bit-for-bit: extents sorted by
    ``(subfile, offset)``, byte-adjacent extents coalesced into groups,
    adjacent chunks' boundary runs merged, span measured per group.
    Without them, each touched chunk counts as its own group and runs
    never merge across chunks (an upper bound, exact for isolated chunks).
    """
    lo = np.asarray(region.lo, dtype=np.int64)
    hi = np.asarray(region.hi, dtype=np.int64)
    ilo = np.maximum(chunk_los, lo)
    ihi = np.minimum(chunk_his, hi)
    hit = (ilo < ihi).all(axis=1)
    m = int(hit.sum())
    if m == 0:
        return PlanShapeEstimate(0, 0, 0, 0)
    ilo, ihi = ilo[hit], ihi[hit]
    clos, chis = chunk_los[hit], chunk_his[hit]
    s = ihi - ilo                        # (m, d) intersection shape
    cshape = chis - clos                 # (m, d) chunk shape
    nd = s.shape[1]

    # trailing fully-covered suffix length per chunk: a run extends over the
    # covered suffix axes plus one partially-covered axis above them
    covered = s == cshape
    suffix = np.zeros(m, dtype=np.int64)
    still = np.ones(m, dtype=bool)
    for d in range(nd - 1, -1, -1):
        still = still & covered[:, d]
        suffix += still
    first_covered = nd - suffix          # j: first axis of the suffix
    runs_per = np.ones(m, dtype=np.int64)
    for d in range(nd):
        runs_per = np.where(d < first_covered - 1, runs_per * s[:, d],
                            runs_per)

    # byte span between the first and last touched element of each chunk
    strides = np.ones((m, nd), dtype=np.int64)
    for d in range(nd - 2, -1, -1):
        strides[:, d] = strides[:, d + 1] * cshape[:, d + 1]
    first = ((ilo - clos) * strides).sum(axis=1)
    last = ((ihi - 1 - clos) * strides).sum(axis=1)
    bytes_needed = int(s.prod(axis=1).sum() * itemsize)

    if offsets is None:
        return PlanShapeEstimate(
            groups=m, runs=int(runs_per.sum()), bytes_needed=bytes_needed,
            span_bytes=int((last - first + 1).sum() * itemsize))

    off = np.asarray(offsets, dtype=np.int64)[hit]
    subf = (np.zeros(m, dtype=np.int64) if subfiles is None
            else np.asarray(subfiles, dtype=np.int64)[hit])
    file_lo = off + first * itemsize
    file_hi = off + (last + 1) * itemsize
    order, groups, span, adjacent = _coalesce(subf, file_lo, file_hi)
    # a chunk's LAST run ends at its file_hi and the next chunk's FIRST run
    # starts at its file_lo: byte-adjacent extents merge one run
    runs = int(runs_per[order].sum() - adjacent.sum())
    return PlanShapeEstimate(groups=groups, runs=runs,
                             bytes_needed=bytes_needed, span_bytes=span)


def estimate_gather_shapes(src_los: np.ndarray, src_his: np.ndarray,
                           tgt_los: np.ndarray, tgt_his: np.ndarray,
                           itemsize: int) -> tuple:
    """Batched placement-free read estimates: for every target region
    (candidate chunk) at once, the plan shape of gathering it out of the
    ``src`` extents.  Returns ``(groups, runs, bytes_needed, span_bytes)``
    arrays, one entry per target — the per-chunk gather cost ``reorganize``
    pays to build a candidate, priced in one numpy pass instead of one
    :func:`estimate_read_shape` call per chunk.  Like the offset-free
    scalar estimate, cross-extent coalescing is not modeled (an upper
    bound on groups/runs; payload bytes are exact).  Work proceeds in
    bounded target batches, so a fine source decomposition times a large
    candidate pool cannot balloon the ``(m, n, d)`` intermediates."""
    src_los = np.asarray(src_los, dtype=np.int64)     # (n, d)
    src_his = np.asarray(src_his, dtype=np.int64)
    tgt_los = np.asarray(tgt_los, dtype=np.int64)     # (m, d)
    tgt_his = np.asarray(tgt_his, dtype=np.int64)
    m, d = tgt_los.shape
    n = len(src_los)
    # cap each batch's (batch, n, d) intermediates at ~2M elements
    batch = max(1, (2 << 20) // max(1, n * d))
    if m > batch:
        parts = [estimate_gather_shapes(src_los, src_his,
                                        tgt_los[i:i + batch],
                                        tgt_his[i:i + batch], itemsize)
                 for i in range(0, m, batch)]
        return tuple(np.concatenate([p[k] for p in parts])
                     for k in range(4))
    ilo = np.maximum(src_los[None, :, :], tgt_los[:, None, :])   # (m, n, d)
    ihi = np.minimum(src_his[None, :, :], tgt_his[:, None, :])
    s = ihi - ilo
    hit = (s > 0).all(axis=2)                                    # (m, n)
    s = np.where(hit[:, :, None], s, 0)
    cshape = np.broadcast_to(src_his - src_los, s.shape)

    covered = s == cshape
    suffix = np.zeros(hit.shape, dtype=np.int64)
    still = np.ones(hit.shape, dtype=bool)
    for dd in range(d - 1, -1, -1):
        still = still & covered[:, :, dd]
        suffix += still
    first_covered = d - suffix
    runs_pair = np.ones(hit.shape, dtype=np.int64)
    for dd in range(d):
        runs_pair = np.where(dd < first_covered - 1,
                             runs_pair * s[:, :, dd], runs_pair)

    strides = np.ones(s.shape, dtype=np.int64)
    for dd in range(d - 2, -1, -1):
        strides[:, :, dd] = strides[:, :, dd + 1] * cshape[:, :, dd + 1]
    first = ((ilo - src_los[None]) * strides).sum(axis=2)
    last = ((ihi - 1 - src_los[None]) * strides).sum(axis=2)
    span_pair = np.where(hit, last - first + 1, 0)

    groups = hit.sum(axis=1).astype(np.int64)
    runs = np.where(hit, runs_pair, 0).sum(axis=1)
    bytes_needed = s.prod(axis=2).sum(axis=1) * itemsize
    span_bytes = span_pair.sum(axis=1) * itemsize
    return groups, runs, bytes_needed, span_bytes


def estimate_write_shape(chunk_los: np.ndarray, chunk_his: np.ndarray,
                         itemsize: int, *,
                         subfiles: np.ndarray | None = None,
                         num_subfiles: int = 1,
                         align: int | None = None,
                         base_offsets: dict | None = None
                         ) -> PlanShapeEstimate:
    """Analytic :class:`~repro_torch.io.planner.WritePlan` shape of materializing
    a chunking — the write-side mirror of :func:`estimate_read_shape`, so
    candidate layouts can be priced as *writes* without planning one.

    Reproduces :func:`repro_torch.io.planner.build_write_plan` exactly for the
    same inputs: append offsets per subfile (alignment folded in), extents
    sorted by ``(subfile, offset)`` and byte-adjacent ones coalesced.
    ``subfiles`` defaults to the round-robin assignment ``plan_layout``
    gives ``reorganized`` layouts (``chunk_id % num_subfiles``).  In the
    estimate, ``groups`` is the plan's coalesced group count, ``runs`` its
    extent count (every extent is one contiguous write), ``bytes_needed``
    its payload and ``span_bytes`` its group span.
    """
    chunk_los = np.asarray(chunk_los, dtype=np.int64)
    chunk_his = np.asarray(chunk_his, dtype=np.int64)
    m = len(chunk_los)
    if m == 0:
        return PlanShapeEstimate(0, 0, 0, 0)
    nbytes = (chunk_his - chunk_los).prod(axis=1) * itemsize
    subf = (np.arange(m, dtype=np.int64) % max(1, int(num_subfiles))
            if subfiles is None else np.asarray(subfiles, dtype=np.int64))
    file_lo = append_extent_offsets(nbytes, subf, align=align,
                                    base_offsets=base_offsets)
    _, groups, span, _ = _coalesce(subf, file_lo, file_lo + nbytes)
    return PlanShapeEstimate(groups=groups, runs=m,
                             bytes_needed=int(nbytes.sum()),
                             span_bytes=span)


def candidate_schemes(ndim: int, global_shape: Sequence[int],
                      target_chunks: int = 64) -> list:
    """Candidate regular decompositions: the dimension-aware default first
    (ties fall back to it), then every factorization of ``target_chunks``
    over ``ndim`` axes (all aspect ratios, slab- through pencil-shaped),
    the maximally-fine single-axis slab split per axis, and — because
    lifecycle scoring can prefer *cheaper to build* over *fastest to read*
    — the same factorization sweep at coarser chunk-count levels
    (``target_chunks/8``, ``/64``, ... while at least two chunks remain;
    for the default target of 64 that adds the 8-chunk sweep).  Coarser
    still is covered by the ``merged_node``/``chunked`` candidates the
    policy also scores.  Axis splits are clamped to the axis extents;
    duplicates are removed."""
    def clamp(s):
        return tuple(min(int(f), max(1, int(g)))
                     for f, g in zip(s, global_shape))

    default = default_reorg_scheme(ndim, target_chunks, global_shape)
    seen = {default}
    out = [default]
    pool = []
    level = target_chunks
    while level >= 2:
        pool += [clamp(s) for s in best_decompositions(level, ndim=ndim)]
        level //= 8
    for d in range(ndim):
        slab = [1] * ndim
        slab[d] = target_chunks
        pool.append(clamp(tuple(slab)))
    for s in sorted(pool):
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# The policy object
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PolicyDecision:
    """One layout choice and everything needed to audit it."""

    strategy: str                # "reorganized" | "merged_node" | "chunked"
    scheme: tuple | None         # K-way scheme when strategy == "reorganized"
    layout: LayoutPlan
    reason: str                  # human-readable: mix -> scores -> choice
    scores: dict                 # candidate name -> predicted lifecycle s
    num_records: int             # access records the decision is based on
    mix: dict                    # shape-class -> weight fraction
    read_scores: dict = dataclasses.field(default_factory=dict)
    #: candidate -> one-time build cost (gather + write + per-chunk
    #: overhead); empty when write cost was not charged
    write_scores: dict = dataclasses.field(default_factory=dict)
    expected_reads: float = 0.0  # mix replays the build cost amortized over
    num_prior_records: int = 0   # how many of num_records came from a prior
    #: per-chunk codec of the winning candidate ("none" = raw extents) —
    #: the second layout dimension scored jointly with chunking
    codec: str = "none"

    def to_json(self) -> dict:
        return {"strategy": self.strategy,
                "scheme": list(self.scheme) if self.scheme else None,
                "codec": self.codec,
                "reason": self.reason, "num_records": self.num_records,
                "num_prior_records": self.num_prior_records,
                "expected_reads": round(float(self.expected_reads), 3),
                "mix": {k: round(v, 4) for k, v in self.mix.items()},
                "scores": {k: float(v) for k, v in self.scores.items()},
                "read_scores": {k: float(v)
                                for k, v in self.read_scores.items()},
                "write_scores": {k: float(v)
                                 for k, v in self.write_scores.items()}}


class LayoutPolicy:
    """Lifecycle-aware layout decision-maker, fed by an :class:`AccessLog`.

    ``choose_layout(var, blocks, global_shape)`` returns a
    :class:`PolicyDecision` whose ``layout`` is ready for ``plan_write`` /
    staging / post-hoc reorganization.  Candidates are scored on the whole
    lifecycle — one-time build cost (gather from the current layout when
    its extents are known, write, per-chunk overhead) plus
    ``expected_reads`` replays of the observed mix — with records weighted
    by recency and measured cost.  With no usable access history the
    decision degrades to the dimension-aware default ``reorganized`` scheme
    and says so in ``reason`` — the pre-policy behavior, now recorded.

    ``records`` injects history directly (tests, docs); ``calibration``
    pins the storage constants the scoring predicts with (default: the
    dataset's persisted ``calibration.json`` when the policy was built via
    :meth:`for_dataset`, else :data:`~repro_torch.core.cost_model.
    FALLBACK_CALIBRATION`).  ``include_write_cost=False`` restores the
    read-only v1 scoring (used as the comparison baseline in benchmarks);
    ``expected_reads`` pins the amortization horizon instead of deriving
    it from the history's decayed record mass.  :meth:`with_prior` attaches
    a previous run's history whose weight decays as live telemetry
    accumulates.
    """

    def __init__(self, log: AccessLog | None = None,
                 records: Sequence[AccessRecord] | None = None,
                 calibration: EngineCalibration | None = None,
                 target_chunks: int = 64,
                 prior_records: Sequence[AccessRecord] | None = None,
                 include_write_cost: bool = True,
                 expected_reads: float | None = None,
                 half_life_s: float = ACCESS_RECENCY_HALF_LIFE_S,
                 chunk_overhead_s: float | None = None,
                 cost_weighting: bool = True):
        self.log = log
        self._records = list(records) if records is not None else None
        self.calibration = calibration or FALLBACK_CALIBRATION
        self.target_chunks = target_chunks
        self.prior_records = list(prior_records) if prior_records else []
        self.include_write_cost = include_write_cost
        self.expected_reads = expected_reads
        self.half_life_s = half_life_s
        #: weight records by measured cost (the default); ``False`` scores
        #: pure frequency — trace replay pins this off so nondeterministic
        #: wall times cannot perturb an otherwise deterministic decision
        self.cost_weighting = cost_weighting
        #: learned per-chunk metadata/bookkeeping cost charged by lifecycle
        #: scoring; ``None`` falls back to the static
        #: :data:`~repro_torch.core.cost_model.REORG_CHUNK_OVERHEAD_S`
        self.chunk_overhead_s = chunk_overhead_s

    @classmethod
    def for_dataset(cls, dirpath: str,
                    calibration: EngineCalibration | None = None,
                    target_chunks: int = 64, clock=None,
                    **kwargs) -> "LayoutPolicy":
        """Policy over ``dirpath``'s own access log, predicting with its
        persisted calibration when one is fresh (no probe is triggered —
        policy evaluation stays I/O-free) and the per-chunk overhead
        *measured* by previous ``reorganize`` runs over this dataset
        (``reorg_stats.json``) when one exists.  ``clock`` threads a time
        source into the log's TTL check (deterministic replay)."""
        kwargs.setdefault("chunk_overhead_s", load_reorg_overhead(dirpath))
        return cls(log=AccessLog(dirpath, clock=clock),
                   calibration=calibration or load_calibration(dirpath),
                   target_chunks=target_chunks, **kwargs)

    def with_prior(self, path: str | None) -> "LayoutPolicy":
        """A copy of this policy seeded with a cross-run prior: ``path`` is
        an :meth:`AccessLog.export_prior` snapshot, a raw
        ``access_log.json``, or a directory holding either (a previous
        run's dataset or checkpoint root).  ``None`` or an unreadable file
        degrade to no prior.  Prior records carry :data:`PRIOR_MASS` total
        weight split among them, shrinking as live records accumulate."""
        prior = load_prior_records(path) if path is not None else []
        return LayoutPolicy(log=self.log, records=self._records,
                            calibration=self.calibration,
                            target_chunks=self.target_chunks,
                            prior_records=prior,
                            include_write_cost=self.include_write_cost,
                            expected_reads=self.expected_reads,
                            half_life_s=self.half_life_s,
                            chunk_overhead_s=self.chunk_overhead_s,
                            cost_weighting=self.cost_weighting)

    # -- history -------------------------------------------------------------
    def records(self) -> list:
        """Live records followed by any attached cross-run prior records."""
        if self._records is not None:
            live = list(self._records)
        else:
            live = self.log.records() if self.log is not None else []
        return live + self.prior_records

    def records_for(self, var: str, ndim: int,
                    global_shape: Sequence[int] | None = None) -> list:
        """This variable's records; when it has none, records of same-rank
        variables whose regions *fit inside this variable's shape* (a fresh
        variable inherits the dataset's overall read behavior — but a
        region recorded against a larger variable's coordinates is
        geometrically meaningless here and is excluded rather than scored
        against empty intersections)."""
        recs = [r for r in self.records() if r.ndim == ndim]
        own = [r for r in recs if r.var == var]
        if own:
            return own
        if global_shape is None:
            return recs
        return [r for r in recs
                if all(h <= g for h, g in zip(r.hi, global_shape))]

    # -- weighting -----------------------------------------------------------
    def record_weights(self, records: Sequence[AccessRecord],
                       now: float | None = None,
                       with_cost: bool = True) -> np.ndarray:
        """Per-record weights: exponential recency decay (half-life
        ``half_life_s``) × measured cost (floored at
        :data:`MIN_RECORD_COST_S`, so untimed histories degrade to pure
        frequency) × the prior mass share for ``source == "prior"``
        records.  ``with_cost=False`` drops the cost factor (used when
        estimating *how many* future reads to expect — an expensive read is
        not more reads)."""
        if not records:
            return np.empty(0)
        now = time.time() if now is None else now
        ts = np.asarray([r.ts for r in records], dtype=np.float64)
        w = 0.5 ** (np.clip(now - ts, 0.0, None) / max(self.half_life_s,
                                                       1e-9))
        if with_cost and self.cost_weighting:
            secs = np.asarray([r.seconds for r in records], dtype=np.float64)
            # square-root damping: an access 100x more expensive steers 10x
            # harder, not 100x — the candidate pricing already charges each
            # region's cost, so the record weight is an importance prior,
            # not a second cost term
            w = w * np.sqrt(np.maximum(secs, MIN_RECORD_COST_S)
                            / MIN_RECORD_COST_S)
        prior = np.asarray([r.source == "prior" for r in records])
        n_prior = int(prior.sum())
        if n_prior:
            n_live = len(records) - n_prior
            # the whole prior carries PRIOR_MASS live-record-equivalents,
            # melting away as live telemetry accumulates
            share = PRIOR_MASS / (PRIOR_MASS + n_live)
            live_mass = max(float(w[~prior].sum()), 1.0) if n_live else 1.0
            prior_mass = float(w[prior].sum())
            if prior_mass > 0:
                scale = share * live_mass / ((1.0 - share) * prior_mass) \
                    if n_live else 1.0
                w = np.where(prior, w * scale, w)
        return w

    def effective_reads(self, records: Sequence[AccessRecord],
                        now: float | None = None) -> float:
        """Decayed record mass of the history — the default
        ``expected_reads`` horizon: how many mix replays the one-time build
        cost should amortize over, estimated as "about as many as were
        recently observed"."""
        w = self.record_weights(records, now=now, with_cost=False)
        return max(1.0, float(w.sum()))

    def pattern_mix(self, records: Sequence[AccessRecord],
                    now: float | None = None) -> list:
        """Aggregate records into a weighted region mix:
        ``[(weight, Block, shape_class)]`` with weights summing to 1,
        recency/cost/prior-weighted via :meth:`record_weights`.  Groups are
        keyed and ordered by region bounds, so the mix — and every score
        summed over it — is invariant under record permutation."""
        weights = self.record_weights(records, now=now)
        groups: dict = {}
        for r, w in zip(records, weights):
            key = (tuple(r.lo), tuple(r.hi))
            if key in groups:
                groups[key][0] += float(w)
            else:
                groups[key] = [float(w), r.region, r.shape_class]
        total = sum(g[0] for g in groups.values())
        if total <= 0:
            total = 1.0
        return [(groups[k][0] / total, groups[k][1], groups[k][2])
                for k in sorted(groups)]

    @staticmethod
    def _estimate_itemsize(records: Sequence[AccessRecord]) -> int:
        sizes = []
        for r in records:
            vol = r.region.volume
            if vol > 0 and r.nbytes > 0:
                sizes.append(max(1, min(16, round(r.nbytes / vol))))
        if not sizes:
            return 4
        sizes.sort()
        return sizes[len(sizes) // 2]

    # -- the decision --------------------------------------------------------
    def choose_layout(self, var: str, blocks: Sequence[Block],
                      global_shape: Sequence[int], *,
                      num_stagers: int = 1, num_procs: int | None = None,
                      procs_per_node: int = 1,
                      expected_reads: float | None = None,
                      include_write_cost: bool | None = None,
                      align: int | None = None,
                      current_extents=None,
                      codec_ratios: dict | None = None,
                      now: float | None = None) -> PolicyDecision:
        """Score every candidate layout on its lifecycle and return the
        winner.

        ``expected_reads`` pins the amortization horizon (default: derived
        from the history via :meth:`effective_reads`);
        ``include_write_cost=False`` scores reads only (the v1 behavior);
        ``align`` is the write alignment the build would use;
        ``current_extents`` — a :class:`~repro_torch.io.format.VarRows` (or any
        object with ``los``/``his``/``subfiles``/``offsets`` arrays) naming
        where the variable's chunks live *now* — additionally charges each
        candidate the cost of gathering its chunk regions out of the
        current layout, which is what post-hoc ``reorganize`` actually
        pays per target chunk; ``codec_ratios`` maps codec names to their
        *measured* stored/logical size ratio on this variable's data and
        makes the codec a second layout dimension: every chunking
        candidate is also scored once per codec (writes shrink by the
        ratio but pay compression; reads fetch whole stored extents and
        pay decompression), and the winner's codec lands in
        :attr:`PolicyDecision.codec` (``None`` keeps v3 behavior — raw
        extents only); ``now`` pins the recency-decay reference
        time (tests, reproducible decisions)."""
        blocks = list(blocks)
        global_shape = tuple(int(g) for g in global_shape)
        ndim = len(global_shape)
        if num_procs is None:
            num_procs = max([b.owner for b in blocks] + [0]) + 1
        cal = self.calibration
        if include_write_cost is None:
            include_write_cost = self.include_write_cost

        def reorg_plan(scheme):
            return plan_layout("reorganized", blocks, num_procs,
                               procs_per_node=procs_per_node,
                               global_shape=global_shape,
                               reorg_scheme=scheme, num_stagers=num_stagers)

        default = default_reorg_scheme(ndim, self.target_chunks, global_shape)

        def default_decision(why: str) -> PolicyDecision:
            return PolicyDecision(
                strategy="reorganized", scheme=default,
                layout=reorg_plan(default),
                reason=(f"{why} for {var!r}: "
                        f"default {'x'.join(map(str, default))} scheme"),
                scores={}, num_records=0, mix={})

        recs = self.records_for(var, ndim, global_shape)
        if not recs:
            return default_decision("no usable access history")

        if now is None:
            now = time.time()
        mix = self.pattern_mix(recs, now=now)
        itemsize = self._estimate_itemsize(recs)
        if expected_reads is None:
            expected_reads = self.expected_reads
        if expected_reads is None:
            expected_reads = self.effective_reads(recs, now=now)

        # candidates: (name, strategy, scheme, los, his, subfiles, layout)
        nsub = max(1, num_stagers)
        candidates = []
        for scheme in candidate_schemes(ndim, global_shape,
                                        self.target_chunks):
            targets = regular_decomposition(global_shape, scheme)
            los = np.asarray([t.lo for t in targets], dtype=np.int64)
            his = np.asarray([t.hi for t in targets], dtype=np.int64)
            # same round-robin subfile assignment plan_layout makes
            subf = np.arange(len(targets), dtype=np.int64) % nsub
            name = "reorganized" + "x".join(map(str, scheme))
            candidates.append((name, "reorganized", scheme, los, his, subf,
                               None))
        for strat in ("merged_node", "chunked"):
            try:
                lay = plan_layout(strat, blocks, num_procs,
                                  procs_per_node=procs_per_node,
                                  global_shape=global_shape)
            except (ValueError, IndexError):
                continue
            los = np.asarray([c.chunk.lo for c in lay.chunks],
                             dtype=np.int64)
            his = np.asarray([c.chunk.hi for c in lay.chunks],
                             dtype=np.int64)
            subf = np.asarray([c.subfile for c in lay.chunks],
                              dtype=np.int64)
            candidates.append((strat, strat, None, los, his, subf, lay))

        # gather term: one concatenated vectorized pass prices every
        # per-chunk gather read every candidate's build would issue
        gather_for: dict = {}
        if include_write_cost and current_extents is not None:
            cur_los = np.asarray(current_extents.los, dtype=np.int64)
            cur_his = np.asarray(current_extents.his, dtype=np.int64)
            all_los = np.concatenate([c[3] for c in candidates])
            all_his = np.concatenate([c[4] for c in candidates])
            gg, gr, gb, gs = estimate_gather_shapes(cur_los, cur_his,
                                                    all_los, all_his,
                                                    itemsize)
            per_chunk = predict_best_seconds_batch(
                cal, groups=gg, runs=gr, bytes_moved=gb, span_bytes=gs)
            bounds = np.cumsum([0] + [len(c[3]) for c in candidates])
            sums = np.add.reduceat(per_chunk, bounds[:-1])
            gather_for = {c[0]: float(s) for c, s in zip(candidates, sums)}

        # read term: estimate every (candidate, region) plan shape, then
        # price the whole matrix through ONE vectorized cost-model pass —
        # the per-pair engine sweep (the expensive Python part of scoring)
        # runs once over len(candidates) * len(mix) rows instead of once
        # per pair; the batch pricer is element-exact vs the scalar one,
        # so decisions are bit-identical to the per-pair loop
        ests = [estimate_read_shape(los, his, region, itemsize,
                                    subfiles=subf,
                                    offsets=append_extent_offsets(
                                        (his - los).prod(axis=1) * itemsize,
                                        subf, align=align))
                for _, _, _, los, his, subf, _ in candidates
                for _weight, region, _cls in mix]
        prices = predict_best_seconds_batch(
            cal,
            groups=np.asarray([e.groups for e in ests], dtype=np.int64),
            runs=np.asarray([e.runs for e in ests], dtype=np.int64),
            bytes_moved=np.asarray([e.bytes_needed for e in ests],
                                   dtype=np.int64),
            span_bytes=np.asarray([e.span_bytes for e in ests],
                                  dtype=np.int64))

        # codec dimension: a compressed extent can only be decoded whole,
        # so a codec variant's read plan fetches the full stored extent of
        # every chunk the region touches (groups = runs = hit chunks, span
        # = ratio-scaled whole-chunk bytes) and decompresses the whole
        # logical chunk; one batch pricing pass per codec
        # a codec with an exclusion sentinel in the calibration (never
        # probed, or the library is absent) is not a candidate at all —
        # admitting it would only produce inf/nan audit entries.  A codec
        # that saves less than MIN_CODEC_SAVING is dropped too: near-1.0
        # ratios can still "win" purely through the whole-chunk-fetch
        # geometry (fewer seeks), and compression should never be chosen
        # as a seek-avoidance trick on incompressible data
        codec_items = []
        if codec_ratios:
            codec_items = [(n, float(r))
                           for n, r in sorted(codec_ratios.items())
                           if n != "none" and float(r) > 0.0
                           and float(r) <= 1.0 - MIN_CODEC_SAVING
                           and cal.codec_bps(n, "read") > 0.0
                           and cal.codec_bps(n, "write") > 0.0]
        prices_by_codec: dict = {}
        for cname, ratio in codec_items:
            cg, cr, cb_moved, csp, ccb = [], [], [], [], []
            for _, _, _, los, his, _subf, _ in candidates:
                whole = (his - los).prod(axis=1) * itemsize
                for _weight, region, _cls in mix:
                    ilo = np.maximum(los, np.asarray(region.lo,
                                                     dtype=np.int64))
                    ihi = np.minimum(his, np.asarray(region.hi,
                                                     dtype=np.int64))
                    hit = (ilo < ihi).all(axis=1)
                    k = int(hit.sum())
                    payload = int((ihi - ilo).prod(axis=1)[hit].sum())
                    logical = int(whole[hit].sum())
                    cg.append(k)
                    cr.append(k)
                    cb_moved.append(payload * itemsize)
                    csp.append(max(k, int(logical * ratio)) if k else 0)
                    ccb.append(logical)
            prices_by_codec[cname] = predict_best_seconds_batch(
                cal,
                groups=np.asarray(cg, dtype=np.int64),
                runs=np.asarray(cr, dtype=np.int64),
                bytes_moved=np.asarray(cb_moved, dtype=np.int64),
                span_bytes=np.asarray(csp, dtype=np.int64),
                codec=cname,
                codec_bytes=np.asarray(ccb, dtype=np.int64))

        scores: dict = {}
        read_scores: dict = {}
        write_scores: dict = {}
        variant: dict = {}  # score key -> (candidate index, codec name)
        n_mix = len(mix)
        for ci, (name, _, _, los, his, subf, _) in enumerate(candidates):
            west = None
            if include_write_cost:
                west = estimate_write_shape(los, his, itemsize,
                                            subfiles=subf, align=align)
            logical_total = int((his - los).prod(axis=1).sum()) * itemsize
            for cname, ratio in [("none", 1.0)] + codec_items:
                key = name if cname == "none" else f"{name}+{cname}"
                variant[key] = (ci, cname)
                pvec = (prices if cname == "none"
                        else prices_by_codec[cname])
                t_read = 0.0
                for j, (weight, _region, _cls) in enumerate(mix):
                    t_read += weight * float(pvec[ci * n_mix + j])
                read_scores[key] = t_read
                if include_write_cost:
                    wkw = west.shape_kwargs()
                    if cname != "none":
                        wkw["bytes_moved"] = max(
                            len(los), int(wkw["bytes_moved"] * ratio))
                        wkw["span_bytes"] = max(
                            len(los), int(wkw["span_bytes"] * ratio))
                        wkw["codec"] = cname
                        wkw["codec_bytes"] = logical_total
                    total = predict_lifecycle_seconds(
                        cal, write=wkw, reads=t_read,
                        expected_reads=expected_reads, num_chunks=len(los),
                        gather=gather_for.get(name, 0.0),
                        chunk_overhead_s=self.chunk_overhead_s)
                    write_scores[key] = total - expected_reads * t_read
                    scores[key] = total
                else:
                    scores[key] = t_read

        if max(read_scores.values()) <= 0.0:
            # every recorded region misses this variable entirely — a
            # zero-read-cost "win" would be the insertion-order accident,
            # not a data-driven choice
            return default_decision("access history does not intersect")
        # insertion order breaks ties: the default scheme (raw) is first
        best_name = min(scores, key=lambda k: scores[k])
        bi, best_codec = variant[best_name]
        _, strategy, scheme, _, _, _, layout = candidates[bi]
        if layout is None:
            layout = reorg_plan(scheme)

        mix_summary: dict = {}
        for weight, _region, cls in mix:
            mix_summary[cls] = mix_summary.get(cls, 0.0) + weight
        n_prior = sum(1 for r in recs if r.source == "prior")
        default_name = "reorganized" + "x".join(map(str, default))
        top = ", ".join(f"{cls} {w:.0%}" for cls, w in
                        sorted(mix_summary.items(), key=lambda kv: -kv[1]))
        basis = f"{len(recs)} access records"
        if n_prior:
            basis += f" ({n_prior} prior)"
        horizon = (f" over E[reads]={expected_reads:.1f}"
                   if include_write_cost else " (read-only scoring)")
        reason = (f"{basis} ({top}){horizon}: chose {best_name} "
                  f"predicted {scores[best_name] * 1e3:.3f}ms"
                  + (f" vs default {default_name} "
                     f"{scores[default_name] * 1e3:.3f}ms"
                     if best_name != default_name else " (= default)"))
        return PolicyDecision(strategy=strategy, scheme=scheme, layout=layout,
                              reason=reason, scores=scores,
                              num_records=len(recs), mix=mix_summary,
                              read_scores=read_scores,
                              write_scores=write_scores,
                              expected_reads=float(expected_reads),
                              num_prior_records=n_prior,
                              codec=best_codec)
