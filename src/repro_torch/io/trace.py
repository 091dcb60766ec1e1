"""Workload traces: versioned, schema-checked, replayable I/O journals — a
copy of the JAX package's module (the same events give the same lines, and
a trace either package captured loads and replays under the other).

The access log (:mod:`repro_torch.core.policy`) is a *bounded ring* — the right
shape for steering a layout decision, the wrong shape for regression
testing: a 1000-event capture keeps 256 records and silently forgets the
warm-up that made the policy choose what it chose.  A **trace** is the
lossless sibling: an append-only JSONL sidecar (``trace.jsonl``) whose
first line is a :class:`TraceHeader` — dataset name, seed, every
variable's shape/dtype/stored chunking — and whose remaining lines are
schema-checked :class:`TraceEvent` s, one per observed operation:

======================  ====================================================
kind                    captured by
======================  ====================================================
``read``                :meth:`repro_torch.io.reader.Dataset.read`
``read_decomposed``     :meth:`~repro_torch.io.reader.Dataset.read_decomposed`
``read_pattern``        :meth:`~repro_torch.io.reader.Dataset.read_pattern`
``serve``               :class:`repro_torch.serve.read_service.ReadService`
``write``               :meth:`~repro_torch.io.reader.Dataset.write_planned`
``stage_submit``        :meth:`repro_torch.io.staging.StagingExecutor.submit`
``reorganize``          :func:`repro_torch.io.reader.reorganize`
``ckpt_save``           :meth:`repro_torch.checkpoint.manager.CheckpointManager.save`
``ckpt_restore``        :meth:`~repro_torch.checkpoint.manager.CheckpointManager.restore`
======================  ====================================================

Each event carries the region, tenant, engine decision and measured vs
predicted seconds, so a trace is simultaneously

* a **replayable workload** — :func:`repro_torch.io.replay.replay_trace`
  materializes a synthetic dataset matching the header and drives every
  event through the real stack, at recorded size or scaled down
  (:meth:`Trace.scaled`);
* a **cross-run prior** — :meth:`Trace.export_prior` converts the read
  events into the exact payload :meth:`repro_torch.core.policy.AccessLog.
  export_prior` writes, so a captured workload can warm a cold dataset's
  :class:`~repro_torch.core.policy.LayoutPolicy`.

Durability discipline: the recorder appends one complete JSON line per
event and flushes it immediately, so a crash loses at most the event in
flight and :func:`load_trace` can always salvage the complete prefix of a
truncated file (:class:`TraceCorruptError` carries it).  A version gate
rejects traces written by a *future* format, never silently misreads
them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Sequence

import numpy as np

from ..core.blocks import Block
from ..core.policy import ACCESS_LOG_VERSION, AccessRecord, classify_region
from .format import dtype_name, storage_dtype

__all__ = ["TRACE_NAME", "TRACE_VERSION", "EVENT_KINDS", "READ_KINDS",
           "TraceError", "TraceSchemaError", "TraceCorruptError",
           "TraceEvent", "TraceHeader", "Trace", "TraceRecorder",
           "load_trace", "header_for_dataset"]

#: default sidecar filename, next to ``index.json`` / ``access_log.json``
TRACE_NAME = "trace.jsonl"
TRACE_VERSION = 1

#: event kinds that are region reads through the dataset (they map onto
#: ``kind="read"`` access records when a trace is exported as a prior)
READ_KINDS = ("read", "read_decomposed", "read_pattern", "serve")
EVENT_KINDS = READ_KINDS + ("write", "stage_submit", "reorganize",
                            "ckpt_save", "ckpt_restore")

#: kinds whose events must carry a region (``lo``/``hi``)
_REGION_KINDS = frozenset(READ_KINDS + ("write", "stage_submit"))

#: per-kind required ``params`` keys (schema check at record AND load time)
_REQUIRED_PARAMS = {
    "read": (),
    "serve": (),
    "read_decomposed": ("scheme",),
    "read_pattern": ("pattern", "num_readers"),
    "write": ("chunks", "dtype", "global_shape", "strategy"),
    "stage_submit": ("step", "chunks", "dtype", "global_shape", "strategy"),
    "reorganize": ("layout",),
    "ckpt_save": ("step", "strategy", "vars"),
    "ckpt_restore": ("step",),
}

#: kinds that must name a variable
_VAR_KINDS = frozenset(READ_KINDS + ("write", "stage_submit", "reorganize"))


class TraceError(ValueError):
    """Base: anything wrong with a trace file or event."""


class TraceSchemaError(TraceError):
    """An event violates the per-kind schema."""


class TraceCorruptError(TraceError):
    """A trace file is corrupt or truncated mid-line.  ``salvaged`` holds
    the :class:`Trace` built from the complete prefix (header + every
    intact event line before the damage), or ``None`` when even the
    header was unreadable."""

    def __init__(self, message: str, salvaged: "Trace | None" = None):
        super().__init__(message)
        self.salvaged = salvaged


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One journaled operation.  ``params`` carries the kind-specific
    payload (scheme, pattern, chunk lists, checkpoint block maps — see
    :data:`_REQUIRED_PARAMS`); everything else is common telemetry."""

    kind: str
    seq: int
    var: str = ""
    lo: tuple | None = None
    hi: tuple | None = None
    tenant: str = ""
    engine: str = ""
    seconds: float = 0.0
    predicted_seconds: float = 0.0
    runs: int = 0
    groups: int = 0
    nbytes: int = 0
    ts: float = 0.0
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def region(self) -> Block:
        return Block(tuple(self.lo), tuple(self.hi))

    def to_json(self) -> dict:
        d: dict = {"kind": self.kind, "seq": int(self.seq)}
        if self.var:
            d["var"] = self.var
        if self.lo is not None:
            d["lo"] = [int(v) for v in self.lo]
            d["hi"] = [int(v) for v in self.hi]
        for key in ("tenant", "engine"):
            if getattr(self, key):
                d[key] = getattr(self, key)
        for key in ("seconds", "predicted_seconds", "ts"):
            if getattr(self, key):
                d[key] = float(getattr(self, key))
        for key in ("runs", "groups", "nbytes"):
            if getattr(self, key):
                d[key] = int(getattr(self, key))
        if self.params:
            d["params"] = self.params
        return d

    @staticmethod
    def from_json(d: dict) -> "TraceEvent":
        lo = d.get("lo")
        hi = d.get("hi")
        return TraceEvent(
            kind=d.get("kind", ""), seq=int(d.get("seq", -1)),
            var=d.get("var", ""),
            lo=tuple(lo) if lo is not None else None,
            hi=tuple(hi) if hi is not None else None,
            tenant=d.get("tenant", ""), engine=d.get("engine", ""),
            seconds=float(d.get("seconds", 0.0)),
            predicted_seconds=float(d.get("predicted_seconds", 0.0)),
            runs=int(d.get("runs", 0)), groups=int(d.get("groups", 0)),
            nbytes=int(d.get("nbytes", 0)), ts=float(d.get("ts", 0.0)),
            params=dict(d.get("params", {})))


def validate_event(ev: TraceEvent) -> TraceEvent:
    """Schema check one event; raises :class:`TraceSchemaError`."""
    if ev.kind not in EVENT_KINDS:
        raise TraceSchemaError(f"unknown event kind {ev.kind!r} "
                               f"(known: {', '.join(EVENT_KINDS)})")
    if ev.seq < 0:
        raise TraceSchemaError(f"{ev.kind} event has no valid seq")
    if ev.kind in _VAR_KINDS and not ev.var:
        raise TraceSchemaError(f"{ev.kind} event (seq {ev.seq}) "
                               f"must name a variable")
    if ev.kind in _REGION_KINDS:
        if ev.lo is None or ev.hi is None:
            raise TraceSchemaError(f"{ev.kind} event (seq {ev.seq}) "
                                   f"must carry a region (lo/hi)")
        if len(ev.lo) != len(ev.hi) or not ev.lo:
            raise TraceSchemaError(f"{ev.kind} event (seq {ev.seq}): "
                                   f"lo/hi rank mismatch")
        if any(int(h) <= int(l) for l, h in zip(ev.lo, ev.hi)):
            raise TraceSchemaError(f"{ev.kind} event (seq {ev.seq}): "
                                   f"empty region {ev.lo}..{ev.hi}")
    missing = [k for k in _REQUIRED_PARAMS[ev.kind] if k not in ev.params]
    if missing:
        raise TraceSchemaError(
            f"{ev.kind} event (seq {ev.seq}) missing required params: "
            + ", ".join(missing))
    return ev


@dataclasses.dataclass
class TraceHeader:
    """First line of a trace file: makes the trace self-describing.

    ``variables`` maps each dataset variable to its shape, dtype name and
    stored chunking (``[[lo, hi, subfile], ...]``) at capture start, so a
    replay can materialize a synthetic dataset with the same geometry.
    ``seed`` pins the synthetic content; ``attrs`` carries free-form
    scenario metadata (e.g. ``gate_var`` — the variable the policy
    regression gate scores)."""

    version: int = TRACE_VERSION
    name: str = ""
    seed: int = 0
    created: float = 0.0
    variables: dict = dataclasses.field(default_factory=dict)
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"version": int(self.version), "name": self.name,
                "seed": int(self.seed), "created": float(self.created),
                "variables": self.variables, "attrs": self.attrs}

    @staticmethod
    def from_json(d: dict) -> "TraceHeader":
        version = d.get("version")
        if not isinstance(version, int):
            raise TraceError("trace header has no integer version field")
        if version > TRACE_VERSION:
            raise TraceError(
                f"trace version {version} is newer than this reader "
                f"(supports <= {TRACE_VERSION}); refusing to misread it")
        hdr = TraceHeader(version=version, name=d.get("name", ""),
                          seed=int(d.get("seed", 0)),
                          created=float(d.get("created", 0.0)),
                          variables=dict(d.get("variables", {})),
                          attrs=dict(d.get("attrs", {})))
        for var, meta in hdr.variables.items():
            if "shape" not in meta or "dtype" not in meta:
                raise TraceError(f"trace header variable {var!r} missing "
                                 f"shape/dtype")
        return hdr


def header_for_dataset(ds, name: str = "", seed: int = 0,
                       attrs: dict | None = None) -> TraceHeader:
    """Snapshot an open :class:`~repro_torch.io.reader.Dataset`'s geometry as a
    trace header (shape, dtype and stored chunk extents per variable)."""
    variables: dict = {}
    for var in ds.index.variables:
        rows = ds.index.var_rows(var)
        variables[var] = {
            "shape": [int(s) for s in ds.index.var_shape(var)],
            "dtype": dtype_name(ds.index.var_dtype(var)),
            "chunks": [[[int(v) for v in rows.los[i]],
                        [int(v) for v in rows.his[i]],
                        int(rows.subfiles[i])] for i in range(rows.n)],
        }
    return TraceHeader(name=name, seed=seed, created=time.time(),
                       variables=variables, attrs=dict(attrs or {}))


# ---------------------------------------------------------------------------
# Scaling: replay a trace at a fraction of the recorded size
# ---------------------------------------------------------------------------

def _scale_coord(v: int, factor: int) -> int:
    return -(-int(v) // factor)        # ceil-divide: monotone boundary map


def _scale_bounds(lo, hi, factor: int):
    """Map a half-open box through the coordinate map ``c -> ceil(c/f)``.
    Monotone on boundaries, so disjoint boxes stay disjoint, adjacent
    boxes stay adjacent and a partition of the domain stays a partition of
    the scaled domain.  Returns ``None`` when the box collapses empty."""
    lo2 = tuple(_scale_coord(v, factor) for v in lo)
    hi2 = tuple(_scale_coord(v, factor) for v in hi)
    if any(h <= l for l, h in zip(lo2, hi2)):
        return None
    return lo2, hi2


def _scale_chunks(chunks, factor: int) -> list:
    out = []
    for lo, hi, *rest in chunks:
        b = _scale_bounds(lo, hi, factor)
        if b is not None:
            out.append([list(b[0]), list(b[1]), *rest])
    return out


# ---------------------------------------------------------------------------
# The trace object
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """A loaded (or under-construction) trace: header + event list."""

    header: TraceHeader
    events: list = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.events)

    def save(self, path: str) -> str:
        """Write the trace as JSONL (header line, then one event line)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(self.header.to_json(), sort_keys=True) + "\n")
            for ev in self.events:
                f.write(json.dumps(validate_event(ev).to_json(),
                                   sort_keys=True) + "\n")
        os.replace(tmp, path)
        return path

    # -- scaling -------------------------------------------------------------
    def scaled(self, factor: int) -> "Trace":
        """The same workload at ``1/factor`` of the recorded extent per
        axis: every coordinate moves through the monotone boundary map
        ``c -> ceil(c/factor)`` (shapes, stored chunks, event regions,
        checkpoint blocks alike), so covers stay covers and disjoint
        chunkings stay disjoint.  Events and chunks whose boxes collapse
        empty are dropped; decomposition schemes and slab thicknesses are
        clamped to the scaled extents."""
        factor = int(factor)
        if factor < 1:
            raise ValueError(f"scale factor must be >= 1, got {factor}")
        if factor == 1:
            return self
        hdr = TraceHeader(version=self.header.version,
                          name=(self.header.name + f"@1/{factor}"
                                if self.header.name else f"@1/{factor}"),
                          seed=self.header.seed,
                          created=self.header.created,
                          attrs=dict(self.header.attrs))
        shapes: dict = {}
        for var, meta in self.header.variables.items():
            shape = [max(1, _scale_coord(s, factor)) for s in meta["shape"]]
            shapes[var] = shape
            hdr.variables[var] = {
                "shape": shape, "dtype": meta["dtype"],
                "chunks": _scale_chunks(meta.get("chunks", []), factor)}

        def clamp_scheme(scheme, dims):
            return [max(1, min(int(k), int(d)))
                    for k, d in zip(scheme, dims)]

        events = []
        for ev in self.events:
            lo, hi = ev.lo, ev.hi
            if lo is not None:
                b = _scale_bounds(lo, hi, factor)
                if b is None and ev.kind in READ_KINDS:
                    continue           # the region vanished at this scale
                lo, hi = b if b is not None else (None, None)
            params = dict(ev.params)
            if ev.kind == "read_decomposed" and lo is not None:
                dims = [h - l for l, h in zip(lo, hi)]
                params["scheme"] = clamp_scheme(params["scheme"], dims)
            elif ev.kind == "read_pattern":
                shape = shapes.get(ev.var)
                if params.get("slab_thickness") and shape:
                    t = max(1, _scale_coord(params["slab_thickness"], factor))
                    params["slab_thickness"] = min(
                        t, max(1, min(s - s // 2 for s in shape)))
            elif ev.kind in ("write", "stage_submit"):
                params["chunks"] = _scale_chunks(params["chunks"], factor)
                params["global_shape"] = [max(1, _scale_coord(s, factor))
                                          for s in params["global_shape"]]
                if not params["chunks"]:
                    continue
                if lo is None:         # bbox collapsed but chunks survive
                    los = [c[0] for c in params["chunks"]]
                    his = [c[1] for c in params["chunks"]]
                    lo = tuple(min(c[d] for c in los)
                               for d in range(len(los[0])))
                    hi = tuple(max(c[d] for c in his)
                               for d in range(len(his[0])))
                shapes[ev.var] = params["global_shape"]
            elif ev.kind == "reorganize":
                if isinstance(params["layout"], dict):
                    params["layout"] = dict(
                        params["layout"],
                        chunks=_scale_chunks(params["layout"]["chunks"],
                                             factor))
                    if not params["layout"]["chunks"]:
                        continue
                params.pop("decision", None)   # audit of the recorded size
            elif ev.kind == "ckpt_save":
                new_vars = {}
                for name, meta in params["vars"].items():
                    blocks = _scale_chunks(meta["blocks"], factor)
                    if not blocks:
                        continue
                    new_vars[name] = dict(
                        meta,
                        shape=[max(1, _scale_coord(s, factor))
                               for s in meta["shape"]],
                        blocks=blocks)
                params["vars"] = new_vars
                if not new_vars and not params.get("scalars"):
                    continue
            elif ev.kind == "ckpt_restore" and params.get("targets"):
                params["targets"] = {
                    name: blks
                    for name, blks in ((n, _scale_chunks(b, factor))
                                       for n, b in params["targets"].items())
                    if blks}
                if not params["targets"]:
                    params["targets"] = None
            events.append(dataclasses.replace(ev, lo=lo, hi=hi,
                                              params=params))
        return Trace(header=hdr, events=events)

    # -- trace-as-prior bridge ----------------------------------------------
    def to_access_records(self, now: float | None = None) -> list:
        """The trace's read events as :class:`~repro_torch.core.policy.
        AccessRecord` s — the lossless superset of what the capture-time
        ring kept.  Dataset reads map to ``kind="read"``; checkpoint
        restores map to per-block ``kind="restore"`` records.  ``now``
        pins the timestamps (default: wall clock)."""
        ts = time.time() if now is None else now
        shapes = {var: tuple(meta["shape"])
                  for var, meta in self.header.variables.items()}
        ckpt_shapes: dict = {}
        out = []
        for ev in self.events:
            if ev.kind in READ_KINDS:
                shape = shapes.get(ev.var, tuple(ev.hi))
                out.append(AccessRecord(
                    var=ev.var, kind="read",
                    shape_class=classify_region(ev.region, shape),
                    lo=tuple(int(v) for v in ev.lo),
                    hi=tuple(int(v) for v in ev.hi),
                    runs=ev.runs, groups=ev.groups, nbytes=ev.nbytes,
                    seconds=ev.seconds,
                    predicted_seconds=ev.predicted_seconds,
                    engine=ev.engine, ts=ts, tenant=ev.tenant))
            elif ev.kind in ("write", "stage_submit"):
                shapes[ev.var] = tuple(ev.params["global_shape"])
            elif ev.kind == "ckpt_save":
                for name, meta in ev.params["vars"].items():
                    ckpt_shapes[name] = (tuple(meta["shape"]),
                                         meta["blocks"],
                                         storage_dtype(meta["dtype"]).itemsize)
            elif ev.kind == "ckpt_restore":
                targets = ev.params.get("targets") or {
                    name: blocks
                    for name, (_, blocks, _) in ckpt_shapes.items()}
                blocks_total = sum(len(b) for b in targets.values()) or 1
                for name, blocks in targets.items():
                    if name not in ckpt_shapes:
                        continue
                    shape, _, itemsize = ckpt_shapes[name]
                    for lo, hi, *_ in blocks:
                        region = Block(tuple(lo), tuple(hi))
                        out.append(AccessRecord(
                            var=name, kind="restore",
                            shape_class=classify_region(region, shape),
                            lo=tuple(int(v) for v in lo),
                            hi=tuple(int(v) for v in hi),
                            nbytes=region.volume * itemsize,
                            seconds=ev.seconds / blocks_total,
                            engine=ev.engine, ts=ts))
        return out

    def export_prior(self, path: str, now: float | None = None) -> str:
        """Write the trace's read history in the exact cross-run-prior
        format :meth:`repro_torch.core.policy.AccessLog.export_prior` produces,
        loadable by :meth:`~repro_torch.core.policy.LayoutPolicy.with_prior` /
        :func:`~repro_torch.core.policy.load_prior_records`."""
        payload = {"version": ACCESS_LOG_VERSION, "prior": True,
                   "records": [r.to_json()
                               for r in self.to_access_records(now=now)]}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def read_mix(self, var: str | None = None) -> dict:
        """Frequency mix of the trace's read regions:
        ``{var: {(lo, hi): count}}`` (or one variable's inner dict)."""
        mix: dict = {}
        for ev in self.events:
            if ev.kind not in READ_KINDS:
                continue
            per = mix.setdefault(ev.var, {})
            key = (tuple(ev.lo), tuple(ev.hi))
            per[key] = per.get(key, 0) + 1
        return mix.get(var, {}) if var is not None else mix


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

class TraceRecorder:
    """Append-only capture sink.  Every :meth:`record` validates the event
    against the schema, assigns the next ``seq``, writes one JSON line and
    flushes it — a crash loses at most the event in flight, and the ring
    capacity of the live access log never applies (losslessness is the
    point).  Thread-safe: dataset reader threads, staging workers and the
    read-service dispatcher can share one recorder."""

    def __init__(self, path: str, header: TraceHeader, *,
                 clock=None):
        self.path = path
        self.header = header
        self._clock = clock if clock is not None else time.time
        self._lock = threading.Lock()
        self._seq = 0
        self._file = open(path, "w")
        self._file.write(json.dumps(header.to_json(), sort_keys=True) + "\n")
        self._file.flush()

    @property
    def events_recorded(self) -> int:
        return self._seq

    def record(self, kind: str, *, var: str = "", region: Block | None = None,
               tenant: str = "", engine: str = "", seconds: float = 0.0,
               predicted_seconds: float = 0.0, runs: int = 0,
               groups: int = 0, nbytes: int = 0, **params) -> TraceEvent:
        """Journal one event (kind-specific payload in ``**params``)."""
        with self._lock:
            ev = TraceEvent(
                kind=kind, seq=self._seq, var=var,
                lo=tuple(int(v) for v in region.lo) if region else None,
                hi=tuple(int(v) for v in region.hi) if region else None,
                tenant=tenant, engine=engine, seconds=float(seconds),
                predicted_seconds=float(predicted_seconds), runs=int(runs),
                groups=int(groups), nbytes=int(nbytes),
                ts=float(self._clock()), params=params)
            validate_event(ev)
            self._file.write(json.dumps(ev.to_json(), sort_keys=True) + "\n")
            self._file.flush()
            self._seq += 1
        return ev

    def record_read(self, kind: str, var: str, region: Block, stats,
                    tenant: str = "", **params) -> TraceEvent:
        """Journal a read-shaped event from a ``ReadStats``-like object."""
        return self.record(kind, var=var, region=region, tenant=tenant,
                           engine=stats.engine, seconds=stats.seconds,
                           predicted_seconds=stats.predicted_seconds,
                           runs=stats.runs, groups=stats.groups,
                           nbytes=stats.bytes_read, **params)

    def record_write(self, kind: str, plan, stats, **params) -> TraceEvent:
        """Journal a write-shaped event from a
        :class:`~repro_torch.io.planner.WritePlan` and its ``WriteStats``: the
        chunk list (in layout order, with subfile assignment), dtype,
        global shape and strategy ride in ``params``."""
        order = np.argsort(plan.chunk_ids)
        chunks = [[[int(v) for v in plan.chunk_los[r]],
                   [int(v) for v in plan.chunk_his[r]],
                   int(plan.subfiles[r])] for r in order]
        lo = tuple(int(v) for v in np.min(plan.chunk_los, axis=0))
        hi = tuple(int(v) for v in np.max(plan.chunk_his, axis=0))
        return self.record(
            kind, var=plan.var, region=Block(lo, hi),
            engine=stats.engine, seconds=stats.total_seconds,
            predicted_seconds=stats.predicted_seconds,
            groups=stats.groups, runs=stats.num_extents,
            nbytes=stats.bytes_written,
            chunks=chunks, dtype=dtype_name(plan.dtype),
            global_shape=[int(s) for s in plan.global_shape],
            strategy=plan.strategy,
            align=plan.align, **params)

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()

    def __enter__(self) -> "TraceRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def load_trace(path: str, salvage: bool = False) -> Trace:
    """Load and schema-check a ``trace.jsonl``.

    A future-version header, a corrupt header, an unparseable or
    schema-violating event line, or a non-monotonic ``seq`` raise
    :class:`TraceError` / :class:`TraceCorruptError`; the latter carries
    the complete prefix as ``exc.salvaged``.  ``salvage=True`` returns
    that prefix instead of raising (an empty file still raises — there is
    no header to salvage under)."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as exc:
        raise TraceError(f"cannot read trace {path!r}: {exc}") from exc
    if not lines or not lines[0].strip():
        raise TraceCorruptError(f"trace {path!r} is empty (no header line)")
    try:
        header = TraceHeader.from_json(json.loads(lines[0]))
    except TraceError:
        raise
    except (ValueError, TypeError) as exc:
        raise TraceCorruptError(
            f"trace {path!r}: header line is not valid JSON: {exc}")
    events: list = []
    last_seq = -1
    for n, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            ev = validate_event(TraceEvent.from_json(json.loads(line)))
            if ev.seq <= last_seq:
                raise TraceSchemaError(
                    f"seq {ev.seq} not monotonic (after {last_seq})")
        except (TraceError, ValueError, TypeError, KeyError) as exc:
            partial = Trace(header=header, events=events)
            if salvage:
                return partial
            raise TraceCorruptError(
                f"trace {path!r} line {n}: {exc} "
                f"({len(events)} intact events salvageable)",
                salvaged=partial) from exc
        last_seq = ev.seq
        events.append(ev)
    return Trace(header=header, events=events)
