"""On-disk job journal for distributed, crash-safe reorganization.

The destination layout of one ``reorganize`` is split into *work units* —
contiguous runs of :class:`~repro_torch.io.planner.WritePlan` rows, snapped to
coalesced group boundaries — and tracked in ``reorg_journal.json`` inside
the destination directory.  Worker processes *lease* units under a
deadline, gather the unit's chunk regions out of the source dataset, write
their slab (the exact extents the full plan preassigned — see
:func:`~repro_torch.io.planner.subset_write_plan`) and mark the unit done
together with a per-chunk CRC-32 of every buffer written.  A worker that
dies mid-unit simply stops renewing: once the lease expires any surviving
or restarted worker reclaims the unit and redoes it — unit writes are
idempotent (same bytes at the same preassigned, disjoint offsets), so a
double claim on an exact race wastes work but never corrupts.

Crash consistency is the container's commit-after-data discipline lifted
one level: the journal (and the subfile extents it tracks) carry the whole
in-flight state, and the destination's ``index.json`` is published — in
one atomic replace — only after every unit is done *and* every recorded
checksum re-validates against the bytes on disk.  A reader therefore sees
the old state (no ``index.json``: the destination does not exist yet) or
the new one, never a torn layout; killing the whole fleet at any instant
leaves either nothing or a journal a fresh fleet resumes from.

Unlike the lossy atomic-replace ring of ``access_log.json`` (where a lost
in-flight record is acceptable), journal mutations are read-modify-write
transactions serialized through an ``fcntl.flock`` on a sidecar lock file
(``reorg_journal.lock``) — losing a *claim* would stall recovery, not just
telemetry.  The journal file itself is still written via atomic
tmp+``os.replace``, so observers that read without the lock always see one
complete JSON document.
"""

from __future__ import annotations

import dataclasses
import fcntl
import itertools
import json
import os
import time

import numpy as np

from ..core.blocks import Block
from ..core.layouts import ChunkPlan, LayoutPlan
from ..distributed.fault_tolerance import HeartbeatMonitor
from .format import dtype_name, storage_dtype
from .planner import WritePlan

__all__ = ["REORG_JOURNAL_NAME", "WorkUnit", "ReorgJournal",
           "partition_unit_rows", "serialize_write_plan",
           "deserialize_write_plan"]

REORG_JOURNAL_NAME = "reorg_journal.json"
REORG_JOURNAL_VERSION = 1
#: a worker that has not renewed its lease for this long is presumed dead
#: and its unit becomes reclaimable
DEFAULT_LEASE_TIMEOUT_S = 30.0

_tmp_counter = itertools.count()


# ---------------------------------------------------------------------------
# WritePlan (de)serialization — resume must redo the SAME plan, not re-decide
# ---------------------------------------------------------------------------

def serialize_write_plan(plan: WritePlan) -> dict:
    """The full write plan as a JSON-safe table.  Persisting the *plan*
    (not the layout request) is what makes recovery deterministic: a
    restarted fleet re-executes the exact extents the first fleet
    preassigned, so the converged destination is bit-identical to a
    single-process run of the same decision."""
    lay = plan.layout
    return {
        "var": plan.var,
        "dtype": dtype_name(plan.dtype),
        "strategy": lay.strategy,
        "global_shape": [int(g) for g in lay.global_shape],
        "num_subfiles": int(lay.num_subfiles),
        "align": None if plan.align is None else int(plan.align),
        "chunk_ids": plan.chunk_ids.tolist(),
        "chunk_los": plan.chunk_los.tolist(),
        "chunk_his": plan.chunk_his.tolist(),
        "writers": plan.writers.tolist(),
        "subfiles": plan.subfiles.tolist(),
        "file_lo": plan.file_lo.tolist(),
        "nbytes": plan.nbytes.tolist(),
        "group_bounds": plan.group_bounds.tolist(),
        "file_sizes": {str(k): int(v) for k, v in plan.file_sizes.items()},
        "span_bytes": int(plan.span_bytes),
    }


def deserialize_write_plan(d: dict) -> WritePlan:
    """Rebuild the :class:`WritePlan` (and a chunk-identity
    :class:`~repro_torch.core.layouts.LayoutPlan` behind it) from
    :func:`serialize_write_plan` output."""
    chunk_ids = np.asarray(d["chunk_ids"], dtype=np.int64)
    los = np.asarray(d["chunk_los"], dtype=np.int64)
    his = np.asarray(d["chunk_his"], dtype=np.int64)
    writers = np.asarray(d["writers"], dtype=np.int64)
    subfiles = np.asarray(d["subfiles"], dtype=np.int64)
    file_lo = np.asarray(d["file_lo"], dtype=np.int64)
    nbytes = np.asarray(d["nbytes"], dtype=np.int64)
    # layout.chunks is indexed by chunk_id (original layout order): invert
    # the plan's execution-order permutation
    order = np.argsort(chunk_ids)
    chunks = tuple(
        ChunkPlan(chunk=Block(tuple(int(v) for v in los[row]),
                              tuple(int(v) for v in his[row]),
                              owner=int(writers[row]), block_id=int(
                                  chunk_ids[row])),
                  sources=(Block(tuple(int(v) for v in los[row]),
                                 tuple(int(v) for v in his[row]),
                                 owner=int(writers[row]),
                                 block_id=int(chunk_ids[row])),),
                  writer=int(writers[row]), subfile=int(subfiles[row]))
        for row in order)
    layout = LayoutPlan(strategy=d["strategy"],
                        global_shape=tuple(d["global_shape"]),
                        chunks=chunks, num_subfiles=int(d["num_subfiles"]),
                        inter_process_moved=0, intra_node_moved=0)
    return WritePlan(
        var=d["var"], layout=layout, dtype=storage_dtype(d["dtype"]),
        chunk_ids=chunk_ids, chunk_los=los, chunk_his=his, writers=writers,
        subfiles=subfiles, file_lo=file_lo, file_hi=file_lo + nbytes,
        nbytes=nbytes,
        group_bounds=np.asarray(d["group_bounds"], dtype=np.int64),
        file_sizes={int(k): int(v) for k, v in d["file_sizes"].items()},
        align=d["align"], bytes_total=int(nbytes.sum()),
        span_bytes=int(d["span_bytes"]))


def partition_unit_rows(plan: WritePlan, num_units: int) -> list:
    """Split the plan's rows into ``num_units`` contiguous work units with
    near-equal payload bytes, cutting only at coalesced group boundaries —
    a unit always owns whole groups, so executing its subset plan issues
    the same vectored writes the full plan would for those rows."""
    ng = plan.num_groups
    if plan.num_chunks == 0 or ng == 0:
        return []
    num_units = max(1, min(int(num_units), ng))
    gb = plan.group_bounds
    group_bytes = np.add.reduceat(plan.nbytes, gb[:-1])
    cum = np.cumsum(group_bytes)
    total = int(cum[-1])
    cuts = [0]
    for u in range(1, num_units):
        c = int(np.searchsorted(cum, total * u / num_units))
        cuts.append(max(cuts[-1] + 1, min(c, ng - (num_units - u))))
    cuts.append(ng)
    return [list(range(int(gb[cuts[u]]), int(gb[cuts[u + 1]])))
            for u in range(num_units)]


# ---------------------------------------------------------------------------
# Work units + the journal
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkUnit:
    """One claimable slab of the destination: a set of plan rows."""

    unit_id: int
    rows: list                    # WritePlan row positions (sorted)
    state: str = "pending"        # "pending" | "leased" | "done"
    worker: str | None = None     # current / last lease holder
    lease_expires: float = 0.0    # wall-clock deadline of the lease
    attempt: int = 0              # how many times the unit was (re)claimed
    #: plan row -> CRC-32 of the buffer written there (set on completion)
    checksums: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"id": int(self.unit_id),
                "rows": [int(r) for r in self.rows],
                "state": self.state, "worker": self.worker,
                "lease_expires": float(self.lease_expires),
                "attempt": int(self.attempt),
                "crc": {str(k): int(v) for k, v in self.checksums.items()}}

    @staticmethod
    def from_json(d: dict) -> "WorkUnit":
        return WorkUnit(unit_id=d["id"], rows=list(d["rows"]),
                        state=d["state"], worker=d.get("worker"),
                        lease_expires=d.get("lease_expires", 0.0),
                        attempt=d.get("attempt", 0),
                        checksums={int(k): int(v)
                                   for k, v in d.get("crc", {}).items()})


class ReorgJournal:
    """Lease-based work-unit journal for one distributed reorganization.

    All mutations are read-modify-write transactions under an exclusive
    ``fcntl.flock`` on ``reorg_journal.lock``; the journal file itself is
    replaced atomically, so lock-free observers always parse a complete
    document.  ``clock`` is injectable (wall clock by default — leases must
    survive process restarts, so a monotonic clock would be wrong here).
    """

    def __init__(self, dirpath: str, clock=time.time):
        self.dirpath = dirpath
        self.clock = clock

    # -- paths ---------------------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.dirpath, REORG_JOURNAL_NAME)

    @property
    def lock_path(self) -> str:
        return self.path + ".lock"

    def exists(self) -> bool:
        return os.path.exists(self.path)

    # -- creation / adoption -------------------------------------------------
    @classmethod
    def create(cls, dirpath: str, plan: WritePlan, src_dir: str, *,
               num_units: int,
               lease_timeout_s: float = DEFAULT_LEASE_TIMEOUT_S,
               attrs: dict | None = None, clock=time.time) -> "ReorgJournal":
        """Start a journal for ``plan`` with ``num_units`` work units.
        Raises ``FileExistsError`` when a journal is already present —
        callers adopt in-flight jobs instead of restarting them."""
        j = cls(dirpath, clock=clock)
        if j.exists():
            raise FileExistsError(f"reorg journal already present in "
                                  f"{dirpath}; adopt it instead")
        units = [WorkUnit(unit_id=i, rows=rows)
                 for i, rows in enumerate(partition_unit_rows(plan,
                                                              num_units))]
        payload = {"version": REORG_JOURNAL_VERSION,
                   "src_dir": os.path.abspath(src_dir),
                   "lease_timeout_s": float(lease_timeout_s),
                   "plan": serialize_write_plan(plan),
                   "units": [u.to_json() for u in units],
                   "heartbeats": {},
                   "attrs": dict(attrs or {}),
                   "events": []}
        os.makedirs(dirpath, exist_ok=True)
        j._write(payload)
        return j

    # -- raw persistence -----------------------------------------------------
    def load(self) -> dict:
        with open(self.path) as f:
            return json.load(f)

    def _write(self, payload: dict) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}.{next(_tmp_counter)}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def _transact(self, fn):
        """Run ``fn(payload)`` with the journal locked; persist the
        (mutated) payload and return ``fn``'s result."""
        with open(self.lock_path, "a+") as lockf:
            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
            try:
                payload = self.load()
                result = fn(payload)
                self._write(payload)
                return result
            finally:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_UN)

    def delete(self) -> None:
        for p in (self.path, self.lock_path):
            try:
                os.unlink(p)
            except OSError:
                pass

    # -- read-only views -----------------------------------------------------
    def plan(self) -> WritePlan:
        return deserialize_write_plan(self.load()["plan"])

    def spec(self) -> dict:
        payload = self.load()
        return {"src_dir": payload["src_dir"],
                "lease_timeout_s": payload["lease_timeout_s"],
                "var": payload["plan"]["var"],
                "attrs": payload.get("attrs", {})}

    def units(self) -> list:
        return [WorkUnit.from_json(u) for u in self.load()["units"]]

    def done(self) -> bool:
        return all(u["state"] == "done" for u in self.load()["units"])

    def monitor(self, timeout_s: float | None = None) -> HeartbeatMonitor:
        """A :class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor`
        seeded from the persisted per-worker heartbeat timestamps (workers
        beat on every claim/renew/complete), judged on the journal's own
        wall clock — the failure detector any process can reconstruct from
        disk alone."""
        payload = self.load()
        if timeout_s is None:
            timeout_s = payload["lease_timeout_s"]
        mon = HeartbeatMonitor([], timeout_s=timeout_s, clock=self.clock)
        mon.last_beat.update({w: float(t)
                              for w, t in payload["heartbeats"].items()})
        return mon

    # -- the lease protocol --------------------------------------------------
    def _reclaim_expired(self, payload: dict, now: float) -> list:
        reclaimed = []
        for u in payload["units"]:
            if u["state"] == "leased" and now > u["lease_expires"]:
                reclaimed.append({"event": "lease_expired", "unit": u["id"],
                                  "worker": u["worker"], "ts": now})
                u["state"] = "pending"
                u["worker"] = None
                u["lease_expires"] = 0.0
        payload["events"].extend(reclaimed)
        return reclaimed

    def claim(self, worker: str) -> WorkUnit | None:
        """Lease the first claimable unit to ``worker`` (expired leases are
        reclaimed first, so a surviving fleet converges without any
        coordinator intervention).  ``None`` means nothing is claimable
        right now — either all done, or the rest are under live leases."""
        def fn(payload):
            now = self.clock()
            payload["heartbeats"][worker] = now
            self._reclaim_expired(payload, now)
            for u in payload["units"]:
                if u["state"] == "pending":
                    u["state"] = "leased"
                    u["worker"] = worker
                    u["lease_expires"] = now + payload["lease_timeout_s"]
                    u["attempt"] = u.get("attempt", 0) + 1
                    return WorkUnit.from_json(u)
            return None
        return self._transact(fn)

    def renew(self, worker: str, unit_id: int) -> bool:
        """Extend ``worker``'s lease on ``unit_id``.  ``False`` means the
        lease was lost (expired and reclaimed by someone else) — the worker
        must abandon the unit; its writes are harmless (idempotent bytes)
        but completion belongs to the new holder."""
        def fn(payload):
            now = self.clock()
            payload["heartbeats"][worker] = now
            for u in payload["units"]:
                if u["id"] == unit_id:
                    if u["state"] == "leased" and u["worker"] == worker:
                        u["lease_expires"] = now + payload["lease_timeout_s"]
                        return True
                    return False
            return False
        return self._transact(fn)

    def complete(self, worker: str, unit_id: int,
                 checksums: dict) -> bool:
        """Mark ``unit_id`` done with the per-row CRCs of the bytes written.
        Only the current lease holder may complete; a late completion from
        a worker whose lease was stolen is refused (the new holder's —
        byte-identical — result stands instead)."""
        def fn(payload):
            now = self.clock()
            payload["heartbeats"][worker] = now
            for u in payload["units"]:
                if u["id"] == unit_id:
                    if u["state"] == "leased" and u["worker"] == worker:
                        u["state"] = "done"
                        u["crc"] = {str(k): int(v)
                                    for k, v in checksums.items()}
                        u["lease_expires"] = 0.0
                        return True
                    return False
            return False
        return self._transact(fn)

    def reset_units(self, unit_ids, reason: str = "validation") -> None:
        """Force units back to ``pending`` (e.g. a done unit whose bytes
        failed checksum validation) — they will be reclaimed and redone."""
        ids = {int(i) for i in unit_ids}

        def fn(payload):
            now = self.clock()
            for u in payload["units"]:
                if u["id"] in ids:
                    payload["events"].append(
                        {"event": "reset", "unit": u["id"],
                         "reason": reason, "ts": now})
                    u["state"] = "pending"
                    u["worker"] = None
                    u["lease_expires"] = 0.0
                    u["crc"] = {}
            return None
        self._transact(fn)

    def record_event(self, event: dict) -> None:
        """Append an audit event (elastic rescale decisions, validation
        rounds) to the journal's event log."""
        def fn(payload):
            payload["events"].append(dict(event, ts=self.clock()))
            return None
        self._transact(fn)
