"""Distributed, crash-safe ``reorganize``: a lease-based worker fleet over
an on-disk job journal, every worker gathering its chunks on the card.

The coordinator (:func:`distributed_reorganize`) makes the layout decision
once (same policy path as single-process
:func:`~repro_torch.io.reader.reorganize`), builds the FULL destination
:class:`~repro_torch.io.planner.WritePlan` — every extent's subfile and
byte offset preassigned — and journals it (:class:`~repro_torch.io.
journal.ReorgJournal`) split into worker-claimable units.  Worker
*processes* (:func:`worker_main`) then lease units, gather the unit's
chunks out of the source on the card, write their slab via
:func:`~repro_torch.io.planner.subset_write_plan` (a slice of the one
global plan, so independent workers produce the byte-identical destination
a single process would), checksum every buffer and complete the unit.

A worker gathers a unit's chunks as ``reorganize`` gathers a layout's:
one :func:`~repro_torch.io.device.gather_regions` call a batch of whole
chunks of at most :data:`~repro_torch.io.device.GATHER_BATCH_BYTES` — one
engine read of each touched extent, one copy to the card, one ``pack_rows``
launch — and one copy back through the worker's pinned buffer; then the
batch's rows go to the destination through the resolved engine.
Compressed sources take the host plans, as ``reorganize``'s do.

Failure model (the JAX package's):

* **Worker death** (SIGKILL, OOM) — the lease stops renewing and expires;
  any surviving or restarted worker reclaims the unit and redoes it.
  Redone writes are idempotent: same bytes at the same preassigned,
  disjoint offsets.
* **Transient I/O faults** — every gather and slab write runs under
  :func:`with_retry` (bounded attempts, exponential backoff).
* **Fleet shrink** (elastic N -> N-1) — the coordinator's
  :class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor`
  (seeded from the journal's persisted heartbeats) detects the silent
  worker and records the :func:`~repro_torch.distributed.fault_tolerance.
  plan_rescale` decision in the journal's event log; the surviving workers
  converge on the remaining units without coordinator help.
* **Coordinator death** — the journal has everything (plan + unit states);
  re-running :func:`distributed_reorganize` on the same destination adopts
  it and finishes the same plan instead of re-deciding.

Commit-after-data at the journal level: the destination's ``index.json``
is written (atomically) only after every unit is done AND every recorded
checksum re-validates against the bytes on disk.

Workers are spawned processes (``fork`` after CUDA is initialized breaks
the child's CUDA).  On the card the coordinator builds and loads the
kernels before it spawns the fleet, and each worker warms its device
(context, library, one small launch) before its first claim, so neither a
build nor a context's creation runs while a lease ticks.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.blocks import Block
from ..device import resolve_device
from ..io.device import PinnedStaging, gather_batches
from ..io.engine import SubfileStore, resolve_engine
from ..io.format import (ChunkRecord, DatasetIndex, extent_checksum,
                         subfile_name)
from ..io.journal import DEFAULT_LEASE_TIMEOUT_S, ReorgJournal
from ..io.planner import WritePlan, build_write_plan, subset_write_plan
from ..io.reader import Dataset, _gather, choose_reorg_layout
from ..kernels import _build
from ..kernels.pack_blocks import pack_rows
from .fault_tolerance import plan_rescale

__all__ = ["ReorgWorkerStats", "with_retry", "worker_main", "warm_device",
           "distributed_reorganize", "validate_journal"]

#: barrier names a worker touches, in the order it reaches them — the kill
#: matrix SIGKILLs workers parked at each of these
BARRIERS = ("mid_gather", "pre_renew", "mid_write", "pre_complete")

#: devices this process has warmed (a CUDA context and the copy kernel's
#: library are the process's, once)
_warm: set = set()


def with_retry(fn, *, attempts: int = 4, backoff_s: float = 0.05,
               retry_on: tuple = (OSError,), sleep=time.sleep):
    """Call ``fn()`` with bounded retry + exponential backoff on the
    exception types in ``retry_on`` (transient I/O faults: EINTR-ish
    hiccups, NFS blips).  The last failure propagates — a *persistent*
    fault must kill the worker so its lease expires and another worker
    inherits the unit; swallowing it would wedge the fleet."""
    for i in range(max(1, attempts)):
        try:
            return fn()
        except retry_on:
            if i >= attempts - 1:
                raise
            sleep(backoff_s * (2 ** i))


class _Barriers:
    """Crash-point instrumentation for the kill matrix.  With no
    ``barrier_dir`` every wait is a no-op (production).  Otherwise the
    first time this worker reaches each named point it writes its pid to
    ``<dir>/<worker>.<name>.reached`` and parks until ``<dir>/go.<name>``
    appears — or until the test SIGKILLs it mid-flight.  Per-name release
    files let a test arm one crash point (withhold its release) while
    letting workers sail through the others."""

    def __init__(self, worker: str, barrier_dir: str | None,
                 poll_s: float = 0.01):
        self.worker = worker
        self.dir = barrier_dir
        self.poll_s = poll_s
        self._hit: set = set()

    def wait(self, name: str) -> None:
        if self.dir is None or name in self._hit:
            return
        self._hit.add(name)
        marker = os.path.join(self.dir, f"{self.worker}.{name}.reached")
        with open(marker, "w") as f:
            f.write(str(os.getpid()))
        release = os.path.join(self.dir, f"go.{name}")
        while not os.path.exists(release):
            time.sleep(self.poll_s)


class ReorgWorkerStats(dict):
    """Per-worker outcome: ``units_done``, ``units_lost`` (lease stolen
    mid-unit), ``chunks_gathered``."""


def warm_device(device) -> None:
    """Create ``device``'s CUDA context, load the copy kernel's library and
    launch it once on one row (once a process; nothing on the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev in _warm:
        return
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    pack_rows(one.view(1, 1), one, one, n_dst_rows=1, width=1)
    torch.cuda.synchronize(dev)
    _warm.add(dev)


def worker_main(dst_dir: str, worker_id: str, engine: str = "pread", *,
                barrier_dir: str | None = None, poll_s: float = 0.02,
                max_attempts: int = 4, backoff_s: float = 0.05,
                sleep=time.sleep, device="cuda") -> ReorgWorkerStats:
    """One reorg worker: claim -> gather (on ``device``) -> renew -> write
    -> checksum -> complete, until the journal has no work left.  Safe to
    run any number of these concurrently — in separate processes or
    (tests) threads — and safe to SIGKILL at any instant.  The device is
    warmed before the first claim."""
    dev = resolve_device(device)
    warm_device(dev)
    journal = ReorgJournal(dst_dir)
    spec = journal.spec()
    plan = journal.plan()
    var = plan.var
    src = Dataset.open(spec["src_dir"], engine=engine, telemetry=False,
                       device=dev)
    # per-node feature detection: a worker on a host without io_uring /
    # O_DIRECT degrades its engine instead of crashing the fleet
    eng, _fallback = resolve_engine(engine, dirpath=dst_dir)
    store = SubfileStore(dst_dir)
    staging = PinnedStaging()          # the gathered chunks' copy back
    bar = _Barriers(worker_id, barrier_dir)
    stats = ReorgWorkerStats(units_done=0, units_lost=0, chunks_gathered=0)
    try:
        while True:
            unit = journal.claim(worker_id)
            if unit is None:
                if journal.done():
                    break
                sleep(poll_s)        # live leases elsewhere: wait them out
                continue
            rows = np.unique(np.asarray(unit.rows, dtype=np.int64))
            checksums, lost = {}, False
            for b, batch in enumerate(gather_batches(plan.nbytes[rows])):
                brows = rows[batch]
                regions = [Block(tuple(int(v) for v in plan.chunk_los[r]),
                                 tuple(int(v) for v in plan.chunk_his[r]))
                           for r in brows]
                buffers = with_retry(
                    lambda rg=regions: _gather(src, var, rg, plan.dtype,
                                               staging)[0],
                    attempts=max_attempts, backoff_s=backoff_s, sleep=sleep)
                stats["chunks_gathered"] += len(brows)
                if b == 0:
                    bar.wait("mid_gather")
                bar.wait("pre_renew")
                if not journal.renew(worker_id, unit.unit_id):
                    lost = True      # lease stolen: the new holder owns it
                    break
                checksums.update({int(r): extent_checksum(buf)
                                  for r, buf in zip(brows, buffers)})
                # the batch's rows, one coalesced group at a time; the
                # buffers are views of the staging buffer, written before
                # the next batch takes it
                gb = subset_write_plan(plan, brows).group_bounds
                for g in range(len(gb) - 1):
                    s, e = int(gb[g]), int(gb[g + 1])
                    gsub = subset_write_plan(plan, brows[s:e])

                    def write_group(gs=gsub, bs=buffers[s:e]):
                        for sf, size in gs.file_sizes.items():
                            store.ensure_size(sf, size)
                        eng.write_plan(gs, bs, store)
                    with_retry(write_group, attempts=max_attempts,
                               backoff_s=backoff_s, sleep=sleep)
                    bar.wait("mid_write")
            if lost:
                stats["units_lost"] += 1
                continue
            store.fsync()
            bar.wait("pre_complete")
            if journal.complete(worker_id, unit.unit_id, checksums):
                stats["units_done"] += 1
            else:
                stats["units_lost"] += 1
    finally:
        src.close()
        store.close()
        staging.release()
    return stats


def validate_journal(dst_dir: str, plan: WritePlan,
                     journal: ReorgJournal) -> list:
    """Re-read every done unit's extents from the destination subfiles and
    compare against the journal's recorded CRCs.  Returns the unit ids
    that fail (missing rows, short reads, checksum mismatch) — the
    coordinator resets those to pending and runs another round."""
    bad = []
    fds: dict = {}
    try:
        for unit in journal.units():
            if unit.state != "done":
                continue
            ok = set(unit.checksums) == {int(r) for r in unit.rows}
            for row, crc in unit.checksums.items():
                if not ok:
                    break
                sf = int(plan.subfiles[row])
                if sf not in fds:
                    try:
                        fds[sf] = os.open(
                            os.path.join(dst_dir, subfile_name(sf)),
                            os.O_RDONLY)
                    except OSError:
                        ok = False
                        break
                buf = os.pread(fds[sf], int(plan.nbytes[row]),
                               int(plan.file_lo[row]))
                ok = (len(buf) == int(plan.nbytes[row])
                      and extent_checksum(buf) == crc)
            if not ok:
                bad.append(unit.unit_id)
    finally:
        for fd in fds.values():
            os.close(fd)
    return bad


def _run_fleet(dst_dir: str, workers: list, engine: str,
               barrier_dir: str | None, journal: ReorgJournal,
               events: list, timeout_s: float, device: str) -> None:
    """Spawn one fleet of worker processes and babysit it: join them,
    watch the journal's heartbeat monitor for silently-dead workers, and
    record the elastic rescale decision for each death."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = {w: ctx.Process(target=worker_main, args=(dst_dir, w, engine),
                            kwargs={"barrier_dir": barrier_dir,
                                    "device": device}, daemon=True)
             for w in workers}
    for p in procs.values():
        p.start()
    deadline = time.monotonic() + timeout_s
    known_dead: set = set()
    while any(p.is_alive() for p in procs.values()):
        if time.monotonic() > deadline:
            for p in procs.values():
                if p.is_alive():
                    p.terminate()
            break
        time.sleep(0.05)
        try:
            mon = journal.monitor()
        except (OSError, ValueError, KeyError):
            continue
        dead = [w for w in mon.dead_hosts()
                if w not in known_dead and not procs.get(w, _DEAD).is_alive()]
        for w in dead:
            known_dead.add(w)
            alive = [h for h in procs
                     if h not in known_dead and procs[h].is_alive()]
            try:
                desc = plan_rescale((len(workers), 1), len(alive),
                                    alive).describe()
            except ValueError:
                desc = "no surviving workers"
            ev = {"event": "worker_dead", "worker": w, "rescale": desc}
            events.append(ev)
            try:
                journal.record_event(ev)
            except OSError:
                pass
    for p in procs.values():
        p.join(timeout=10.0)


class _Dead:
    @staticmethod
    def is_alive():
        return False


_DEAD = _Dead()


def distributed_reorganize(src_dir: str, dst_dir: str, var: str,
                           layout="auto", *, num_workers: int = 2,
                           units_per_worker: int = 2,
                           engine: str = "pread",
                           align: int | None = None,
                           policy=None, prior: str | None = None,
                           expected_reads: float | None = None,
                           lease_timeout_s: float = DEFAULT_LEASE_TIMEOUT_S,
                           max_rounds: int = 5,
                           round_timeout_s: float = 120.0,
                           barrier_dir: str | None = None,
                           device="cuda") -> tuple:
    """Crash-safe multi-process reorganization of ``var`` from ``src_dir``
    into ``dst_dir``, every worker gathering on ``device`` (``"cuda"``
    unless ``"cpu"`` is asked for).

    Decides the target layout exactly like single-process
    :func:`~repro_torch.io.reader.reorganize` (``layout="auto"`` routes
    through the source's :class:`~repro_torch.core.policy.LayoutPolicy`; a
    :class:`~repro_torch.core.layouts.LayoutPlan` pins it), journals the
    full write plan split into ``num_workers * units_per_worker``
    lease-based units, and runs fleets of ``num_workers`` worker processes
    until every unit is done and validates, then commits ``index.json``
    atomically and deletes the journal.  If ``dst_dir`` already holds a
    journal (a previous coordinator died), it is adopted: the SAME plan is
    finished, not re-decided, so recovery converges bit-identically — to
    the JAX package's single-process ``reorganize`` as well.

    Returns ``(Dataset, stats)`` — the open destination session (on
    ``device``) and a dict with ``rounds``, ``units``, ``events`` (worker
    deaths + rescale decisions) and ``validation_failures``.
    """
    if isinstance(engine, str) and engine == "auto":
        raise ValueError("distributed reorganization needs a concrete "
                         "engine per worker; 'auto' resolves per-plan "
                         "inside a single session only")
    dev = resolve_device(device)
    if dev.type == "cuda":
        # build (if need be) and load the kernels once, here: a worker
        # never runs nvcc while it holds a lease
        _build.load("pack_rows")
    journal = ReorgJournal(dst_dir)
    decision = None
    if journal.exists():
        plan = journal.plan()
    else:
        if isinstance(layout, str) and layout != "auto":
            raise ValueError(f"layout must be a LayoutPlan or 'auto', "
                             f"got {layout!r}")
        src = Dataset.open(src_dir, engine=engine, telemetry=False,
                           device=dev)
        if isinstance(layout, str):
            decision = choose_reorg_layout(src, var, align=align,
                                           policy=policy, prior=prior,
                                           expected_reads=expected_reads)
            layout = decision.layout
        dtype = src.index.var_dtype(var)
        src.close()
        plan = build_write_plan(layout, var, dtype, align=align)
        journal = ReorgJournal.create(
            dst_dir, plan, src_dir,
            num_units=max(1, num_workers * units_per_worker),
            lease_timeout_s=lease_timeout_s,
            attrs={"var": var, "engine": engine,
                   "policy": decision.to_json() if decision else None})

    events: list = []
    rounds = 0
    validation_failures = 0
    while True:
        if journal.done():
            bad = validate_journal(dst_dir, plan, journal)
            if not bad:
                break
            validation_failures += len(bad)
            journal.reset_units(bad)
        if rounds >= max_rounds:
            raise RuntimeError(
                f"distributed reorganize did not converge after "
                f"{rounds} rounds; journal left in {dst_dir} for resume")
        rounds += 1
        workers = [f"w{i}" for i in range(num_workers)]
        _run_fleet(dst_dir, workers, engine, barrier_dir, journal, events,
                   round_timeout_s, str(dev))
        barrier_dir = None       # crash points apply to the first fleet only

    # ---- commit: publish the index only now, in one atomic replace -------
    attrs = journal.load().get("attrs", {})
    units = journal.units()
    crc_by_row = {}
    for unit in units:
        crc_by_row.update(unit.checksums)
    idx = DatasetIndex()
    # layout lineage: the committed index supersedes the source's layout,
    # so generation-keyed plan caches drop stale plans
    try:
        idx.generation = DatasetIndex.load(
            journal.load()["src_dir"]).generation + 1
    except (OSError, ValueError, KeyError):
        idx.generation = 1
    idx.add_variable(var, plan.layout.global_shape, plan.dtype,
                     plan.layout.strategy)
    for row in np.argsort(plan.chunk_ids):       # original layout order
        idx.chunks.append(ChunkRecord(
            var=var, lo=tuple(int(v) for v in plan.chunk_los[row]),
            hi=tuple(int(v) for v in plan.chunk_his[row]),
            subfile=int(plan.subfiles[row]),
            offset=int(plan.file_lo[row]),
            nbytes=int(plan.nbytes[row]),
            checksum=crc_by_row.get(int(row))))
    idx.num_subfiles = len(plan.file_sizes)
    if attrs.get("policy"):
        idx.attrs.setdefault("policy", {})[var] = attrs["policy"]
    idx.attrs["distributed_reorg"] = {
        "workers": num_workers, "rounds": rounds, "units": len(units),
        "events": [dict(e) for e in events]}
    idx.save(dst_dir)
    journal.delete()
    ds = Dataset.open(dst_dir, engine=engine, device=dev)
    return ds, {"rounds": rounds, "units": len(units), "events": events,
                "validation_failures": validation_failures,
                "num_chunks": plan.num_chunks}
