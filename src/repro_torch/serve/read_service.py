"""Multi-tenant read service: concurrent region queries, coalesced, with
the results on the card.

:class:`ReadService` is the shared front door onto one open
:class:`~repro_torch.io.reader.Dataset` when *many* clients read it at
once — the JAX package's service, whose batches the port executes on the
card:

* **submit** — thread-safe ``submit(tenant, var, region)`` returns a
  :class:`~concurrent.futures.Future` resolving to ``(tensor, ReadStats)``
  on the service's device, with the same bytes an independent
  ``Dataset.read`` would produce;
* **batch front door** — ``read_batch(requests)`` (callers that already
  hold a batch skip the window) submits a list of
  :class:`~repro_torch.serve.coalesce.Request` and blocks for all results.

Requests arriving within a short **coalescing window** are merged across
tenants: a dispatcher thread drains the per-tenant queues round-robin
(fairness — one chatty tenant cannot starve the rest), groups the batch by
variable, and folds each group into one
:class:`~repro_torch.serve.coalesce.SuperPlan` — one index probe, one
engine gather over the merged byte spans, one copy to the card and ONE
``pack_rows`` launch routing every raw member's region out of the fetched
bytes (:meth:`~repro_torch.io.reader.Dataset.read_super_planned`).
**Admission control** bounds the bytes in flight: a batch closes when the
*unioned stored byte spans* its members' plans would fetch reach
``max_inflight_bytes`` (overlapping requests are fetched once and charged
once; compressed extents count stored, not logical, bytes; always
admitting at least one request) and the remainder waits for the next
cycle.

Super-plans are cached across batches, keyed on ``(var, regions)`` and
guarded by the index staleness key ``(generation, len(chunks))``: every
dispatch cycle calls :meth:`~repro_torch.io.reader.Dataset.refresh`, and
when a concurrent reorganization republishes ``index.json`` (generation
bump) or a writer appends, the whole cache is dropped — a served read
never executes a plan built against relocated extents.

**Streams.** The dispatcher thread launches on its own current stream, and
``read_super_planned`` returns only after that stream has finished: a
future resolves to a tensor whose kernel is done, so a client thread on
any stream may read it at once.

Per-tenant accounting rides along: :class:`TenantStats` per tenant,
:class:`ServiceStats` for the service, and every served request appends a
tenant-tagged record to the dataset's access log (and a ``serve`` event to
an attached trace), so :class:`~repro_torch.core.policy.LayoutPolicy`
scores the *aggregate* traffic mix while per-tenant slices stay
exportable (``AccessLog.export_prior(tenant=...)``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Sequence

import numpy as np

from ..core.blocks import Block
from ..device import resolve_device
from ..io.reader import Dataset, ReadStats
from .coalesce import Request, SuperPlan, build_super_plan, union_spans

__all__ = ["ReadService", "ServiceStats", "TenantStats"]

#: default coalescing window (seconds): long enough for concurrent clients'
#: submissions to land in one batch, short enough to be invisible next to a
#: cold storage read
DEFAULT_WINDOW_S = 0.002
DEFAULT_MAX_BATCH = 64
DEFAULT_MAX_INFLIGHT = 256 << 20
DEFAULT_CACHE_PLANS = 128


@dataclasses.dataclass
class TenantStats:
    """Per-tenant service accounting (one instance per tenant name)."""

    requests: int = 0
    bytes_served: int = 0
    seconds: float = 0.0          # apportioned share of batch wall time
    coalesced: int = 0            # requests served from a shared super-plan


@dataclasses.dataclass
class ServiceStats:
    batches: int = 0
    requests: int = 0
    super_plans: int = 0          # distinct (var-group) gathers executed
    cache_hits: int = 0           # super-plans served from the plan cache
    cache_misses: int = 0
    invalidations: int = 0        # cache drops on index staleness change
    refreshes: int = 0            # index reloads observed
    bytes_served: int = 0         # payload bytes across all members
    fetch_bytes: int = 0          # bytes the shared gathers transferred
    deferred: int = 0             # requests pushed past a full batch


@dataclasses.dataclass
class _Pending:
    request: Request
    future: Future
    nbytes: int            # logical payload estimate (fallback accounting)
    #: stored byte spans the request's plan would fetch —
    #: ``(subfiles, lo, hi)`` arrays, or ``None`` when planning failed;
    #: admission control unions these across the batch, so overlapping
    #: requests (fetched once) and compressed extents (stored < logical)
    #: are charged what the shared gather actually transfers
    spans: tuple | None = None


class ReadService:
    """Coalescing multi-tenant read front door on one open ``Dataset``.

    Use as a context manager, or call :meth:`close` — pending requests are
    drained before the dispatcher exits.  ``engine`` pins the gather
    engine (default: the dataset's own, usually ``"auto"``); ``device`` is
    where the results land (default: the dataset's).
    """

    def __init__(self, dataset: Dataset, *,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 max_inflight_bytes: int = DEFAULT_MAX_INFLIGHT,
                 cache_plans: int = DEFAULT_CACHE_PLANS,
                 engine: str | None = None, device=None):
        self._ds = dataset
        self.device = dataset.device if device is None \
            else resolve_device(device)
        self._window = float(window_s)
        self._max_batch = int(max_batch)
        self._max_inflight = int(max_inflight_bytes)
        self._cache_plans = int(cache_plans)
        self._engine = engine
        self._cond = threading.Condition()
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._flush = False
        self._closed = False
        self._plans: "OrderedDict[tuple, SuperPlan]" = OrderedDict()
        self._index_key = (dataset.generation, len(dataset.index.chunks))
        self.stats = ServiceStats()
        self.tenants: "dict[str, TenantStats]" = {}
        self._stats_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run,
                                        name="read-service", daemon=True)
        self._thread.start()

    # -- front doors ---------------------------------------------------------
    def submit(self, tenant: str, var: str, region: Block) -> Future:
        """Enqueue one region query; returns a Future of
        ``(tensor, ReadStats)``.  Thread-safe; callers from any thread share
        the same coalescing window."""
        return self._enqueue(Request(tenant, var, region))

    def read_batch(self, requests: Sequence[Request]) -> list:
        """Batch front door: submit ``requests`` together and block for all
        results (in request order).  The batch flushes the window
        immediately — callers that already hold a batch don't pay the
        arrival wait."""
        futures = [self._enqueue(r, notify=False) for r in requests]
        with self._cond:
            self._flush = True
            self._cond.notify_all()
        return [f.result() for f in futures]

    def _enqueue(self, req: Request, notify: bool = True) -> Future:
        fut: Future = Future()
        try:
            vol = 1
            for n in req.region.shape:
                vol *= int(n)
            nbytes = vol * self._ds.index.var_dtype(req.var).itemsize
        except KeyError:
            nbytes = 0            # unknown var: admit, fail in the batch
        spans = None
        try:
            plan = self._ds.plan_read(req.var, req.region)
            spans = (plan.subfiles, plan.file_lo, plan.file_hi)
        except Exception:  # noqa: BLE001 — admission falls back to logical
            pass
        with self._cond:
            if self._closed:
                raise RuntimeError("ReadService is closed")
            self._queues.setdefault(req.tenant, deque()).append(
                _Pending(req, fut, nbytes, spans))
            if notify:
                self._cond.notify_all()
        return fut

    # -- dispatcher ----------------------------------------------------------
    def _have_pending_locked(self) -> bool:
        return any(self._queues.values())

    def _drain_locked(self) -> list:
        """Round-robin one request per tenant per turn until the batch is
        full (fairness: a tenant with 1000 queued requests and a tenant
        with 2 both land their first requests in the same batch).  Closes
        on ``max_batch`` requests or ``max_inflight_bytes`` of estimated
        in-flight bytes — admission control; at least one request always
        enters.  The estimate is the *union of the stored byte spans* the
        batch would fetch (what the shared gather actually transfers):
        overlapping requests are not double-charged, and compressed
        extents count their stored (not logical) size.  A request whose
        plan could not be built falls back to its logical payload bytes.
        """
        batch: list = []
        span_parts: list = []    # (subfiles, lo, hi) per admitted request
        union_total = 0          # unioned stored bytes of span_parts
        logical_total = 0        # fallback bytes of plan-less requests
        while self._have_pending_locked():
            progressed = False
            for tenant in list(self._queues):
                q = self._queues[tenant]
                if not q:
                    continue
                nxt = q[0]
                if nxt.spans is not None and len(nxt.spans[0]):
                    parts = span_parts + [nxt.spans]
                    _, u_lo, u_hi = union_spans(
                        np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]),
                        np.concatenate([p[2] for p in parts]))
                    cand_union = int((u_hi - u_lo).sum())
                else:
                    cand_union = union_total
                cand_total = cand_union + logical_total + \
                    (nxt.nbytes if nxt.spans is None else 0)
                if batch and (len(batch) >= self._max_batch
                              or cand_total > self._max_inflight):
                    with self._stats_lock:
                        self.stats.deferred += sum(
                            len(d) for d in self._queues.values())
                    return batch
                batch.append(q.popleft())
                if nxt.spans is not None and len(nxt.spans[0]):
                    span_parts.append(nxt.spans)
                    union_total = cand_union
                elif nxt.spans is None:
                    logical_total += nxt.nbytes
                progressed = True
            if not progressed:
                break
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not self._have_pending_locked():
                    self._cond.wait()
                if self._closed and not self._have_pending_locked():
                    return
                if self._window > 0 and not self._flush:
                    deadline = time.monotonic() + self._window
                    while not self._flush and not self._closed:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                self._flush = False
                batch = self._drain_locked()
            if batch:
                self._execute(batch)

    # -- plan cache ----------------------------------------------------------
    def _check_index(self) -> None:
        """Per-cycle staleness check: reload a republished index and drop
        every cached plan the moment ``(generation, len(chunks))`` moves —
        a reorg commit bumps the generation, a plain append grows the
        chunk list; either way cached plans may name stale extents."""
        refreshed = self._ds.refresh()
        key = (self._ds.generation, len(self._ds.index.chunks))
        with self._stats_lock:
            if refreshed:
                self.stats.refreshes += 1
            if key != self._index_key:
                self._plans.clear()
                self._index_key = key
                self.stats.invalidations += 1

    def _super_plan(self, var: str, regions: Sequence[Block]) -> SuperPlan:
        key = (var, tuple((r.lo, r.hi) for r in regions))
        with self._stats_lock:
            sp = self._plans.get(key)
            if sp is not None:
                self._plans.move_to_end(key)
                self.stats.cache_hits += 1
                return sp
        sp = build_super_plan(self._ds.index, var, regions)
        with self._stats_lock:
            self.stats.cache_misses += 1
            self._plans[key] = sp
            while len(self._plans) > self._cache_plans:
                self._plans.popitem(last=False)
        return sp

    # -- execution -----------------------------------------------------------
    def _execute(self, batch: list) -> None:
        self._check_index()
        groups: "OrderedDict[str, list]" = OrderedDict()
        for p in batch:
            groups.setdefault(p.request.var, []).append(p)
        with self._stats_lock:
            self.stats.batches += 1
            self.stats.requests += len(batch)
        for var, members in groups.items():
            try:
                self._execute_group(var, members)
            except Exception as exc:  # noqa: BLE001 — fail THIS group only
                for p in members:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def _execute_group(self, var: str, members: list) -> None:
        sp = self._super_plan(var, [p.request.region for p in members])
        outs, fstats, member_stats = self._ds.read_super_planned(
            sp, engine=self._engine, device=self.device)
        # probe/plan time is paid once at construction; a cached plan's
        # later uses report zero (no probe happened)
        sp.probe_seconds = sp.plan_seconds = 0.0
        shared = len(members) > 1
        with self._stats_lock:
            self.stats.super_plans += 1
            self.stats.fetch_bytes += sp.fetch_bytes
            self.stats.bytes_served += sp.payload_bytes
        for p, out, st in zip(members, outs, member_stats):
            self._ds._record_access(var, p.request.region, st,
                                    tenant=p.request.tenant,
                                    trace_kind="serve")
            with self._stats_lock:
                ts = self.tenants.setdefault(p.request.tenant, TenantStats())
                ts.requests += 1
                ts.bytes_served += st.bytes_read
                ts.seconds += st.seconds
                ts.coalesced += int(shared)
            p.future.set_result((out, st))

    # -- lifecycle -----------------------------------------------------------
    def tenant_stats(self, tenant: str) -> TenantStats:
        with self._stats_lock:
            return dataclasses.replace(
                self.tenants.get(tenant, TenantStats()))

    def close(self) -> None:
        """Stop accepting requests, drain what is queued, join the
        dispatcher.  Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._flush = True
            self._cond.notify_all()
        self._thread.join()
        if self._ds._access_log is not None:
            self._ds._access_log.flush()

    def __enter__(self) -> "ReadService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
