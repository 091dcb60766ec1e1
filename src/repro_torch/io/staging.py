"""Asynchronous staging executor (paper §5: Strong-Staging-Coupler motif),
with the producer's blocks on the card.

The producer (simulation / training step) ``submit()``s one output at a time;
staging workers assemble the read-optimized layout and write it while the
producer keeps computing.  A bounded queue of depth ``queue_depth`` models the
staging nodes' buffer space: when it is full the producer blocks — the paper's
``t_s + t_w > t_c`` regime where "the computation will be delayed".

**The transfer is a snapshot.**  ``submit`` copies the producer's block
tensors on the producer's current stream — one card-to-card copy into one
flat buffer, the blocks back to back in ``block_id`` order — and records an
event after it; host tensors and ndarrays are copied on the host, as the
JAX package's executor copies its arrays.  The producer may then update its
tensors in place (an optimizer step, the next time step): the staged output
is the data as they were at ``submit``.

**The workers** are threads, each with its own CUDA stream and its own
pinned host buffer (``Dataset``'s per-thread staging).  A worker waits on
the snapshot's event on its stream — never on the whole device, so the
producer's kernels keep running — then assembles the chunks there
(:func:`~repro_torch.io.device.assemble_chunks`: ``pack_rows``, and
``rowmajor_to_chunked`` for a 2-D even grid, the snapshot entering the
kernel as it is), copies them to the host once, and writes them through the
shared :class:`~repro_torch.io.reader.Dataset` session: offsets are
reserved by ``plan_write`` under the session lock, and the index records a
step's chunks only after every extent of its plan landed; ``index.json``
itself is flushed on :meth:`StagingExecutor.close`.  A worker whose step
fails records the exception in ``StageResult.error`` (the step's extents
become dead space, the index never saw them) and stays alive; the producer
can re-submit the step.

**Device memory is bounded**: at most ``queue_depth + num_workers + 1``
snapshots are alive at once (those queued, one in each worker, and the one
a blocked ``submit`` holds), plus one assembled output and its row tables
in each worker.

Measured per output:
  t_s  — the snapshot plus the worker's assembly (lowering, kernel, the
         copy to the host)
  t_w  — the engine's write of the reorganized chunks
  stall — how long ``submit`` blocked the producer (its return value)

An optional ``link_gbps`` throttle emulates a constrained producer→stager
interconnect for model-calibration experiments.  ``trace=`` (a
:class:`~repro_torch.io.trace.TraceRecorder`) journals one ``stage_submit``
event a ``submit``, as the JAX package's executor does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core.blocks import Block, bounding_box
from ..core.layouts import LayoutPlan
from ..core.policy import LayoutPolicy
from ..device import resolve_device
from .engine import IOEngine
from .format import DatasetIndex, dtype_name, storage_dtype
from .reader import Dataset

__all__ = ["StageResult", "StagingExecutor"]


@dataclasses.dataclass
class StageResult:
    step: int
    t_s: float = 0.0            # stage (snapshot + assemble) seconds
    t_w: float = 0.0            # write seconds
    stall: float = 0.0          # producer-side blocking
    bytes_staged: int = 0
    num_chunks: int = 0
    engine: str = ""            # engine that executed this step's WritePlan
    error: str | None = None    # worker-side failure (step is retryable)
    engine_reason: str = ""     # why that engine ("pinned", or the auto rule)
    #: the worker's assembly stages on the card: lowering to row tables,
    #: the kernels (from the wait on the snapshot), the copy to the host
    lower_seconds: float = 0.0
    kernel_seconds: float = 0.0
    d2h_seconds: float = 0.0


def _snapshot(data: Mapping) -> tuple:
    """A copy of ``data`` the producer cannot reach, and the event after
    it (None when nothing lies on a card).  Tensors of one dtype on one
    device are copied into ONE flat buffer, back to back in key order, on
    the current stream, with no temporary beside it; anything else is
    copied one by one."""
    tensors = [v for v in data.values() if isinstance(v, torch.Tensor)]
    kinds = {(t.dtype, t.device) for t in tensors}
    cuda = {t.device for t in tensors if t.device.type == "cuda"}
    if len(cuda) > 1:
        raise ValueError(f"block tensors lie on several cards: {cuda}")
    with torch.no_grad():
        if len(tensors) == len(data) and len(kinds) == 1:
            (dtype, device), = kinds
            flat = torch.empty(sum(t.numel() for t in tensors), dtype=dtype,
                               device=device)
            staged, pos = {}, 0
            for k in sorted(data):
                n = data[k].numel()
                staged[k] = flat[pos:pos + n].view(data[k].shape)
                staged[k].copy_(data[k])
                pos += n
        else:
            staged = {k: v.clone() if isinstance(v, torch.Tensor)
                      else np.copy(v) for k, v in data.items()}
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda.pop()))
    return staged, event


class StagingExecutor:
    """``num_workers`` staging processes on ``m`` staging nodes, as threads,
    each with its own CUDA stream.  ``device`` is the session's (``"cuda"``
    unless ``"cpu"`` is asked for)."""

    def __init__(self, dirpath: str, num_workers: int = 2,
                 queue_depth: int = 2, link_gbps: float | None = None,
                 align: int | None = None,
                 engine: str | IOEngine = "auto",
                 policy: LayoutPolicy | None = None,
                 prior: str | None = None,
                 trace=None, clock=None, device="cuda"):
        self.device = resolve_device(device)
        self.dirpath = dirpath
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        self.link_gbps = link_gbps
        self.align = align
        #: attached :class:`~repro_torch.io.trace.TraceRecorder`: each
        #: ``submit`` journals one ``stage_submit`` event (producer-side —
        #: the requested layout, not the worker's wall time)
        self.trace = trace
        #: layout decision-maker behind ``submit(..., plan="auto")``; by
        #: default a history-less policy (dimension-aware default scheme);
        #: ``prior=`` (a previous run's ``access_log.json`` / exported
        #: prior / directory) seeds its decisions
        self.policy = policy if policy is not None else LayoutPolicy()
        if prior is not None:
            self.policy = self.policy.with_prior(prior)
        self._decisions: dict = {}    # cache key -> PolicyDecision
        self._ds = Dataset.create(dirpath, engine=engine, clock=clock,
                                  device=self.device)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._results: list = []
        self._lock = threading.Lock()
        self._stop = False
        self._workers = [threading.Thread(target=self._worker,
                                          args=(self._stream(),),
                                          daemon=True)
                         for _ in range(num_workers)]
        for w in self._workers:
            w.start()

    def _stream(self):
        if self.device.type == "cuda":
            return torch.cuda.Stream(self.device)
        return None

    # -- producer side -------------------------------------------------------
    def layout_for(self, var: str, blocks: Sequence[Block],
                   global_shape: Sequence[int] | None = None,
                   prior: str | None = None) -> LayoutPlan:
        """The policy-chosen staging layout for ``var`` (cached per
        ``(var, global_shape, prior)`` so repeated steps score the
        candidates once).  A staged write gathers nothing from storage, so
        only the write-side build cost and the expected read mix are
        charged.  ``prior`` seeds this one decision from a previous run's
        history (per-call override of the executor-level prior)."""
        return self.decision_for(var, blocks, global_shape, prior).layout

    def decision_for(self, var: str, blocks: Sequence[Block],
                     global_shape: Sequence[int] | None = None,
                     prior: str | None = None):
        """The cached :class:`~repro_torch.core.policy.PolicyDecision`
        behind :meth:`layout_for`."""
        blocks = list(blocks)
        if global_shape is None:
            global_shape = bounding_box(blocks).hi
        key = (var, tuple(global_shape), prior)
        if key not in self._decisions:
            pol = self.policy if prior is None \
                else self.policy.with_prior(prior)
            self._decisions[key] = pol.choose_layout(
                var, blocks, global_shape, num_stagers=self.num_workers,
                align=self.align)
        return self._decisions[key]

    def submit(self, step: int, var: str, dtype,
               plan: LayoutPlan | str, data: Mapping,
               blocks: Sequence[Block] | None = None,
               global_shape: Sequence[int] | None = None,
               prior: str | None = None) -> float:
        """Hand one output to staging: snapshot the producer's block data
        (``data``: block_id -> tensor or ndarray; the transfer) and
        enqueue; returns seconds the producer was blocked (queue full =>
        blocking regime).

        ``plan="auto"`` routes the layout choice through the executor's
        :class:`~repro_torch.core.policy.LayoutPolicy` — ``blocks`` (the
        producer's decomposition) is required then, ``global_shape``
        defaults to the blocks' bounding box, and ``prior`` seeds the
        decision when this run has no telemetry yet.
        """
        if isinstance(plan, str):
            if plan != "auto":
                raise ValueError(f"plan must be a LayoutPlan or 'auto', "
                                 f"got {plan!r}")
            if blocks is None:
                raise ValueError("plan='auto' needs blocks= (the producer's "
                                 "block decomposition)")
            plan = self.layout_for(var, blocks, global_shape, prior=prior)
        t0 = time.perf_counter()
        staged, event = _snapshot(data)                  # the transfer
        if self.link_gbps:
            nbytes = sum(v.nbytes for v in staged.values())
            budget = nbytes / (self.link_gbps * 1e9)
            elapsed = time.perf_counter() - t0
            if budget > elapsed:
                time.sleep(budget - elapsed)
        copy_s = time.perf_counter() - t0
        nbytes = sum(v.nbytes for v in staged.values())
        t1 = time.perf_counter()
        self._q.put((step, var, storage_dtype(dtype), plan, staged, event,
                     copy_s))
        stall = time.perf_counter() - t1
        if self.trace is not None:
            chunks = [[[int(v) for v in c.chunk.lo],
                       [int(v) for v in c.chunk.hi], int(c.subfile)]
                      for c in plan.chunks]
            bbox = bounding_box([c.chunk for c in plan.chunks])
            self.trace.record(
                "stage_submit", var=var, region=bbox,
                seconds=copy_s + stall, nbytes=nbytes, step=int(step),
                chunks=chunks, dtype=dtype_name(dtype),
                global_shape=[int(s) for s in plan.global_shape],
                strategy=plan.strategy)
        return stall

    def drain(self) -> list:
        """Wait for all submitted outputs; returns StageResults in step order."""
        self._q.join()
        with self._lock:
            out = sorted(self._results, key=lambda r: r.step)
        return out

    def close(self) -> None:
        self._q.join()
        self._stop = True
        for _ in self._workers:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
        for w in self._workers:
            w.join(timeout=5)
        self._ds.flush()
        self._ds.close()

    @property
    def index(self) -> DatasetIndex:
        return self._ds.index

    @property
    def dataset(self) -> Dataset:
        return self._ds

    # -- worker side -----------------------------------------------------------
    @staticmethod
    def _on_stream(stream, event, staged: Mapping):
        """Run the step's device work on the worker's ``stream``, after the
        snapshot's ``event``; the snapshot is marked as used there, so the
        allocator keeps its memory until this stream's work is done."""
        if stream is None:
            return contextlib.nullcontext()
        if event is not None:
            stream.wait_event(event)
        for v in staged.values():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                v.record_stream(stream)
        return torch.cuda.stream(stream)

    def _worker(self, stream) -> None:
        while not self._stop:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, var, dtype, plan, staged, event, copy_s = item
            del item
            res = StageResult(step=step)
            try:
                with self._on_stream(stream, event, staged):
                    wplan = self._ds.plan_write(f"{var}@{step}", plan, dtype,
                                                align=self.align)
                    ws = self._ds.write_planned(wplan, staged, flush=False)
                res.t_s = copy_s + ws.assemble_seconds
                res.t_w = ws.write_seconds
                res.bytes_staged = ws.bytes_written
                res.num_chunks = ws.num_extents
                res.engine = ws.engine
                res.engine_reason = ws.engine_reason
                res.lower_seconds = ws.lower_seconds
                res.kernel_seconds = ws.kernel_seconds
                res.d2h_seconds = ws.d2h_seconds
            except Exception as e:        # noqa: BLE001 — step is retryable
                # extents may exist (dead space); the index commit never
                # happened, so the producer can re-submit this step
                res.error = f"{type(e).__name__}: {e}"
            finally:
                staged = None             # the snapshot goes back
                with self._lock:
                    self._results.append(res)
                self._q.task_done()
