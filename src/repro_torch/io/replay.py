"""Trace replay: drive a captured workload through the port's I/O stack on
the card.

:func:`replay_trace` takes a :class:`~repro_torch.io.trace.Trace` and a
scratch directory, materializes a synthetic dataset matching the trace
header (same shapes, dtypes and stored chunking; content from the header's
pinned seed), and dispatches every event through the port's components on
``device`` — :class:`~repro_torch.io.reader.Dataset`,
:class:`~repro_torch.serve.read_service.ReadService`,
:class:`~repro_torch.io.staging.StagingExecutor`,
:func:`~repro_torch.io.reader.reorganize`,
:class:`~repro_torch.checkpoint.manager.CheckpointManager` (the tree as
tensors) — asserting as it goes:

* **byte correctness** — every read (plain, decomposed, pattern, served,
  restored) is compared against the in-memory numpy oracle arrays;
* **determinism** — the replay folds every read's bytes, every
  ``PolicyDecision`` audit and every final index chunk table into one
  SHA-256 ``digest``; two replays of one trace produce the same hex.

The digest is fed exactly as the JAX package's replay feeds it — the same
tags in the same order, each read's bytes as the tensor's host bytes — so
a replay on the card, one on the CPU and the JAX package's replay of one
trace give one digest: the trace holds the whole stack to the reference.

Determinism is engineered, not hoped for:

* a :class:`ReplayClock` (fixed :data:`REPLAY_EPOCH`, fixed tick) is
  threaded through every component that stamps or decays access records,
  so recency weights are bit-identical across replays *and* immune to the
  real wall clock; the port reads back through paths that log nothing
  where the reference does, so both packages take the same clock ticks;
* layout policies are injected with the pinned
  :data:`~repro_torch.core.cost_model.FALLBACK_CALIBRATION` and
  ``cost_weighting=False`` — measured wall seconds (the one
  nondeterministic input) steer neither the candidate prices nor the
  record weights;
* engines are pinned by name (no calibration probe), staging replays
  single-worker (plan order == submit order), and the read service gets a
  window wide enough that each recorded batch coalesces as one batch.

Replay at reduced size is ``replay_trace(trace.scaled(k), ...)`` — the
header travels with the trace, so nothing else changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Sequence

import numpy as np
import torch

from ..core.blocks import Block
from ..core.cost_model import FALLBACK_CALIBRATION
from ..core.layouts import ChunkPlan, LayoutPlan
from ..core.policy import LayoutPolicy
from ..device import resolve_device
from ..interop import to_numpy, to_tensor
from .format import dtype_name, storage_dtype
from .patterns import resolve_pattern
from .reader import Dataset, reorganize
from .trace import Trace

__all__ = ["REPLAY_EPOCH", "ReplayClock", "ReplayError", "ReplayResult",
           "replay_trace"]

#: fixed epoch every replay clock starts from — NOT "now": anchoring at
#: the wall clock would round ``now - ts`` differently on every run and
#: leak nondeterminism into recency weights
REPLAY_EPOCH = 1_700_000_000.0

#: generous coalescing window for replayed serve batches: each recorded
#: batch must flush as ONE batch, not race the dispatcher
_SERVICE_WINDOW_S = 0.25


class ReplayError(AssertionError):
    """A replayed read diverged from the oracle (or the stack misbehaved)."""


class ReplayClock:
    """Deterministic time source: starts at ``start`` and advances a fixed
    ``tick`` per call, so the Nth timestamp of a replay is always the same
    float.  Thread-safe (staging workers and the service dispatcher share
    it)."""

    def __init__(self, start: float = REPLAY_EPOCH, tick: float = 1e-3):
        self._t = float(start)
        self._tick = float(tick)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self._t += self._tick
            return self._t


@dataclasses.dataclass
class ReplayResult:
    """What one replay did and proved."""

    digest: str                  # sha256 over read bytes + decisions + tables
    counts: dict                 # event kind -> events replayed
    bytes_verified: int          # oracle-checked payload bytes
    decisions: list              # policy decision audits, in event order
    dirs: dict                   # dst token -> dataset dir ("" = primary)
    data_dir: str
    stage_dir: str | None
    ckpt_dir: str | None
    clock_end: float             # final reading of the replay clock
    events: int


def _synth(seed: int, salt: int, shape, dtype) -> np.ndarray:
    """Deterministic synthetic content for one variable."""
    dt = storage_dtype(dtype)
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, int(salt)])
    if dtype_name(dt) == "bfloat16":
        # the reference's bfloat16 is of kind "V": zeros and ones, as bits
        x = torch.from_numpy(rng.integers(0, 2, size=shape))
        return x.to(torch.bfloat16).view(torch.int16).numpy().view(dt)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    if dt.kind in "iu":
        return rng.integers(0, 100, size=shape).astype(dt)
    return rng.integers(0, 2, size=shape).astype(dt)


def _identity_layout(chunks: Sequence, global_shape,
                     strategy: str = "reorganized") -> LayoutPlan:
    """A LayoutPlan whose chunks (and subfile homes) are given verbatim —
    replay materializes *exactly* the stored chunking the header (or a
    write event) recorded, not a re-derived one."""
    blocks = [Block(tuple(int(v) for v in lo), tuple(int(v) for v in hi),
                    owner=int(sf), block_id=i)
              for i, (lo, hi, sf) in enumerate(chunks)]
    return LayoutPlan(
        strategy=strategy, global_shape=tuple(int(s) for s in global_shape),
        chunks=tuple(ChunkPlan(chunk=b, sources=(b,), writer=b.owner,
                               subfile=b.owner) for b in blocks),
        num_subfiles=max((b.owner for b in blocks), default=0) + 1,
        inter_process_moved=0, intra_node_moved=0)


def _blocks(rows) -> list:
    return [Block(tuple(int(v) for v in lo), tuple(int(v) for v in hi),
                  owner=int(ow), block_id=int(bid))
            for lo, hi, ow, bid in rows]


def _host(t) -> np.ndarray:
    """A read result's bytes as a host array (the oracle's type)."""
    return to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


class _Replayer:
    def __init__(self, trace: Trace, workdir: str, engine: str,
                 calibration, verify: bool, device):
        if isinstance(engine, str) and engine == "auto":
            raise ValueError("replay needs a pinned engine name (auto "
                             "would probe the host storage — "
                             "nondeterministic by design)")
        self.trace = trace
        self.workdir = workdir
        self.engine = engine
        self.cal = calibration if calibration is not None \
            else FALLBACK_CALIBRATION
        self.verify = verify
        self.device = resolve_device(device)
        self.clock = ReplayClock()
        self.seed = trace.header.seed
        self._salt = 0
        self.oracle: dict = {}        # var -> full synthetic array
        self.staged_oracle: dict = {} # "var@step" -> array
        self.ckpt_oracle: dict = {}   # ckpt var -> array
        self.ckpt_scalars: dict = {}  # ckpt scalar -> dtype name
        self.data_dir = os.path.join(workdir, "data")
        self.stage_dir = os.path.join(workdir, "stage")
        self.ckpt_dir = os.path.join(workdir, "ckpt")
        self.dirs: dict = {"": self.data_dir}
        self.counts: dict = {}
        self.decisions: list = []
        self.bytes_verified = 0
        self._sha = hashlib.sha256()
        self.ds: Dataset | None = None
        self.service = None
        self.stager = None
        self.mgr = None

    # -- bookkeeping ---------------------------------------------------------
    def _next_salt(self) -> int:
        self._salt += 1
        return self._salt

    def _feed(self, tag: str, payload: bytes) -> None:
        self._sha.update(tag.encode())
        self._sha.update(payload)

    def _feed_json(self, tag: str, obj) -> None:
        self._feed(tag, json.dumps(obj, sort_keys=True).encode())

    def _check(self, where: str, got, expect: np.ndarray) -> None:
        got = _host(got)
        self._feed(where, np.ascontiguousarray(got).tobytes())
        if not self.verify:
            return
        if got.shape != expect.shape or got.dtype != expect.dtype \
                or not np.array_equal(got, expect):
            raise ReplayError(
                f"{where}: replayed bytes diverge from oracle "
                f"(shape {got.shape} vs {expect.shape}, "
                f"dtype {got.dtype} vs {expect.dtype})")
        self.bytes_verified += int(expect.nbytes)

    def _count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def _tensors(self, arr: np.ndarray, layout: LayoutPlan) -> dict:
        """The layout's source blocks of ``arr`` as tensors on the device:
        the writes assemble their chunks there."""
        return {cp.chunk.block_id: to_tensor(arr[cp.chunk.slices()],
                                             self.device)
                for cp in layout.chunks}

    def _open(self, dirpath: str, **kw) -> Dataset:
        return Dataset.open(dirpath, engine=self.engine, calibration=self.cal,
                            device=self.device, **kw)

    # -- setup ---------------------------------------------------------------
    def materialize(self) -> None:
        """Build the synthetic dataset the header describes: same shapes,
        dtypes and stored chunk extents, content from the pinned seed."""
        boot = Dataset.create(self.data_dir, engine=self.engine,
                              calibration=self.cal, clock=self.clock,
                              device=self.device)
        for var, meta in self.trace.header.variables.items():
            shape = tuple(int(s) for s in meta["shape"])
            arr = _synth(self.seed, self._next_salt(), shape, meta["dtype"])
            self.oracle[var] = arr
            chunks = meta.get("chunks") or \
                [[[0] * len(shape), list(shape), 0]]
            layout = _identity_layout(chunks, shape)
            boot.write(var, layout, arr.dtype, self._tensors(arr, layout))
        boot.flush()
        boot.close()
        # reopen so the session stats the on-disk index: refresh() after an
        # in-place reorganize must see the republished file
        self.ds = self._open(self.data_dir, clock=self.clock)

    def _policy(self, log) -> LayoutPolicy:
        return LayoutPolicy(log=log, calibration=self.cal,
                            cost_weighting=False)

    # -- event dispatch ------------------------------------------------------
    def run(self) -> ReplayResult:
        self.materialize()
        events = self.trace.events
        i = 0
        try:
            while i < len(events):
                ev = events[i]
                if ev.kind == "serve":
                    j = i
                    while j < len(events) and events[j].kind == "serve":
                        j += 1
                    self._serve(events[i:j])
                    i = j
                    continue
                getattr(self, f"_ev_{ev.kind}")(ev)
                i += 1
            self._finalize()
        finally:
            if self.service is not None:
                self.service.close()
            if self.stager is not None:
                try:
                    self.stager.close()
                except Exception:   # noqa: BLE001 — already closed is fine
                    pass
            if self.ds is not None:
                self.ds.close()
        return ReplayResult(
            digest=self._sha.hexdigest(), counts=self.counts,
            bytes_verified=self.bytes_verified, decisions=self.decisions,
            dirs=dict(self.dirs), data_dir=self.data_dir,
            stage_dir=self.stage_dir if self.stager is not None else None,
            ckpt_dir=self.ckpt_dir if self.mgr is not None else None,
            clock_end=self.clock(), events=len(events))

    # each _ev_<kind> drives one event through the real component
    def _ev_read(self, ev) -> None:
        self._count("read")
        arr, _ = self.ds.read(ev.var, ev.region)
        self._check(f"read:{ev.seq}", arr,
                    self.oracle[ev.var][ev.region.slices()])

    def _ev_read_decomposed(self, ev) -> None:
        self._count("read_decomposed")
        self.ds.read_decomposed(ev.var, ev.region,
                                tuple(ev.params["scheme"]))
        # decomposed reads return stats, not bytes: verify through a read
        # on the device that logs no access (as the reference's
        # read_planned logs none)
        arr, _ = self.ds._read(ev.var, ev.region, None, None)
        self._check(f"read_decomposed:{ev.seq}", arr,
                    self.oracle[ev.var][ev.region.slices()])

    def _ev_read_pattern(self, ev) -> None:
        self._count("read_pattern")
        p = ev.params
        self.ds.read_pattern(ev.var, p["pattern"],
                             num_readers=int(p["num_readers"]),
                             slab_thickness=p.get("slab_thickness"))
        region = resolve_pattern(self.ds.index.var_shape(ev.var),
                                 p["pattern"], p.get("slab_thickness"))
        arr, _ = self.ds._read(ev.var, region, None, None)
        self._check(f"read_pattern:{ev.seq}", arr,
                    self.oracle[ev.var][region.slices()])

    def _serve(self, batch: list) -> None:
        from ..serve.read_service import ReadService
        from ..serve.coalesce import Request
        if self.service is None:
            self.service = ReadService(
                self.ds, window_s=_SERVICE_WINDOW_S,
                max_batch=max(4096, len(batch)),
                max_inflight_bytes=1 << 40, engine=self.engine)
        results = self.service.read_batch(
            [Request(ev.tenant, ev.var, ev.region) for ev in batch])
        for ev, (arr, _st) in zip(batch, results):
            self._count("serve")
            self._check(f"serve:{ev.seq}:{ev.tenant}", arr,
                        self.oracle[ev.var][ev.region.slices()])

    def _ev_write(self, ev) -> None:
        self._count("write")
        p = ev.params
        shape = tuple(int(s) for s in p["global_shape"])
        dt = storage_dtype(p["dtype"])
        arr = self.oracle.get(ev.var)
        if arr is None or arr.shape != shape or arr.dtype != dt:
            arr = _synth(self.seed, self._next_salt(), shape, dt)
            self.oracle[ev.var] = arr
        layout = _identity_layout(p["chunks"], shape,
                                  strategy=p.get("strategy", "reorganized"))
        self.ds.write(ev.var, layout, dt, self._tensors(arr, layout),
                      align=p.get("align"), codec=p.get("codec", "none"))

    def _ev_stage_submit(self, ev) -> None:
        self._count("stage_submit")
        from .staging import StagingExecutor
        p = ev.params
        if self.stager is None:
            # single worker: WritePlans are built at dequeue time, so one
            # worker == submit order == deterministic append offsets
            self.stager = StagingExecutor(self.stage_dir, num_workers=1,
                                          engine=self.engine,
                                          clock=self.clock,
                                          device=self.device)
        shape = tuple(int(s) for s in p["global_shape"])
        arr = _synth(self.seed, self._next_salt(), shape, p["dtype"])
        self.staged_oracle[f"{ev.var}@{p['step']}"] = arr
        layout = _identity_layout(p["chunks"], shape,
                                  strategy=p.get("strategy", "reorganized"))
        self.stager.submit(int(p["step"]), ev.var, arr.dtype, layout,
                           self._tensors(arr, layout))

    def _ev_reorganize(self, ev) -> None:
        self._count("reorganize")
        p = ev.params
        token = p.get("dst") or ""
        in_place = token == ""
        dst_dir = self.data_dir if in_place \
            else os.path.join(self.workdir, f"reorg_{token}")
        align = p.get("align")
        if p["layout"] == "auto":
            _, dst, _ = reorganize(
                self.data_dir, dst_dir, ev.var, "auto", engine=self.engine,
                align=align, policy=self._policy(self.ds.access_log),
                now=self.clock(), clock=self.clock, device=self.device)
            audit = dst.index.attrs.get("policy", {}).get(ev.var)
            self.decisions.append({"seq": ev.seq, "op": "reorganize",
                                   "var": ev.var, "decision": audit})
            self._feed_json(f"reorganize:{ev.seq}", audit)
        else:
            layout = _identity_layout(
                p["layout"]["chunks"],
                self.ds.index.var_shape(ev.var),
                strategy=p["layout"].get("strategy", "reorganized"))
            _, dst, _ = reorganize(self.data_dir, dst_dir, ev.var, layout,
                                   engine=self.engine, align=align,
                                   clock=self.clock, device=self.device)
        dst.close()
        if in_place:
            if not self.ds.refresh():
                raise ReplayError("in-place reorganize did not republish "
                                  "the index (refresh() saw no change)")
        else:
            self.dirs[token] = dst_dir

    def _ensure_mgr(self, strategy: str, align):
        from ..checkpoint.manager import CheckpointManager
        if self.mgr is None:
            self.mgr = CheckpointManager(
                self.ckpt_dir, strategy=strategy, keep=0, align=align,
                engine=self.engine, auto_prior=False, clock=self.clock,
                device=self.device)
            self.mgr._policy = self._policy(self.mgr.access_log)
        self.mgr.strategy = strategy
        self.mgr.align = align
        return self.mgr

    def _ev_ckpt_save(self, ev) -> None:
        self._count("ckpt_save")
        p = ev.params
        mgr = self._ensure_mgr(p["strategy"], p.get("align"))
        tree: dict = {}
        block_map: dict = {}
        for name, meta in p["vars"].items():
            shape = tuple(int(s) for s in meta["shape"])
            dt = storage_dtype(meta["dtype"])
            arr = self.ckpt_oracle.get(name)
            if arr is None or arr.shape != shape or arr.dtype != dt:
                arr = _synth(self.seed, self._next_salt(), shape, dt)
                self.ckpt_oracle[name] = arr
            tree[name] = to_tensor(arr, self.device)
            block_map[name] = _blocks(meta["blocks"])
        for name, dt in p.get("scalars", {}).items():
            self.ckpt_scalars[name] = dt
            tree[name] = to_tensor(np.zeros((), dtype=dt), self.device)
        self.mgr.save(int(p["step"]), tree, block_map=block_map)
        manifest = os.path.join(mgr.step_dir(int(p["step"])), "manifest.json")
        with open(manifest) as f:
            audit = json.load(f).get("policy")
        if audit:
            self.decisions.append({"seq": ev.seq, "op": "ckpt_save",
                                   "step": int(p["step"]),
                                   "decision": audit})
            self._feed_json(f"ckpt_save:{ev.seq}", audit)

    def _ev_ckpt_restore(self, ev) -> None:
        self._count("ckpt_restore")
        p = ev.params
        if self.mgr is None:
            raise ReplayError(f"ckpt_restore (seq {ev.seq}) before any "
                              f"ckpt_save in this trace")
        targets = p.get("targets")
        tb = {name: _blocks(rows) for name, rows in targets.items()} \
            if targets else None
        flat, _ = self.mgr.restore(int(p["step"]), target_blocks=tb)
        for name in sorted(flat):
            val = flat[name]
            if name in self.ckpt_scalars:
                exp = np.zeros((), dtype=storage_dtype(
                    self.ckpt_scalars[name]))
                self._check(f"ckpt_restore:{ev.seq}:{name}", val, exp)
                continue
            oracle = self.ckpt_oracle[name]
            if isinstance(val, dict):          # elastic: shards by block_id
                for b in tb[name]:
                    self._check(
                        f"ckpt_restore:{ev.seq}:{name}:{b.block_id}",
                        val[b.block_id], oracle[b.slices()])
            else:
                self._check(f"ckpt_restore:{ev.seq}:{name}", val, oracle)

    # -- finalization --------------------------------------------------------
    def _finalize(self) -> None:
        """Drain staging, verify every materialized dataset end-state
        against the oracle, and fold all final chunk tables (and
        checkpoint manifests) into the digest."""
        if self.stager is not None:
            results = self.stager.drain()
            errs = [r.error for r in results if r.error]
            if errs and self.verify:
                raise ReplayError(f"staging workers failed: {errs}")
            self.stager.close()
            sds = self._open(self.stage_dir, telemetry=False)
            for var in sorted(sds.index.variables):
                shape = sds.index.var_shape(var)
                full = Block((0,) * len(shape), shape)
                arr, _ = sds._read(var, full, None, None)
                self._check(f"final:stage:{var}", arr,
                            self.staged_oracle[var])
            sds.close()
            self.stager = None
        for token in sorted(self.dirs):
            d = self.dirs[token]
            ds = self.ds if d == self.data_dir else \
                self._open(d, telemetry=False)
            for var in sorted(ds.index.variables):
                shape = ds.index.var_shape(var)
                full = Block((0,) * len(shape), shape)
                arr, _ = ds._read(var, full, None, None)
                self._check(f"final:{token}:{var}", arr, self.oracle[var])
            if ds is not self.ds:
                ds.close()
        # final metadata state: chunk tables + attrs of every index this
        # replay produced, plus checkpoint manifests
        tables = []
        for root, dirnames, filenames in sorted(os.walk(self.workdir)):
            dirnames.sort()
            for fn in sorted(filenames):
                if fn in ("index.json", "manifest.json"):
                    tables.append(os.path.join(root, fn))
        for path in tables:
            with open(path) as f:
                content = json.load(f)
            rel = os.path.relpath(path, self.workdir)
            self._feed_json(f"table:{rel}", content)


def replay_trace(trace: Trace, workdir: str, *, engine: str = "memmap",
                 calibration=None, verify: bool = True,
                 device="cuda") -> ReplayResult:
    """Replay ``trace`` inside ``workdir`` (created; must be scratch), every
    component on ``device`` (``"cuda"`` unless ``"cpu"`` is asked for).

    ``engine`` pins the execution engine by name (``"auto"`` is rejected —
    it would probe the host's storage, which is nondeterministic by
    design); ``calibration`` pins the cost-model constants every injected
    policy predicts with (default
    :data:`~repro_torch.core.cost_model.FALLBACK_CALIBRATION`);
    ``verify=False`` skips the oracle assertions but still builds the
    digest (useful for pure timing runs).  Raises :class:`ReplayError` on
    any byte divergence."""
    os.makedirs(workdir, exist_ok=True)
    return _Replayer(trace, workdir, engine, calibration, verify,
                     device).run()
