"""Layout-aware checkpoint manager with the tensors on the card.

Checkpoints are datasets in the paper's container format, laid out as the
JAX package's manager lays them out (the same ``index.json`` chunk tables
and ``manifest.json``: a checkpoint either package wrote restores under
the other); the layout strategy is a policy knob:
  * ``subfiled_fpp``   — write-optimal: every host logs its shards (ADIOS2
    default; fastest save, fragmented restore);
  * ``merged_process`` — the paper's contribution 1: Berger–Rigoutsos merge
    of each host's shards before writing (near-write-optimal save, far fewer
    chunks on restore);
  * ``merged_node``    — merge across a node group (pod slice);
  * ``reorganized``    — the paper's contribution 2 target layout: regular
    K-way decomposition, read-optimal for elastic restarts (written post-hoc
    or on the fly through :mod:`repro_torch.checkpoint.async_ckpt`);
  * ``auto``           — per-variable layouts chosen by a
    :class:`~repro_torch.core.policy.LayoutPolicy` from the *restore
    patterns this manager has observed*: every restore appends pattern
    fingerprints to ``access_log.json`` at the checkpoint root, and the
    next ``save`` scores candidate layouts against that history (seeded by
    a cross-run prior when the root has none); the decisions land in the
    manifest under ``"policy"``.

**Save** slices each leaf into its blocks as views, on the tensor's device,
and ``Dataset.write`` assembles the chunks there
(:mod:`repro_torch.io.device`): one ``pack_rows`` launch a leaf merges
every host's shards (``rowmajor_to_chunked`` after it for a 2-D
``reorganized`` leaf on an even grid), then one copy crosses to the host
and the engine writes the container.

**Restore** returns tensors on the manager's device.  A whole variable
takes ``Dataset.read``'s device route (one engine read, one copy, one
``pack_rows`` or ``chunked_to_rowmajor`` launch); the shards of a new
decomposition (``target_blocks``, the elastic restart) take the region
route: each touched extent read once, one copy, ONE ``pack_rows`` launch
for all of a variable's targets.  Compressed chunks take the host plan and
one copy a target.

Not ported yet, each raising ``NotImplementedError`` that names its
``ROADMAP.md`` item: ``trace=`` (trace capture, S3); bfloat16 leaves (S9).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core.blocks import Block
from ..core.layouts import plan_layout
from ..core.policy import (ACCESS_PRIOR_NAME, AccessLog, AccessRecord,
                           LayoutPolicy)
from ..device import resolve_device
from ..interop import to_tensor
from ..io.device import read_regions, read_route
from ..io.engine import IOEngine
from ..io.reader import Dataset, ReadStats
from .blocks_map import blocks_from_sharding, flatten_pytree, unflatten_like

__all__ = ["CheckpointManager", "SaveStats", "RestoreStats",
           "ACCESS_PRIOR_NAME"]

MANIFEST = "manifest.json"


def _waits(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it waits for "
                               f"{item}")


def _bf16() -> NotImplementedError:
    return _waits("a bfloat16 checkpoint variable",
                  "bf16 container variables (S9 in ROADMAP.md queue 1)")


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        raise _bf16()
    return torch.empty(0, dtype=dtype).numpy().dtype


@dataclasses.dataclass
class SaveStats:
    step: int
    seconds: float
    bytes: int
    num_chunks: int
    num_original_blocks: int
    per_var_seconds: dict
    #: sums over the leaves of ``Dataset.write``'s stages: lowering the
    #: layout to row tables, the kernels, the one copy to the host (device
    #: route), the engine's write, and the checksums + index commit
    lower_seconds: float = 0.0
    kernel_seconds: float = 0.0
    d2h_seconds: float = 0.0
    write_seconds: float = 0.0
    commit_seconds: float = 0.0


@dataclasses.dataclass
class RestoreStats(ReadStats):
    """Aggregate restore stats plus the per-variable breakdown
    (``per_var[name]`` is that variable's merged :class:`ReadStats`).

    ``bytes_read`` and ``chunks_touched`` are the JAX package's (the host
    plans' payload bytes and chunk hits); ``runs`` and ``groups`` are the
    device routes' own (each stored extent read once, as one span).
    ``seconds`` is the engine's time plus probing and planning, as in the
    JAX package; the device stages are ``lower_seconds``, ``h2d_seconds``
    and ``linearize_seconds``."""

    per_var: dict = dataclasses.field(default_factory=dict)


class CheckpointManager:
    """The JAX package's constructor plus ``device`` (where restores land;
    ``"cuda"`` unless ``"cpu"`` is asked for).  ``clock`` stamps the
    restore records and is the ``auto`` save decision's recency reference;
    ``prior`` (a previous run's root or exported prior) seeds
    ``strategy="auto"`` until this root has restore telemetry of its own,
    and with ``auto_prior`` and no ``prior`` the freshest sibling root's
    exported prior (:meth:`discover_prior`) does."""

    def __init__(self, root: str, strategy: str = "merged_process",
                 devices_per_host: int = 4, hosts_per_node: int = 1,
                 keep: int = 3, reorg_scheme=None, align=None,
                 engine: str | IOEngine = "memmap",
                 policy: LayoutPolicy | None = None,
                 prior: str | None = None, auto_prior: bool = True,
                 clock=None, trace=None, device="cuda"):
        if trace is not None:
            raise _waits("trace=", "trace capture (S3 in ROADMAP.md "
                         "queue 1)")
        self.device = resolve_device(device)
        self.root = root
        self.strategy = strategy
        self.devices_per_host = devices_per_host
        self.hosts_per_node = hosts_per_node
        self.keep = keep
        self.reorg_scheme = reorg_scheme
        self.align = align
        self.engine = engine
        self._clock = clock if clock is not None else time.time
        os.makedirs(root, exist_ok=True)
        #: restore-pattern history, shared across steps (checkpoint root);
        #: appends are batched and flushed once at the end of every restore
        self.access_log = AccessLog(root, flush_every=16, clock=clock)
        self.prior = prior
        self.auto_prior = auto_prior
        self._policy = policy

    def discover_prior(self) -> str | None:
        """The newest ``access_prior.json`` exported by any *sibling* run
        root (a directory next to this manager's root: ``runs/run_001``,
        ``runs/run_002``, ...).  The manager's own root is excluded; no
        sibling prior means ``None``."""
        own = os.path.abspath(self.root)
        parent = os.path.dirname(own)
        best = None
        try:
            entries = os.listdir(parent)
        except OSError:
            return None
        for e in entries:
            d = os.path.join(parent, e)
            if os.path.abspath(d) == own or not os.path.isdir(d):
                continue
            p = os.path.join(d, ACCESS_PRIOR_NAME)
            try:
                mt = os.path.getmtime(p)
            except OSError:
                continue
            if best is None or mt > best[0]:
                best = (mt, p)
        return best[1] if best else None

    def layout_policy(self, prior: str | None = None) -> LayoutPolicy:
        """The policy ``strategy="auto"`` consults — over this manager's
        own restore-pattern log unless one was injected, seeded with
        ``prior`` (or the manager-level one, or the freshest sibling-run
        prior :meth:`discover_prior` finds) when available."""
        if self._policy is None:
            self._policy = LayoutPolicy(log=self.access_log)
            src = self.prior
            if src is None and self.auto_prior:
                src = self.discover_prior()
            if src is not None:
                self._policy = self._policy.with_prior(src)
        pol = self._policy
        if prior is not None:
            pol = pol.with_prior(prior)
        return pol

    def export_prior(self, path: str | None = None) -> str:
        """Snapshot this root's restore-pattern history as a cross-run
        prior a future run can pass as ``prior=``."""
        return self.access_log.export_prior(path)

    # -- paths ---------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self) -> list:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree, shardings=None,
             block_map: Mapping[str, Sequence[Block]] | None = None,
             prior: str | None = None) -> SaveStats:
        """``tree``: nested dicts, lists and tuples of tensors (params / opt
        state), on the card or the CPU.  ``shardings``: a matching tree of
        :class:`~repro_torch.checkpoint.blocks_map.MeshSharding` (or None:
        one block a leaf).  ``block_map``: explicit name->blocks override
        (tests / simulated hosts).  ``prior``: seed this save's
        ``strategy="auto"`` decisions from a previous run's restore
        history (per-call override of the manager-level ``prior=``)."""
        t0 = time.perf_counter()
        d = self.step_dir(step)
        flat = flatten_pytree(tree)
        flat_sh = flatten_pytree(shardings) if shardings is not None else {}
        ds = Dataset.create(d, engine=self.engine, clock=self._clock,
                            device=self.device)
        stats = SaveStats(step=step, seconds=0.0, bytes=0, num_chunks=0,
                          num_original_blocks=0, per_var_seconds={})
        scalars = {}
        policy_info = {}
        for name, t in flat.items():
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"leaf {name!r} is a {type(t).__name__}, "
                                f"not a tensor")
            tv = time.perf_counter()
            dtype = _np_dtype(t.dtype)
            if t.dim() == 0:
                scalars[name] = {"dtype": dtype.name, "value": t.item()}
                continue
            shape = tuple(t.shape)
            if block_map and name in block_map:
                blocks = list(block_map[name])
            elif name in flat_sh and flat_sh[name] is not None:
                blocks = blocks_from_sharding(shape, flat_sh[name],
                                              self.devices_per_host)
            else:
                blocks = [Block((0,) * t.dim(), shape, owner=0, block_id=0)]
            hosts = max(b.owner for b in blocks) + 1
            data = {b.block_id: t[b.slices()] for b in blocks}
            if self.strategy == "auto":
                # a save stages from memory: no gather term, only the
                # write-side build cost vs the expected restore mix
                decision = self.layout_policy(prior).choose_layout(
                    name, blocks, shape, num_procs=hosts,
                    procs_per_node=self.hosts_per_node, align=self.align,
                    now=self._clock())
                plan = decision.layout
                policy_info[name] = decision.to_json()
            else:
                scheme = None
                if self.strategy == "reorganized" and \
                        self.reorg_scheme is not None:
                    scheme = (tuple(self.reorg_scheme[:t.dim()])
                              + (1,) * max(0, t.dim()
                                           - len(self.reorg_scheme)))
                plan = plan_layout(self.strategy, blocks, num_procs=hosts,
                                   procs_per_node=self.hosts_per_node,
                                   global_shape=shape, reorg_scheme=scheme)
            # index.json is re-committed per variable, so a crash mid-save
            # leaves a readable prefix of the checkpoint
            ws = ds.write(name, plan, dtype, data, align=self.align)
            stats.per_var_seconds[name] = time.perf_counter() - tv
            stats.bytes += t.numel() * t.element_size()
            stats.num_chunks += plan.num_chunks
            stats.num_original_blocks += len(blocks)
            stats.lower_seconds += ws.lower_seconds
            stats.kernel_seconds += ws.kernel_seconds
            stats.d2h_seconds += ws.d2h_seconds
            stats.write_seconds += ws.write_seconds
            stats.commit_seconds += (ws.total_seconds - ws.assemble_seconds
                                     - ws.write_seconds)
        ds.close()
        manifest = {"step": step, "strategy": self.strategy,
                    "scalars": scalars,
                    "variables": sorted(k for k in flat if k not in scalars)}
        if policy_info:
            manifest["policy"] = policy_info
        with open(os.path.join(d, MANIFEST), "w") as f:
            json.dump(manifest, f)
        self._retain()
        stats.seconds = time.perf_counter() - t0
        return stats

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def restore(self, step: int, template=None,
                target_blocks: Mapping[str, Sequence[Block]] | None = None,
                engine: str | IOEngine | None = None):
        """Restore full tensors (or per-host shards when ``target_blocks``
        names a new decomposition — elastic restart) on the manager's
        device.  Returns (tree_or_flat, RestoreStats); a variable named in
        ``target_blocks`` comes back as ``{block_id: tensor}``, a scalar as
        a 0-d tensor of its stored dtype.

        Every read is appended to the root's ``access_log.json`` (the
        history ``strategy="auto"`` saves consult) as the JAX package's
        manager appends it: one record a whole variable, one a target
        block, each with its bytes and the engine that ran.  A whole
        variable's record carries its read's runs, groups and seconds; a
        target's, its own read plan's runs and groups and the gather's
        seconds shared by bytes."""
        d = self.step_dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        agg = RestoreStats()
        flat = {}
        ds = None
        if manifest["variables"]:
            ds = Dataset.open(d, engine=engine if engine is not None
                              else self.engine, telemetry=False,
                              device=self.device)
        for name in manifest["variables"]:
            if ds.index.variables[name]["dtype"] == "bfloat16":
                raise _bf16()
            shape = ds.index.var_shape(name)
            full = Block((0,) * len(shape), shape)
            if target_blocks and name in target_blocks:
                flat[name], vstats = self._read_targets(
                    ds, name, full, list(target_blocks[name]), engine)
            else:
                flat[name], vstats = ds.read(name, full, engine=engine)
            vstats.seconds += vstats.probe_seconds + vstats.plan_seconds
            if not (target_blocks and name in target_blocks):
                self._record_restore(name, full, shape, vstats)
            agg.merge(vstats)
            agg.seconds += vstats.seconds
            agg.per_var[name] = vstats
        if ds is not None:
            ds.close()
        self.access_log.flush()
        for name, rec in manifest["scalars"].items():
            if rec["dtype"] == "bfloat16":
                raise _bf16()
            flat[name] = to_tensor(np.asarray(rec["value"],
                                              dtype=rec["dtype"]),
                                   self.device)
        if template is not None:
            return unflatten_like(template, flat), agg
        return flat, agg

    def _read_targets(self, ds: Dataset, name: str, full: Block,
                      regions: list, engine) -> tuple:
        """``{block_id: tensor}`` for the target blocks of one variable,
        from one shared probe of its index: raw chunks through the region
        route, compressed ones through the host plan, one copy a target.
        Each target's read is recorded in the access log."""
        tp = time.perf_counter()
        cand = ds.index.spatial_index(name).query(full.lo, full.hi)
        probe = time.perf_counter() - tp
        plans = [ds.plan_read(name, b, candidates=cand) for b in regions]
        got = None
        if read_route(ds.index, name, full) is not None:
            got = read_regions(ds, name, regions, self.device,
                               engine=engine, plans=plans)
        if got is None:
            tensors, st = [], ReadStats()
            for b, plan in zip(regions, plans):
                arr, s = ds.read_planned(plan, engine=engine)
                self._record_restore(name, b, full.shape, dataclasses.replace(
                    s, seconds=s.seconds + s.probe_seconds + s.plan_seconds))
                st.merge(s)
                st.seconds += s.seconds
                t1 = time.perf_counter()
                tensors.append(torch.from_numpy(arr).to(self.device))
                st.h2d_seconds += time.perf_counter() - t1
        else:
            tensors, st = got
            seconds = st.seconds + st.probe_seconds + probe + st.plan_seconds
            total = max(1, sum(int(p.bytes_needed) for p in plans))
            for b, plan in zip(regions, plans):
                share = plan.bytes_needed / total
                self._record_restore(name, b, full.shape, ReadStats(
                    seconds=seconds * share, bytes_read=plan.bytes_needed,
                    runs=plan.runs, groups=plan.num_groups,
                    engine=st.engine,
                    predicted_seconds=st.predicted_seconds * share))
        st.probe_seconds += probe
        return {b.block_id: t for b, t in zip(regions, tensors)}, st

    def _record_restore(self, name: str, region: Block, shape,
                        st: ReadStats) -> None:
        """Feed one restore read back into the root's access log.
        Telemetry never breaks a restore."""
        try:
            self.access_log.append(
                AccessRecord.from_stats(name, "restore", region, shape, st,
                                        ts=self._clock()))
        except Exception:               # noqa: BLE001 — telemetry only
            pass

    def restore_latest(self, template=None):
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        tree, _ = self.restore(steps[-1], template=template)
        return steps[-1], tree
