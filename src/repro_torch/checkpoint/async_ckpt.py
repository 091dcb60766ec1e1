"""On-the-fly checkpoint layout reorganization (paper §5, ML-translated),
with the tensors on the card.

While training continues, each leaf is handed to a staging executor that
snapshots it on the card, assembles a read-optimized (regular K-way) layout
there and writes it — the paper's staging-node pattern with training steps
as ``t_c``.  The snapshot is what makes this safe under an optimizer that
updates the parameters in place: the staged bytes are the leaf as it was at
``save``.  The §5.2 cost model, fed with *measured* per-checkpoint timings,
decides whether this on-the-fly path or a post-hoc rewrite minimizes
chip-seconds for the run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core import cost_model
from ..core.blocks import Block
from ..core.layouts import plan_layout
from ..core.reorg import ReorgDecision, decide
from ..io.staging import StagingExecutor
from .blocks_map import blocks_from_sharding, flatten_pytree
from .manager import _np_dtype

__all__ = ["AsyncCheckpointer"]


@dataclasses.dataclass
class _StepRecord:
    step: int
    stall: float
    submit_time: float


class AsyncCheckpointer:
    """Staged, reorganizing checkpointer.

    ``save(step, tree, block_map)`` returns once every leaf is snapshotted
    and queued (bounded by staging backpressure); it can stand as the
    ``Trainer``'s ``ckpt_manager``.  ``timings()`` reports measured t_s /
    t_w / stall per output; ``recommendation(t_c, N)`` runs the paper's
    model on them.  Each leaf ``name`` of step ``s`` is the variable
    ``name@s`` of the dataset at ``root``.  ``device`` is the executor's
    session (``"cuda"`` unless ``"cpu"`` is asked for); leaves stay where
    they are.
    """

    def __init__(self, root: str, reorg_scheme=(4, 4),
                 num_workers: int = 2, queue_depth: int = 2,
                 n_compute: int = 256, m_staging: int = 2,
                 t_w_direct: float | None = None,
                 align: int | None = None, engine: str = "pread",
                 policy=None, prior: str | None = None, device="cuda"):
        self.root = root
        #: "auto" routes every variable's staged layout through the
        #: executor's LayoutPolicy; a tuple pins the K-way scheme.
        #: ``prior`` seeds the auto decisions from a previous run's access
        #: history (path to its access_log.json / exported prior / dir)
        self.scheme = reorg_scheme if reorg_scheme == "auto" \
            else tuple(reorg_scheme)
        self.executor = StagingExecutor(root, num_workers=num_workers,
                                        queue_depth=queue_depth,
                                        align=align, engine=engine,
                                        policy=policy, prior=prior,
                                        device=device)
        self.records: list = []
        self.n_compute = n_compute
        self.m_staging = m_staging
        self.t_w_direct = t_w_direct     # measured direct-write time/output

    def save(self, step: int, tree,
             block_map: Mapping[str, Sequence[Block]] | None = None,
             shardings=None, devices_per_host: int = 4) -> float:
        """Stage every leaf of ``tree`` (tensors, on the card or the CPU,
        or ndarrays) with more than 0 dimensions; returns the seconds the
        producer was blocked.  A leaf's blocks come from ``block_map``,
        ``shardings`` (``blocks_from_sharding``) or are one whole block."""
        flat = flatten_pytree(tree)
        stall_total = 0.0
        now = time.perf_counter()
        flat_sh = flatten_pytree(shardings) if shardings is not None else {}
        for name, arr in flat.items():
            if isinstance(arr, torch.Tensor):
                dtype = _np_dtype(arr.dtype)
            else:
                arr = np.asarray(arr)
                dtype = arr.dtype
            if arr.ndim == 0:
                continue
            shape = tuple(arr.shape)
            if block_map and name in block_map:
                blocks = list(block_map[name])
            elif name in flat_sh and flat_sh[name] is not None:
                blocks = blocks_from_sharding(shape, flat_sh[name],
                                              devices_per_host)
            else:
                blocks = [Block((0,) * arr.ndim, shape, owner=0,
                                block_id=0)]
            data = {b.block_id: arr[b.slices()] for b in blocks}
            if self.scheme == "auto":
                stall_total += self.executor.submit(
                    step, name, dtype, "auto", data, blocks=blocks,
                    global_shape=shape)
                continue
            scheme = self.scheme[:arr.ndim] + (1,) * (arr.ndim
                                                      - len(self.scheme))
            plan = plan_layout("reorganized", blocks, num_procs=0,
                               global_shape=shape, reorg_scheme=scheme,
                               num_stagers=self.executor.num_workers)
            stall_total += self.executor.submit(step, name, dtype, plan,
                                                data)
        self.records.append(_StepRecord(step=step, stall=stall_total,
                                        submit_time=now))
        return stall_total

    def finish(self) -> list:
        results = self.executor.drain()
        self.executor.close()
        return results

    # -- the §5.2 policy -------------------------------------------------------
    def timings(self, results=None) -> cost_model.StagingTimings:
        results = results or self.executor.drain()
        t_s = float(np.mean([r.t_s for r in results]))
        t_w = float(np.mean([r.t_w for r in results]))
        return cost_model.StagingTimings(
            t_s=t_s, t_w_stage=t_w,
            t_w_sim=self.t_w_direct if self.t_w_direct is not None else 0.0,
            t_r_stage=t_w * 0.8,          # read-back estimate if unmeasured
            n=self.n_compute, m=self.m_staging)

    def recommendation(self, t_c: float, N: int,
                       timings: cost_model.StagingTimings | None = None
                       ) -> ReorgDecision:
        return decide(timings or self.timings(), t_c, N)
