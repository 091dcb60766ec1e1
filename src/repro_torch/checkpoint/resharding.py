"""Elastic-restart resharding: read a checkpoint written on mesh A back onto
mesh B.

The restore decomposition is just a set of region queries against the stored
chunk index — the ML face of the paper's read patterns (whole-domain with a
new decomposition).  The structural cost report (chunks touched, contiguous
runs) quantifies why merged/reorganized layouts restore faster than raw
per-device logs.  A copy of the JAX package's module over the port's
planner: the same checkpoint gives the same report.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.blocks import Block
from ..io.planner import build_read_plan
from ..io.reader import Dataset

__all__ = ["ReshardPlan", "plan_reshard", "reshard_cost_report"]


@dataclasses.dataclass
class ReshardPlan:
    var: str
    targets: list                 # target Blocks (new shards)
    chunks_touched: int
    runs: int                     # contiguous byte runs (cold-cache seeks)
    bytes: int
    amplification: float          # bytes read if whole chunks pulled / needed


def plan_reshard(ds: Dataset, var: str,
                 target_blocks: Sequence[Block]) -> ReshardPlan:
    """Each target shard is one indexed read plan — the spatial index visits
    only intersecting chunks, and ``runs`` comes from the coalesced plans
    rather than a per-pair analytic formula."""
    touched = set()
    runs = 0
    needed = 0
    whole = 0
    for t in target_blocks:
        plan = build_read_plan(ds.index, var, t)
        touched.update(zip(plan.subfiles.tolist(),
                           plan.extent_offsets.tolist()))
        runs += plan.runs
        needed += plan.bytes_needed
        whole += int(plan.extent_nbytes.sum())
    return ReshardPlan(var=var, targets=list(target_blocks),
                       chunks_touched=len(touched), runs=runs, bytes=needed,
                       amplification=whole / max(needed, 1))


def reshard_cost_report(ckpt_dir: str, var: str,
                        target_blocks: Sequence[Block]) -> dict:
    # the report plans from the index alone: no data reaches a device
    ds = Dataset.open(ckpt_dir, device="cpu")
    try:
        plan = plan_reshard(ds, var, target_blocks)
    finally:
        ds.close()
    return {"var": var, "num_targets": len(plan.targets),
            "chunks_touched": plan.chunks_touched, "runs": plan.runs,
            "bytes": plan.bytes, "amplification": plan.amplification}
