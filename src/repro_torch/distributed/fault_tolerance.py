"""Fault tolerance: failure detection, elastic rescale planning, straggler
mitigation.

On a real pod this runs on the controller: hosts heartbeat; a missed-beat
host is declared dead; the planner picks the largest viable mesh from the
survivors and produces the restore decomposition (per-array target Blocks for
the new mesh), which the layout-aware checkpoint restores efficiently — this
is exactly where the paper's read-optimized layouts pay off.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np

from ..core.blocks import Block

__all__ = ["HeartbeatMonitor", "ElasticPlan", "plan_rescale",
           "StragglerTracker"]


class HeartbeatMonitor:
    """Deadline-based failure detector (controller side)."""

    def __init__(self, hosts: Sequence[int], timeout_s: float = 60.0,
                 clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last_beat = {h: clock() for h in hosts}

    def beat(self, host: int) -> None:
        self.last_beat[host] = self.clock()

    def dead_hosts(self) -> list:
        now = self.clock()
        return [h for h, t in self.last_beat.items()
                if now - t > self.timeout]

    def alive_hosts(self) -> list:
        dead = set(self.dead_hosts())
        return [h for h in self.last_beat if h not in dead]


@dataclasses.dataclass
class ElasticPlan:
    old_mesh: tuple               # (data, model) extents
    new_mesh: tuple
    surviving_hosts: list
    #: global-batch re-decomposition factor (old_dp / new_dp)
    batch_refactor: float

    def describe(self) -> str:
        return (f"rescale {self.old_mesh} -> {self.new_mesh} "
                f"({len(self.surviving_hosts)} hosts)")


def plan_rescale(old_mesh: tuple, num_alive_devices: int,
                 surviving_hosts: Sequence[int],
                 model_axis_fixed: bool = True) -> ElasticPlan:
    """Largest viable mesh from survivors.  The model axis is kept (changing
    it re-shards every weight); the data axis shrinks to the largest power-of
    -two-ish divisor that fits."""
    old_dp, old_mp = old_mesh
    if model_axis_fixed:
        new_mp = old_mp
        new_dp = num_alive_devices // new_mp
        if new_dp < 1:
            raise ValueError("not enough devices for the model axis")
    else:
        new_mp = min(old_mp, num_alive_devices)
        new_dp = num_alive_devices // new_mp
    return ElasticPlan(old_mesh=(old_dp, old_mp), new_mesh=(new_dp, new_mp),
                       surviving_hosts=list(surviving_hosts),
                       batch_refactor=old_dp / new_dp)


class StragglerTracker:
    """Per-host step-time EMA outlier detection + reassignment proposals."""

    def __init__(self, hosts: Sequence[int], alpha: float = 0.2,
                 factor: float = 1.5):
        self.alpha = alpha
        self.factor = factor
        self.ema: dict = {h: None for h in hosts}

    def record(self, host: int, step_seconds: float) -> None:
        cur = self.ema.get(host)
        self.ema[host] = (step_seconds if cur is None
                          else self.alpha * step_seconds
                          + (1 - self.alpha) * cur)

    def stragglers(self) -> list:
        vals = [v for v in self.ema.values() if v is not None]
        if len(vals) < 2:
            return []
        med = float(np.median(vals))
        return [h for h, v in self.ema.items()
                if v is not None and v > self.factor * med]

    def reassignment(self, shards_per_host: Mapping[int, int]) -> dict:
        """Propose moving one data shard from each straggler to the fastest
        host (the data-pipeline analogue of AMReX block load balancing —
        which is what creates the paper's irregular layouts in the first
        place)."""
        slow = self.stragglers()
        if not slow:
            return {}
        fast = min((h for h, v in self.ema.items() if v is not None),
                   key=lambda h: self.ema[h])
        return {h: {"move_shards": 1, "to": fast}
                for h in slow if shards_per_host.get(h, 0) > 0}
