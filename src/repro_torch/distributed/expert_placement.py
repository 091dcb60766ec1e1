"""Load-statistics-driven expert re-placement.

MoE routing load drifts during training; re-placing experts across the EP
axis re-balances step time — and physically migrates expert weights between
hosts, which is exactly the AMReX load-balancing motif that produces the
paper's irregular per-host block sets.  The planner returns both the new
placement (a permutation of the experts axis) and the checkpoint-relayout
view of it: which expert-weight blocks move between which hosts, so the
layout-aware checkpoint can write the migrated state merged (Alg. 1) instead
of fragmenting it.  A copy of the JAX package's planner; only
:func:`apply_permutation` touches tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.blocks import Block

__all__ = ["PlacementPlan", "plan_expert_placement", "migration_blocks",
           "apply_permutation"]


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    permutation: tuple          # new expert order: position i holds expert permutation[i]
    shard_of_expert: tuple      # expert id -> EP shard after re-placement
    predicted_max_load: float   # max per-shard load after
    baseline_max_load: float    # max per-shard load before (contiguous slices)
    moves: tuple                # (expert, old_shard, new_shard) for movers

    @property
    def improvement(self) -> float:
        return self.baseline_max_load / max(self.predicted_max_load, 1e-12)


def plan_expert_placement(loads: Sequence[float], n_shards: int
                          ) -> PlacementPlan:
    """Greedy LPT bin-packing of experts onto EP shards.

    ``loads``: tokens routed to each expert (from router statistics).
    Shards keep E/n equal slot counts (the weights array stays regular);
    within that constraint the heaviest experts are spread first.
    """
    E = len(loads)
    if E % n_shards:
        raise ValueError(f"{E} experts not divisible by {n_shards} shards")
    cap = E // n_shards
    order = np.argsort(loads)[::-1]
    shard_load = np.zeros(n_shards)
    shard_slots = [[] for _ in range(n_shards)]
    for e in order:
        # least-loaded shard with a free slot
        cands = [s for s in range(n_shards) if len(shard_slots[s]) < cap]
        s = min(cands, key=lambda i: shard_load[i])
        shard_slots[s].append(int(e))
        shard_load[s] += loads[e]

    perm, shard_of = [], [0] * E
    for s, slots in enumerate(shard_slots):
        for e in sorted(slots):
            shard_of[e] = s
            perm.append(e)
    base = np.add.reduceat(np.asarray(loads, float),
                           np.arange(0, E, cap)).max()
    moves = tuple((e, e // cap, shard_of[e]) for e in range(E)
                  if e // cap != shard_of[e])
    return PlacementPlan(permutation=tuple(perm),
                         shard_of_expert=tuple(shard_of),
                         predicted_max_load=float(shard_load.max()),
                         baseline_max_load=float(base), moves=moves)


def migration_blocks(plan: PlacementPlan, weight_shape: Sequence[int]
                     ) -> list:
    """Blocks of an (E, ...) expert-weight array re-owned by destination
    shard — feed these to the layout-aware checkpoint (merged write) or the
    staging executor (online migration)."""
    E = len(plan.shard_of_expert)
    tail = tuple(weight_shape[1:])
    out = []
    for e in range(E):
        lo = (e,) + (0,) * len(tail)
        hi = (e + 1,) + tail
        out.append(Block(lo, hi, owner=plan.shard_of_expert[e], block_id=e))
    return out


def apply_permutation(weights: torch.Tensor, plan: PlacementPlan,
                      axis: int = 0) -> torch.Tensor:
    """Reorder an expert-stacked tensor into the new placement (position i
    holds old expert plan.permutation[i]), on the tensor's device."""
    idx = torch.as_tensor(plan.permutation, dtype=torch.long,
                          device=weights.device)
    return torch.index_select(weights, axis, idx)
