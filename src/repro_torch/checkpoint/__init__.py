"""Checkpoints: the layout-aware manager with the tensors on the card, the
block sets of shardings, and the resharding cost report.  The JAX
package's ``AsyncCheckpointer`` waits for staging (S5 in ``ROADMAP.md``
queue 1)."""

from .blocks_map import (MeshDevice, MeshSharding, blocks_from_sharding,
                         flatten_pytree, unflatten_like)
from .manager import (ACCESS_PRIOR_NAME, CheckpointManager, RestoreStats,
                      SaveStats)
from .resharding import ReshardPlan, plan_reshard, reshard_cost_report

__all__ = ["ACCESS_PRIOR_NAME", "CheckpointManager", "MeshDevice",
           "MeshSharding", "RestoreStats", "SaveStats", "ReshardPlan",
           "blocks_from_sharding", "flatten_pytree", "plan_reshard",
           "reshard_cost_report", "unflatten_like"]
