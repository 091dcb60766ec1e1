"""Checkpoints: the layout-aware manager with the tensors on the card, the
staged reorganizing checkpointer, the block sets of shardings, and the
resharding cost report."""

from .async_ckpt import AsyncCheckpointer
from .blocks_map import (MeshDevice, MeshSharding, blocks_from_sharding,
                         flatten_pytree, unflatten_like)
from .manager import (ACCESS_PRIOR_NAME, CheckpointManager, RestoreStats,
                      SaveStats)
from .resharding import ReshardPlan, plan_reshard, reshard_cost_report

__all__ = ["ACCESS_PRIOR_NAME", "AsyncCheckpointer", "CheckpointManager",
           "MeshDevice", "MeshSharding", "RestoreStats", "SaveStats",
           "ReshardPlan",
           "blocks_from_sharding", "flatten_pytree", "plan_reshard",
           "reshard_cost_report", "unflatten_like"]
