"""Core: index-space blocks, Berger–Rigoutsos clustering, merge plans and
the seven layout strategies — copies of the JAX package's numpy modules."""

from .blocks import (Block, blocks_disjoint, bounding_box,
                     regular_decomposition, simulate_load_balance,
                     total_volume, uniform_grid_blocks)
from .clustering import Cluster, cluster_blocks, cluster_blocks_many
from .layouts import (STRATEGIES, ChunkPlan, LayoutPlan,
                      default_reorg_scheme, plan_layout)
from .merge import (CopyOp, MergePlan, build_merge_plan, execute_merge_numpy,
                    plan_from_clusters)

__all__ = [n for n in dir() if not n.startswith("_")]
