"""Core: index-space blocks, Berger–Rigoutsos clustering, merge plans, the
seven layout strategies, the six Fig.-6 read patterns, the cost model
behind ``engine="auto"``, the access telemetry and layout policy, and the
reorganization decision — copies of the JAX package's numpy modules."""

from .blocks import (Block, blocks_disjoint, bounding_box,
                     regular_decomposition, simulate_load_balance,
                     total_volume, uniform_grid_blocks)
from .clustering import Cluster, cluster_blocks, cluster_blocks_many
from .layouts import (STRATEGIES, ChunkPlan, LayoutPlan,
                      default_reorg_scheme, plan_layout)
from .cost_model import (PAPER_TIMINGS, CalibrationDrift, EngineCalibration,
                         EngineChoice, StagingTimings, breakeven_outputs,
                         choose_engine, invalidate_calibration,
                         load_calibration, onthefly_utilization,
                         posthoc_utilization, predict_best_seconds,
                         predict_seconds, probe_storage, recommend,
                         save_calibration, storage_calibration)
from .policy import (AccessLog, AccessRecord, LayoutPolicy, PolicyDecision,
                     candidate_schemes, classify_region, estimate_read_shape,
                     estimate_write_shape, load_prior_records)
from .merge import (CopyOp, MergePlan, MergeStats, build_merge_plan,
                    execute_merge_numpy, merge_blocks, plan_from_clusters)
from .read_patterns import (PATTERNS, best_decompositions, decompose_region,
                            pattern_region)
from .reorg import ReorgDecision, decide, plan_reorganization

__all__ = [n for n in dir() if not n.startswith("_")]
