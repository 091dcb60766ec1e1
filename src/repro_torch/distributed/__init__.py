"""Distributed-runtime helpers: sharding rules, collectives, expert
placement, fault tolerance, and the crash-safe distributed reorganization
fleet.

Package attributes load lazily (PEP 562), as in the JAX package: a reorg
worker process imports the fault-tolerance primitives and its worker loop
without loading anything else.  Direct submodule imports (``from
repro_torch.distributed import sharding``) are unaffected.
"""

_SHARDING_NAMES = ("DEFAULT_RULES", "FSDP_RULES", "ShardingCtx",
                   "ShardingRules", "current_ctx", "logical_spec",
                   "named_sharding", "shard", "use_sharding")
_FAULT_NAMES = ("HeartbeatMonitor", "ElasticPlan", "plan_rescale",
                "StragglerTracker")
_REORG_NAMES = ("ReorgWorkerStats", "distributed_reorganize", "worker_main",
                "with_retry")

__all__ = list(_SHARDING_NAMES + _FAULT_NAMES + _REORG_NAMES)


def __getattr__(name):
    if name in _SHARDING_NAMES:
        from . import sharding as mod
    elif name in _FAULT_NAMES:
        from . import fault_tolerance as mod
    elif name in _REORG_NAMES:
        from . import reorg as mod
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(mod, name)
