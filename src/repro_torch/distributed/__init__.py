"""Distributed-runtime helpers: fault tolerance and the crash-safe
distributed reorganization fleet.

Package attributes load lazily (PEP 562), as in the JAX package: a reorg
worker process imports the fault-tolerance primitives and its worker loop
without loading anything else.  The JAX package's sharding names
(``distributed/sharding.py``) wait for the distributed slice; asking for
one raises an ``AttributeError`` that says so.
"""

_SHARDING_NAMES = ("DEFAULT_RULES", "FSDP_RULES", "ShardingCtx",
                   "ShardingRules", "current_ctx", "logical_spec",
                   "named_sharding", "shard", "use_sharding")
_FAULT_NAMES = ("HeartbeatMonitor", "ElasticPlan", "plan_rescale",
                "StragglerTracker")
_REORG_NAMES = ("ReorgWorkerStats", "distributed_reorganize", "worker_main",
                "with_retry")

__all__ = list(_FAULT_NAMES + _REORG_NAMES)


def __getattr__(name):
    if name in _SHARDING_NAMES:
        raise AttributeError(
            f"{__name__}.{name} is not ported yet: the sharding rules wait "
            f"for the distributed slice (ROADMAP.md queue 1, item 13)")
    if name in _FAULT_NAMES:
        from . import fault_tolerance as mod
    elif name in _REORG_NAMES:
        from . import reorg as mod
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(mod, name)
