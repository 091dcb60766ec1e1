"""Serving: batched generation with a persistent KV cache and the cache's
accounting, and the multi-tenant read service, whose coalesced batches
are gathered on the card (:mod:`.read_service`, :mod:`.coalesce`)."""

from .coalesce import (Request, SuperPlan, build_super_plan, union_spans,
                       union_spans_naive)
from .engine import GenStats, ServeEngine, make_decode_step, make_prefill_step
from .kv_cache import cache_bytes, cache_spec_summary, flatten_cache
from .read_service import ReadService, ServiceStats, TenantStats

__all__ = ["GenStats", "ServeEngine", "make_decode_step", "make_prefill_step",
           "cache_bytes", "cache_spec_summary", "flatten_cache",
           "ReadService", "ServiceStats", "TenantStats", "Request",
           "SuperPlan", "build_super_plan", "union_spans",
           "union_spans_naive"]
