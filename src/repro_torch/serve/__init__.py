"""Serving: batched generation with a persistent KV cache, and the cache's
accounting.  (The reference's multi-tenant read service is not ported
yet.)"""

from .engine import GenStats, ServeEngine, make_decode_step, make_prefill_step
from .kv_cache import cache_bytes, cache_spec_summary, flatten_cache

__all__ = ["GenStats", "ServeEngine", "make_decode_step", "make_prefill_step",
           "cache_bytes", "cache_spec_summary", "flatten_cache"]
