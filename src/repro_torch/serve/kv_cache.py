"""KV-cache accounting and naming.

The cache is built by the model (full / ring-window KV, or the SSM's f32
state and bf16 conv window, per layer kind); this module adds byte
accounting per (arch, shape) and the name -> tensor map used to checkpoint
a live cache, under the reference's names.
"""

from __future__ import annotations

import math

from ..models.model import LM
from ..models.params import torch_dtype, tree_leaves

__all__ = ["cache_bytes", "cache_spec_summary", "flatten_cache"]


def _nbytes(defs) -> int:
    return sum(math.prod(d.shape) * torch_dtype(d.dtype).itemsize
               for d in tree_leaves(defs))


def cache_bytes(model: LM, batch: int, cache_len: int) -> int:
    return _nbytes(model.cache_skeleton(batch, cache_len))


def cache_spec_summary(model: LM, batch: int, cache_len: int) -> dict:
    """Per-kind byte breakdown (full attn vs window vs SSM state)."""
    out: dict = {}
    for (kind, _), seg in zip(model.cfg.program,
                              model.cache_skeleton(batch, cache_len)):
        if seg is None:
            continue
        out[kind] = out.get(kind, 0) + _nbytes(seg)
    return out


def flatten_cache(cache) -> dict:
    """Name -> tensor map for checkpointing a live cache: ``cache/<segment>
    /<key>/...``, dict keys in sorted order, as the reference names them."""
    flat = {}

    def walk(node, name):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{name}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, t in enumerate(node):
                walk(t, f"{name}/{i}")
        else:
            flat[name] = node

    walk(cache, "cache")
    return flat
