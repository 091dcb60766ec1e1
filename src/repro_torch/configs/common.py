"""Shared shape-cell definitions for the assigned architectures.

Every LM-family arch gets the same four cells; per-arch skips are declared in
each config module (encoder-only: no decode; pure full-attention: no 500k).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeCell", "LM_SHAPES", "SKIP_FULL_ATTN", "SKIP_ENCODER"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)

#: skip reasons (recorded per cell in EXPERIMENTS.md)
SKIP_FULL_ATTN = {"long_500k":
                  "pure full-attention arch: 500k dense KV is the "
                  "quadratic-context regime this shape excludes"}
SKIP_ENCODER = {"decode_32k": "encoder-only arch: no decode step exists",
                "long_500k": "encoder-only arch: no decode step exists"}
