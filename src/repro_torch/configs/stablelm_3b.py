"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304; LayerNorm + partial rotary (25%) [hf:stabilityai/stablelm-2]."""

from ..models.transformer import ModelConfig
from .common import LM_SHAPES, SKIP_FULL_ATTN

ARCH_ID = "stablelm-3b"
SHAPES = LM_SHAPES
SKIPS = dict(SKIP_FULL_ATTN)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv=32, head_dim=80,
        d_ff=6912, vocab=50304,
        program=(("attn", 32),),
        norm="ln", rotary_pct=0.25, tie_embed=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=96, vocab=64,
        program=(("attn", 3),),
        norm="ln", rotary_pct=0.25, tie_embed=False, remat="none", grad_accum=1,
    )
