"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936; GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""

from ..models.transformer import ModelConfig
from .common import LM_SHAPES, SKIP_FULL_ATTN

ARCH_ID = "qwen2.5-3b"
SHAPES = LM_SHAPES
SKIPS = dict(SKIP_FULL_ATTN)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv=2, head_dim=128,
        d_ff=11008, vocab=151936,
        program=(("attn", 36),),
        qkv_bias=True, rope_theta=1_000_000.0, tie_embed=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=128,
        program=(("attn", 4),),
        qkv_bias=True, remat="none", grad_accum=1,
    )
