"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000;
llama-arch GQA [arXiv:2403.04652]."""

from ..models.transformer import ModelConfig
from .common import LM_SHAPES, SKIP_FULL_ATTN

ARCH_ID = "yi-9b"
SHAPES = LM_SHAPES
SKIPS = dict(SKIP_FULL_ATTN)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv=4, head_dim=128,
        d_ff=11008, vocab=64000,
        program=(("attn", 48),),
        rope_theta=5_000_000.0, tie_embed=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=64,
        program=(("attn", 3),),
        tie_embed=False, remat="none", grad_accum=1,
    )
