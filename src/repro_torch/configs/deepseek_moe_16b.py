"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400; fine-grained MoE: 2 shared + 64 routed experts, top-6
[arXiv:2401.06066]."""

from ..models.moe import MoEDims
from ..models.transformer import ModelConfig
from .common import LM_SHAPES, SKIP_FULL_ATTN

ARCH_ID = "deepseek-moe-16b"
SHAPES = LM_SHAPES
SKIPS = dict(SKIP_FULL_ATTN)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
        d_ff=1408, vocab=102400,
        program=(("moe", 28),),
        moe=MoEDims(d_model=2048, d_ff=1408, n_experts=64, top_k=6,
                    n_shared=2),
        tie_embed=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=32, vocab=64,
        program=(("moe", 2),),
        moe=MoEDims(d_model=64, d_ff=32, n_experts=8, top_k=3, n_shared=2),
        tie_embed=False, remat="none", grad_accum=1,
    )
