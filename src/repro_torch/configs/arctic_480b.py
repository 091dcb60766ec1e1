"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 in parallel with a dense residual FFN
[hf:Snowflake/snowflake-arctic-base]."""

from ..models.moe import MoEDims
from ..models.transformer import ModelConfig
from .common import LM_SHAPES, SKIP_FULL_ATTN

ARCH_ID = "arctic-480b"
SHAPES = LM_SHAPES
SKIPS = dict(SKIP_FULL_ATTN)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
        d_ff=4864, vocab=32000,
        program=(("moe", 35),),
        moe=MoEDims(d_model=7168, d_ff=4864, n_experts=128, top_k=2),
        dense_residual=True, tie_embed=False, fsdp=True,
        grad_accum=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=64, vocab=64,
        program=(("moe", 2),),
        moe=MoEDims(d_model=64, d_ff=64, n_experts=8, top_k=2),
        dense_residual=True, tie_embed=False, remat="none", grad_accum=1,
    )
