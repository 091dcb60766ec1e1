"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128; SSD (state-space duality), expand=2 -> d_inner=3072,
headdim=64 -> 48 SSM heads [arXiv:2405.21060]."""

from ..models.ssm import SSMDims
from ..models.transformer import ModelConfig
from .common import LM_SHAPES

ARCH_ID = "mamba2-780m"
SHAPES = LM_SHAPES
SKIPS = {}        # SSM: all shapes run, constant-size decode state


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=48, d_model=1536, n_heads=1, n_kv=1, head_dim=1,  # unused
        d_ff=0, vocab=50280,
        program=(("ssd", 48),),
        ssm=SSMDims(d_model=1536, d_inner=3072, headdim=64, d_state=128),
        tie_embed=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=1, n_kv=1, head_dim=1,
        d_ff=0, vocab=64,
        program=(("ssd", 4),),
        ssm=SSMDims(d_model=64, d_inner=128, headdim=16, d_state=8),
        ssd_chunk=16, remat="none", grad_accum=1,
    )
