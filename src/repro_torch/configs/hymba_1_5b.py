"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention+mamba heads per layer, sliding
window everywhere except 3 full-attention layers (first/middle/last)
[arXiv:2411.13676].  Meta-tokens are omitted (not part of the assigned
config)."""

from ..models.ssm import SSMDims
from ..models.transformer import ModelConfig
from .common import LM_SHAPES

ARCH_ID = "hymba-1.5b"
SHAPES = LM_SHAPES
SKIPS = {}        # hybrid SSM+SWA: long_500k runs (3 global layers seq-shard)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv=5, head_dim=64,
        d_ff=5504, vocab=32001,
        program=(("hyb_full", 1), ("hyb_swa", 14), ("hyb_full", 1),
                 ("hyb_swa", 15), ("hyb_full", 1)),
        window=1024,
        ssm=SSMDims(d_model=1600, d_inner=1600, headdim=64, d_state=16),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=64,
        program=(("hyb_full", 1), ("hyb_swa", 2), ("hyb_full", 1)),
        window=8,
        ssm=SSMDims(d_model=64, d_inner=64, headdim=16, d_state=8),
        ssd_chunk=16, remat="none", grad_accum=1,
    )
