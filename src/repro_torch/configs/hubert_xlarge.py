"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504;
encoder-only transformer backbone (w2v2 arch); the conv feature-extractor
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
[arXiv:2106.07447]."""

from ..models.transformer import ModelConfig
from .common import LM_SHAPES, SKIP_ENCODER

ARCH_ID = "hubert-xlarge"
SHAPES = LM_SHAPES
SKIPS = dict(SKIP_ENCODER)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv=16, head_dim=80,
        d_ff=5120, vocab=504,
        program=(("enc", 48),),
        causal=False, use_rope=False, norm="ln", act="gelu",
        gated_mlp=False, tie_embed=False, frontend="frames",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=96, vocab=32,
        program=(("enc", 3),),
        causal=False, use_rope=False, norm="ln", act="gelu",
        gated_mlp=False, tie_embed=False, frontend="frames", remat="none", grad_accum=1,
    )
