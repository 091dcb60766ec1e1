"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; decoder backbone with gated cross-attention to vision tokens
every 5th layer (20 cross layers).  The vision tower is a STUB:
``input_specs()`` provides precomputed, projected patch embeddings
[hf:meta-llama/Llama-3.2-*-Vision]."""

from ..models.transformer import ModelConfig
from .common import LM_SHAPES, SKIP_FULL_ATTN

ARCH_ID = "llama-3.2-vision-90b"
SHAPES = LM_SHAPES
SKIPS = dict(SKIP_FULL_ATTN)

N_VISION_TOKENS = 6404          # 4 tiles x 1601 patches


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=28672, vocab=128256,
        program=(("group_sx", 20),),     # 20 x (4 self + 1 cross) = 100
        rope_theta=500_000.0, tie_embed=False, fsdp=True,
        n_memory_tokens=N_VISION_TOKENS, grad_accum=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        n_layers=5, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=64,
        program=(("group_sx", 1),),
        tie_embed=False, n_memory_tokens=8, remat="none", grad_accum=1,
    )
