"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000;
alternating local(4096-window)/global attention, logit softcapping, GeGLU,
post-norms, scaled embeddings [arXiv:2408.00118]."""

from ..models.transformer import ModelConfig
from .common import LM_SHAPES

ARCH_ID = "gemma2-2b"
SHAPES = LM_SHAPES
#: local/global alternation is sub-quadratic on half its layers; long_500k
#: runs with the global layers' KV sequence-sharded across the mesh.
SKIPS = {}


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv=4, head_dim=256,
        d_ff=9216, vocab=256000,
        program=(("pair_lg", 13),),          # 13 x (local, global)
        window=4096, attn_cap=50.0, final_cap=30.0,
        act="gelu", post_norm=True, embed_scale=True, tie_embed=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=128,
        program=(("pair_lg", 2),),
        window=8, attn_cap=50.0, final_cap=30.0,
        act="gelu", post_norm=True, embed_scale=True, remat="none", grad_accum=1,
    )
