"""The model stack: layer primitives, attention, the layer program and
``LM`` (dense decoders, MoE, Mamba-2 SSD and the attention+SSM hybrid
so far)."""

from .model import LM
from .transformer import ModelConfig

__all__ = ["LM", "ModelConfig"]
