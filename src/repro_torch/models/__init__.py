"""The model stack: layer primitives, attention, the layer program and
``LM`` (dense decoders so far)."""

from .model import LM
from .transformer import ModelConfig

__all__ = ["LM", "ModelConfig"]
