from .common import LM_SHAPES, ShapeCell
from .registry import (ARCHS, get_config, get_smoke_config, list_archs,
                       shapes_for, skip_reason)

__all__ = ["ARCHS", "LM_SHAPES", "ShapeCell", "get_config",
           "get_smoke_config", "list_archs", "shapes_for", "skip_reason"]
