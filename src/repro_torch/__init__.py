"""PyTorch + CUDA port of the layout-reorganization data path and the
model stack: serving, training, checkpoints, the layout policy and
staging, and the end-to-end examples.

A package of its own beside the JAX package ``repro``: it imports
``torch``, ``numpy`` and the standard library, never ``jax`` or ``repro``,
and keeps its own copy of the numpy/stdlib modules it needs.  Module paths
mirror ``repro``'s (``repro_torch.core.blocks`` <-> ``repro.core.blocks``).

Submodules load on first attribute access, so ``import repro_torch`` is
cheap; the CUDA kernels build from ``kernels/csrc`` at their first launch.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import importlib

__all__ = ["checkpoint", "configs", "core", "data", "device", "examples",
           "interop", "io", "kernels", "launch", "models", "serve", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
