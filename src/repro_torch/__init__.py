"""PyTorch + CUDA port of the layout-reorganization data path and the
model stack: serving, training, checkpoints, the layout policy and
staging, the crash-safe distributed reorganization, and the end-to-end
examples.

A package of its own beside the JAX package ``repro``: it imports
``torch``, ``numpy`` and the standard library, never ``jax`` or ``repro``,
and keeps its own copy of the numpy/stdlib modules it needs.  Module paths
mirror ``repro``'s (``repro_torch.core.blocks`` <-> ``repro.core.blocks``).

Submodules load on first attribute access, so ``import repro_torch`` is
cheap; the CUDA kernels build from ``kernels/csrc`` at their first launch.
Entry points run on the card unless the caller passes ``device="cpu"``.

Tracing: ``spans.py`` marks the hot path's layers (the MoE block and its
parts, the SSD chunk scan, AdamW, remat's recompute, the serving
engine's prefill and decode steps) as ``repro_torch.*`` spans.  Run any
call inside ``torch.profiler.profile(activities=[CPU, CUDA])`` and they
appear beside the kernels they launch, backward passes included; with no
profiler recording they cost one boolean check.
"""

from __future__ import annotations

import importlib

__all__ = ["checkpoint", "configs", "core", "data", "device", "distributed",
           "examples", "interop", "io", "kernels", "launch", "models", "serve",
           "spans", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
