"""Architecture registry: ``--arch <id>`` lookup for configs, smoke configs,
shape cells and per-cell skip reasons."""

from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "get_smoke_config", "shapes_for",
           "skip_reason", "list_archs"]

#: arch id -> config module (one file per assigned architecture)
ARCHS = {
    "hymba-1.5b": "hymba_1_5b",
    "hubert-xlarge": "hubert_xlarge",
    "gemma2-2b": "gemma2_2b",
    "qwen2.5-3b": "qwen2_5_3b",
    "yi-9b": "yi_9b",
    "stablelm-3b": "stablelm_3b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "arctic-480b": "arctic_480b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-780m": "mamba2_780m",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"{__package__}.{ARCHS[arch]}")


def list_archs() -> list:
    return list(ARCHS)


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def shapes_for(arch: str):
    return _module(arch).SHAPES


def skip_reason(arch: str, shape: str) -> str | None:
    return _module(arch).SKIPS.get(shape)
