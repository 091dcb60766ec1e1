"""Weights made from ``--seed`` on the device: one ``torch.Generator`` and
one draw a leaf (a stacked segment's leaf is drawn whole), its seed a hash
of the run's seed and the leaf's name, so any leaf can be made again
alone, bit for bit, on the same device."""

from __future__ import annotations

import hashlib

import torch

from reference.params import Spec, flatten, specs

__all__ = ["leaf_seed", "make_leaf", "make", "unflatten"]


def leaf_seed(seed: int, name: str) -> int:
    h = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def make_leaf(sp: Spec, seed: int, name: str, device) -> torch.Tensor:
    if sp.law == "zeros":
        return torch.zeros(sp.shape, dtype=torch.float32, device=device)
    if sp.law == "ones":
        return torch.ones(sp.shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    return torch.randn(sp.shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(sp.std)


def unflatten(flat: dict):
    """``{"a/b/0/c": t}`` back into nested dicts and lists."""
    root: dict = {}
    for name, t in flat.items():
        node, parts = root, name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def make(model: dict, seed: int, device) -> dict:
    """The parameter tree of ``model`` (a configuration's model section),
    f32, on ``device``."""
    return unflatten({name: make_leaf(sp, seed, name, device)
                      for name, sp in flatten(specs(model))})
