"""Carry the JAX package's state into the port.

Blocks travel as ``(lo, hi, owner, block_id)`` tuples — how the JAX
package's ``Block`` fields and ``index.json`` store them — arrays as
numpy, and parameter trees as nested dicts and lists of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``).  bfloat16 crosses
through a 16-bit integer view, so it stays bit-exact without
``ml_dtypes``.  Datasets on disk need nothing: either
package opens a directory the other wrote.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from .core.blocks import Block
from .device import resolve_device

__all__ = ["blocks_from_records", "tensors_from_numpy", "to_tensor",
           "to_numpy", "params_from_numpy", "params_to_numpy",
           "opt_state_from_numpy", "opt_state_to_numpy"]


def blocks_from_records(records: Iterable) -> list:
    """Port :class:`~repro_torch.core.blocks.Block`s from
    ``(lo, hi, owner, block_id)`` tuples."""
    return [Block(tuple(int(v) for v in lo), tuple(int(v) for v in hi),
                  owner=int(owner), block_id=int(bid))
            for lo, hi, owner, bid in records]


def to_tensor(arr: np.ndarray, device="cuda") -> torch.Tensor:
    """One ndarray as a tensor on ``device`` (bfloat16 bit-exact: an
    ``ml_dtypes`` array, or the container's 2-byte stand-in)."""
    from .io.format import dtype_name     # the io package imports this one
    dev = resolve_device(device)
    arr = np.asarray(arr)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)   # keeps 0-d 0-d
    if dtype_name(arr.dtype) == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dev)


def tensors_from_numpy(data: Mapping[int, np.ndarray],
                       device="cuda") -> dict:
    """block_id -> ndarray  to  block_id -> tensor on ``device``."""
    return {bid: to_tensor(arr, device) for bid, arr in data.items()}


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """The inverse: a host ndarray with the tensor's bytes.  A bfloat16
    tensor comes back as its int16 bit pattern unless ``dtype`` (e.g.
    ``ml_dtypes.bfloat16``) names the type to view it as."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.numpy()
    return arr if dtype is None else arr.view(dtype)


def _map_tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, t) for t in tree]
    return None if tree is None else fn(tree)


def params_from_numpy(tree, device="cuda"):
    """A parameter tree of numpy arrays (nested dicts and lists, as the
    JAX package's ``LM.init`` makes it) as the port's tree of tensors on
    ``device``, under the same keys."""
    dev = resolve_device(device)
    return _map_tree(lambda a: to_tensor(np.array(a), dev), tree)


def params_to_numpy(tree, dtype=None):
    """The inverse: the port's parameter tree as numpy arrays (bfloat16 as
    in :func:`to_numpy`)."""
    return _map_tree(lambda t: to_numpy(t, dtype), tree)


def opt_state_from_numpy(state, device="cuda") -> dict:
    """An AdamW state of numpy arrays (``{"m", "v", "count"}``, as the JAX
    package's ``adamw_init``/``adamw_update`` make it) as the port's, on
    ``device``: a JAX step's state can be continued by the port."""
    return {"m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device),
            "count": to_tensor(np.asarray(state["count"], np.int32), device)}


def opt_state_to_numpy(state) -> dict:
    """The inverse: the port's AdamW state as numpy arrays."""
    return {"m": params_to_numpy(state["m"]),
            "v": params_to_numpy(state["v"]),
            "count": to_numpy(state["count"])}