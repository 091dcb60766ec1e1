"""Attribute an op-level cost to source files through the Python stack at
dispatch: the counterpart of the JAX package's ``launch/attribution.py``,
which walks the stack-frame metadata of the optimized HLO.

Used to (a) measure how much of a step's device-memory traffic belongs
to a given source region (e.g. ``models/attention.py``, the score
tensors), and (b) substitute the analytic traffic of the flash kernel
(``flash_attention_traffic``) for what a dry run counts at its custom ops'
boundaries.  Ops dispatched by the autograd engine in the backward pass
have no Python caller of the model on their stack: only the code that
called ``backward()``, or a ``torch.autograd.Function``'s backward.
"""

from __future__ import annotations

import sys

from .op_analysis import OpCounter

__all__ = ["file_attributed_bytes", "flash_attention_traffic"]


def _stack_passes(substr: str) -> bool:
    f = sys._getframe(2)
    while f is not None:
        if substr in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def file_attributed_bytes(fn, substr: str, *args, **kwargs) -> float:
    """Device-memory bytes (``launch/op_analysis.py``'s count) of the ops
    that one call ``fn(*args, **kwargs)`` dispatches with a Python stack
    passing through a file whose path contains ``substr``."""
    total = 0.0

    def on_op(func, nbytes):
        nonlocal total
        if _stack_passes(substr):
            total += nbytes
    with OpCounter(on_op=on_op):
        fn(*args, **kwargs)
    return total


def flash_attention_traffic(batch_loc: int, heads_loc: int, lq: int,
                            lk: int, d: int, block: int,
                            dtype_bytes: int = 2, causal: bool = True,
                            with_backward: bool = True) -> float:
    """Analytic HBM traffic of the flash kernel per call (per device).

    Per (iq, ik) tile: Q block (bq x D) + K,V blocks (2 x bk x D); causal
    skips ~half the tiles.  Output O (+lse) written once.  Backward runs the
    tile stream twice more (dq pass, dkv pass) plus dO reads and dQ/dK/dV
    writes.
    """
    nq, nk = lq // block, lk // block
    pairs = nq * nk * (0.5 if causal else 1.0)
    per_tile = (block * d + 2 * block * d) * dtype_bytes
    fwd = pairs * per_tile + lq * d * dtype_bytes + lq * 4
    if not with_backward:
        return batch_loc * heads_loc * fwd
    bwd = 2 * pairs * (per_tile + block * d * dtype_bytes) \
        + (lq * d + 2 * lk * d) * 4 + lq * d * dtype_bytes
    return batch_loc * heads_loc * (fwd + bwd)
