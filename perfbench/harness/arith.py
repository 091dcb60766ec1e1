"""The yardstick's arithmetic, worked out from a cell's shapes and never
from what the program dispatches.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989.4 TFLOP/s in
bf16 on the tensor cores, 3.35 TB/s of HBM3, at the full 700 W power
limit (``run.py`` reports the card's own limit beside every result).

Model flops (the definition of ``launch/specs.model_flops_estimate`` in
the port): 6 N tokens for a training step, 2 N tokens for a forward pass,
N every parameter, embedding and head included, an expert weight counted
``top_k / n_experts``; attention's score products are not in it.

Attention: the (q, k) pairs the masks keep (causal, a one-sided window
``q - k < window``), 4 D flops a live pair forward, 6 D for dq and 8 D
for dkv, at the unpadded head dim (``kernels/flash_attention.live_pairs``
and ``flash_flops`` in the port, and the kernel table's bounds)."""

from __future__ import annotations

import numpy as np

from reference.params import count

__all__ = ["PEAK_FLOPS", "PEAK_BYTES_PER_S", "active_params", "model_flops",
           "live_pairs", "attention_flops"]

PEAK_FLOPS = {"bfloat16": 989.4e12}
PEAK_BYTES_PER_S = 3.35e12


def active_params(model: dict) -> float:
    n = count(model)
    if model.get("moe") is None:
        return float(n["total"])
    e = model["moe"]
    return n["total"] - n["experts"] + n["experts"] * e["top_k"] \
        / e["n_experts"]


def model_flops(model: dict, kind: str, tokens: int) -> float:
    """``kind``: ``"train"`` (6 N) or ``"forward"`` (2 N) over ``tokens``."""
    per = {"train": 6.0, "forward": 2.0}[kind]
    return per * active_params(model) * tokens


def live_pairs(Lq: int, Lk: int, causal: bool, window) -> int:
    qp = np.arange(Lq)
    lo = np.zeros(Lq, np.int64) if window is None else \
        np.maximum(qp - window + 1, 0)
    hi = np.minimum(qp + 1, Lk) if causal else np.full(Lq, Lk)
    return int(np.maximum(hi - lo, 0).sum())


_PER_PAIR = {"fwd": 4, "dq": 6, "dkv": 8}
_ATTN_KINDS = {"attn": False, "moe": False, "hyb_full": False, "swa": True,
               "hyb_swa": True}


def attention_flops(model: dict, rows: int, seq: int, passes) -> float:
    """Useful self-attention flops of one pass over ``rows`` sequences of
    ``seq`` tokens, every layer of the program, ``passes`` a subset of
    ``("fwd", "dq", "dkv")``."""
    per = sum(_PER_PAIR[p] for p in passes)
    total = 0
    for kind, n in model["program"]:
        if kind not in _ATTN_KINDS:
            continue
        window = model["window"] if _ATTN_KINDS[kind] else None
        pairs = live_pairs(seq, seq, model["causal"], window)
        total += n * per * model["head_dim"] * rows * model["n_heads"] * pairs
    return float(total)
