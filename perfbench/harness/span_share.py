"""Shares of the profiled sub-window's busy device time taken by the
kernels launched inside the program's own spans (``repro_torch.*``, from
``repro_torch/spans.py``), read from ``op_device_s``: a kernel counts
toward every span enclosing its launch, a region's backward included."""

from __future__ import annotations

__all__ = ["share"]


def share(obs, spans) -> float | None:
    """100 x the device seconds under ``spans`` over the busy seconds, or
    None where none of them launched a kernel (an untraced run, the CPU, a
    program without those spans)."""
    p = obs.get("profiled")
    if not p or p["busy_s"] <= 0:
        return None
    found = [p["op_device_s"][s] for s in spans if s in p["op_device_s"]]
    if not found:
        return None
    return 100.0 * sum(found) / p["busy_s"]
