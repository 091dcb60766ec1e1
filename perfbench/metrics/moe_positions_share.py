"""Device time of the kernels computing the MoE dispatch positions (span
``repro_torch.moe.positions``, ``models/moe.py``: the int32 cumsum,
``keep``, the clamp; forward and recompute, no backward), in percent of
the profiled sub-window's busy device time (``harness/span_share``)."""

from harness.span_share import share

SPANS = ("repro_torch.moe.positions",)


def read(obs):
    return share(obs, SPANS)
