"""Device time of the kernels launched in the MoE block, forward, recompute
and backward (span ``repro_torch.moe``, ``models/moe.py``), in percent
of the profiled sub-window's busy device time (``harness/span_share``)."""

from harness.span_share import share

SPANS = ("repro_torch.moe",)


def read(obs):
    return share(obs, SPANS)
