"""Device time of the kernels of the AdamW update: global norm, clipping,
every leaf's moments and step (span ``repro_torch.adamw``,
``train/optimizer.py``), in percent of the profiled sub-window's busy
device time (``harness/span_share``)."""

from harness.span_share import share

SPANS = ("repro_torch.adamw",)


def read(obs):
    return share(obs, SPANS)
