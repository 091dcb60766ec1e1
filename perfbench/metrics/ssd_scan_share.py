"""Device time of the kernels of the Mamba-2 SSD chunk loop, from the
state's zeros to the stack of the chunk outputs (span
``repro_torch.ssd.scan``, ``models/ssm.py``), in percent of the profiled
sub-window's busy device time (``harness/span_share``)."""

from harness.span_share import share

SPANS = ("repro_torch.ssd.scan",)


def read(obs):
    return share(obs, SPANS)
