"""Device time of the kernels recomputing checkpointed layers in the
backward pass (span ``repro_torch.remat.recompute``, ``models/model.py``
``_remat``): what remat costs, in percent of the profiled sub-window's
busy device time (``harness/span_share``)."""

from harness.span_share import share

SPANS = ("repro_torch.remat.recompute",)


def read(obs):
    return share(obs, SPANS)
