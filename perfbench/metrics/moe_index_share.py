"""Device time of the kernels moving tokens to and from the experts: the
MoE dispatch (gather, ``where``, zeros, ``index_put``) and combine
(gather back, weighting, ``k``-sum), forward, recompute and backward
(spans ``repro_torch.moe.dispatch`` and ``repro_torch.moe.combine``), in
percent of the profiled sub-window's busy device time
(``harness/span_share``)."""

from harness.span_share import share

SPANS = ("repro_torch.moe.dispatch", "repro_torch.moe.combine")


def read(obs):
    return share(obs, SPANS)
