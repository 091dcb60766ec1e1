"""Device time of the kernels of the decode steps, each a step and its
sample (span ``repro_torch.serve.decode``, ``serve/engine.py``), in
percent of the profiled sub-window's busy device time
(``harness/span_share``)."""

from harness.span_share import share

SPANS = ("repro_torch.serve.decode",)


def read(obs):
    return share(obs, SPANS)
