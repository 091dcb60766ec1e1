"""Kernels launched on the card in the profiled sub-window, from the
device trace, per call of the entry (a training step, or a static
batch's prefill and decode steps): an exact count of the host's
dispatches."""


def read(obs):
    p = obs.get("profiled")
    if not p or not p["units"]:
        return None
    return p["launches"] / p["units"]
