"""Share of the profiled sub-window in which no kernel, copy or fill ran
on the card, in percent: 100 (1 - busy / window), from the device trace
(``harness/trace.reduce``)."""


def read(obs):
    p = obs.get("profiled")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
