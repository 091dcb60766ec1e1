"""The traced sub-window: ``torch.profiler`` over the host and the card,
reduced from its Chrome trace to what the per-layer readers take.

The benchmark marks its own spans with ``record_function``: the window
(``WINDOW``) and, inside it, ``data`` (the feed), ``step`` (a training
step), ``generate`` (a static batch) and ``sync``.  Device activity is
every kernel, copy and fill; the window's idle time is what their union
leaves of it, and each of the longest idle gaps is named by the
benchmark span the host was in at its middle and the host operator that
launched the kernel ending it.  Each kernel's device time is also
counted toward every host operator and span that encloses the runtime
call launching it (``op_device_s``, by name): a reader takes a layer's
device time from there by the names of its operators or spans."""

from __future__ import annotations

import bisect
import json
import os
import tempfile

__all__ = ["WINDOW", "SPANS", "profile", "span", "reduce"]

WINDOW = "perfbench.window"
SPANS = ("data", "step", "generate", "sync")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
TOP = 10


def profile():
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile
    return _profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA])


def span(name: str):
    from torch.profiler import record_function
    return record_function(name)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


class _Innermost:
    """The innermost interval holding a time, per thread."""

    def __init__(self, events):
        self.by_tid: dict = {}
        for e in events:
            self.by_tid.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        for v in self.by_tid.values():
            v.sort()
        self.starts = {t: [x[0] for x in v] for t, v in self.by_tid.items()}

    def at(self, tid, t):
        # intervals of one thread nest: the latest start that still holds
        # ``t`` is the innermost
        v = self.by_tid.get(tid, [])
        for i in range(bisect.bisect_right(self.starts.get(tid, []), t) - 1,
                       -1, -1):
            if v[i][1] >= t:
                return v[i][2]
        return None


def _device_by_op(kernels, launcher, host) -> dict:
    """Device seconds of ``kernels`` by the name of each ``host`` event
    (operator or span) enclosing the runtime call that launched them; a
    kernel counts once toward each name.  Host events of one thread nest,
    so a sweep over each thread's launches in time order keeps the open
    ones on a stack."""
    events: dict = {}
    for e in host:
        events.setdefault(e.get("tid"), []).append(
            (e["ts"], -e.get("dur", 0), e["name"]))
    calls: dict = {}
    for k in kernels:
        rt = launcher(k)
        if rt is not None:
            calls.setdefault(rt.get("tid"), []).append(
                (rt["ts"], k.get("dur", 0)))
    out: dict = {}
    for tid, launches in calls.items():
        evs, i, stack = sorted(events.get(tid, [])), 0, []
        for t, dur in sorted(launches):
            while i < len(evs) and evs[i][0] <= t:
                start, neg, name = evs[i]
                i += 1
                while stack and stack[-1][0] < start:
                    stack.pop()
                stack.append((start - neg, name))
            while stack and stack[-1][0] < t:
                stack.pop()
            for name in {n for _, n in stack}:
                out[name] = out.get(name, 0.0) + dur / 1e6
    return out


def reduce(prof) -> dict:
    """The profiled window: ``window_s``, ``busy_s``, ``launches``,
    ``op_device_s`` (``_device_by_op``), ``device_ops`` (the kernels
    taking most time, by name) and ``idle_gaps`` (the longest, named
    ``span/operator``)."""
    ev = [e for e in _events(prof) if e.get("ph") == "X"]
    win = [e for e in ev if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    dev = [e for e in ev if e.get("cat") in _DEVICE
           and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1))
                   for e in dev])
    busy_us = sum(b - a for a, b in busy)
    kernels = [e for e in dev if e.get("cat") == "kernel"]

    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in _LAUNCH and "correlation" in e.get("args",
                                                                    {})}
    cpu_ops = [e for e in ev if e.get("cat") == "cpu_op"]
    notes = [e for e in ev if e.get("cat") == "user_annotation"]
    ops = _Innermost(cpu_ops)
    spans = _Innermost([e for e in notes if e["name"] in SPANS])

    def launcher(k):
        return launch.get(k.get("args", {}).get("correlation"))

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = sorted((k["ts"], i) for i, k in enumerate(kernels))
    named = []
    host_tid = win[0].get("tid")
    for a, b in gaps[:TOP]:
        where = spans.at(host_tid, (a + b) / 2) or "window"
        j = bisect.bisect_left(starts, (b, -1))
        op = None
        if j < len(starts):
            rt = launcher(kernels[starts[j][1]])
            if rt is not None:
                op = ops.at(rt.get("tid"), rt["ts"])
        named.append([f"{where}/{op}" if op else where, (b - a) / 1e6])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "launches": len(kernels),
            "op_device_s": _device_by_op(kernels, launcher, cpu_ops + notes),
            "device_ops": [[n[:160], us / 1e6] for n, us in top],
            "idle_gaps": named}
