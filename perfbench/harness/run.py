"""One run of one cell: the entry its traffic file names, the check, the
metrics of the run's kind, and the result line's fields."""

from __future__ import annotations

import time

from . import check as chk
from .entries import ENTRIES
from .spec import Bench

__all__ = ["run_cell", "device_info"]


def device_info(device, chips: int, peak: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak}


def _end_to_end(bench: Bench, name: str, run) -> dict:
    values = {"setup_s": run.setup_s,
              "train_tokens_per_s": run.tokens / run.window_s,
              "prefill_tokens_per_s": run.tokens / run.window_s}
    out = {}
    for m in bench.end_to_end(name):
        if m["name"] not in values:
            raise KeyError(f"no end-to-end reading named {m['name']!r}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def _per_layer(bench: Bench, name: str, run) -> dict:
    out = {}
    for m in bench.per_layer(name):
        v = bench.reader(m["name"])(run.obs)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float | None = None) -> dict:
    """The result line's fields for one run of cell ``name``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    run = ENTRIES[mix["entry"]](cfg, mix, seed, seconds, trace, device,
                                t_start)
    nums = chk.numbers(run.check, cfg, mix, seed, device)
    correct, checks = chk.judge(nums, bench.limits(name))
    correct = correct and run.failed == 0
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed,
           "metrics": _per_layer(bench, name, run) if trace
           else _end_to_end(bench, name, run),
           "device": device_info(device, cell["chips"],
                                 run.memory_peak_bytes)}
    if trace:
        prof = run.obs["profiled"]
        out["device"].update(busy_s=prof["busy_s"],
                             window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    return out
