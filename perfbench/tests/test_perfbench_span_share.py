"""The readers of the program's spans (``source: program_span``): each is
the device time under its spans over the busy time, in percent, and
nothing where none of its spans launched a kernel."""

import json

import pytest

from conftest import ROOT

#: each ``program_span`` metric and the spans its reader sums
SPANS = {
    "moe_share.train": ("repro_torch.moe",),
    "moe_positions_share.train": ("repro_torch.moe.positions",),
    "moe_index_share.train": ("repro_torch.moe.dispatch",
                              "repro_torch.moe.combine"),
    "optimizer_share.train": ("repro_torch.adamw",),
    "remat_share.train": ("repro_torch.remat.recompute",),
    "ssd_scan_share.prefill": ("repro_torch.ssd.scan",),
    "decode_share.prefill": ("repro_torch.serve.decode",),
}


def _obs(op_device_s: dict) -> dict:
    return {"profiled": {"units": 1, "window_s": 2.5, "busy_s": 2.0,
                         "launches": 10, "op_device_s": op_device_s}}


def test_every_program_span_metric_is_listed():
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    names = {m["name"] for m in spec["per_layer"]
             if m["source"] == "program_span"}
    assert names == set(SPANS)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_share_of_busy_time_under_its_spans(bench, metric):
    read = bench.reader(metric)
    others = {"aten::mm": 0.75, "repro_torch.other": 0.5,
              "perfbench.window": 2.0}
    mine = {s: 0.1 * (i + 1) for i, s in enumerate(SPANS[metric])}
    assert read(_obs(dict(others, **mine))) == \
        pytest.approx(100 * sum(mine.values()) / 2.0)
    # one of two spans alone still reads
    first = SPANS[metric][0]
    assert read(_obs(dict(others, **{first: 0.5}))) == pytest.approx(25.0)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_nothing_without_its_spans(bench, metric):
    read = bench.reader(metric)
    assert read(_obs({"aten::mm": 0.75, "perfbench.window": 2.0})) is None
    assert read({"untraced": {"units": 3}}) is None
    assert read({"profiled": {"busy_s": 0.0, "op_device_s": {
        SPANS[metric][0]: 0.0}}}) is None
