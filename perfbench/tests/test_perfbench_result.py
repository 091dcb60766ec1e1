"""The result line: its keys and their order, the end-to-end and per-layer
metrics of each kind of run, the refusal without a card or with JAX
loaded, and the reduction of a profiler trace."""

import json
import sys
import types

import pytest

import run as entry
from conftest import SERVE, TRAIN

DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(small, cell, trace):
    from harness.run import run_cell
    bench = small(cell)
    out = run_cell(bench, cell, 12345, 0.1, trace, device="cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(out) == keys
    json.dumps(out)
    assert out["attempted"] > 0
    if trace:
        assert set(out["device"]) == DEVICE | {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10
        # the CPU has no device trace and no allocator counter: of the
        # per-layer metrics the host-clock ones remain
        names = {m["name"] for m in bench.per_layer(cell)}
        assert set(out["metrics"]) <= names
        assert {n for n in names if n.startswith("mfu.")} <= \
            set(out["metrics"])
    else:
        assert set(out["device"]) == DEVICE
        assert set(out["metrics"]) == \
            {m["name"] for m in bench.end_to_end(cell)}
        for m in out["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0


def test_no_card_no_result(capsys):
    assert entry.main(["--workload", SERVE, "--seed", "1", "--seconds",
                       "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_banned_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert entry.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert entry.banned_modules() == ["jaxlib", "repro"]


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_reduction(monkeypatch):
    """A window of 100 us: kernels at 10-30 (flash, launched inside the
    flash op), 25-40 and 60-70; idle 0-10, 40-60 and 70-100."""
    from harness import trace
    ev = [_x(trace.WINDOW, "user_annotation", 0, 100),
          _x("step", "user_annotation", 0, 80),
          _x("sync", "user_annotation", 80, 20),
          _x("repro_torch::flash_fwd", "cpu_op", 2, 5),
          _x("cudaLaunchKernel", "cuda_runtime", 3, 1, correlation=1),
          _x("aten::mm", "cpu_op", 8, 4),
          _x("cudaLaunchKernel", "cuda_runtime", 9, 1, correlation=2),
          _x("aten::add", "cpu_op", 50, 9),
          _x("cudaLaunchKernel", "cuda_runtime", 55, 1, correlation=3),
          _x("flash_fwd_sm90_kernel", "kernel", 10, 20, tid=7,
             correlation=1),
          _x("gemm", "kernel", 25, 15, tid=7, correlation=2),
          _x("add_kernel", "kernel", 60, 10, tid=7, correlation=3)]
    monkeypatch.setattr(trace, "_events", lambda prof: ev)
    r = trace.reduce(None)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)
    # device time by the host operators and spans enclosing each launch
    assert r["op_device_s"] == {
        "repro_torch::flash_fwd": pytest.approx(20e-6),
        "aten::mm": pytest.approx(15e-6), "aten::add": pytest.approx(10e-6),
        "step": pytest.approx(45e-6), trace.WINDOW: pytest.approx(45e-6)}
    assert r["launches"] == 3
    assert [n for n, _ in r["device_ops"]] == ["flash_fwd_sm90_kernel",
                                               "gemm", "add_kernel"]
    assert r["idle_gaps"] == [["sync", pytest.approx(30e-6)],
                              ["step/aten::add", pytest.approx(20e-6)],
                              ["step/repro_torch::flash_fwd",
                               pytest.approx(10e-6)]]


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_one_reader_serves_each_cells_metric(bench, cell):
    """Each per-layer metric of the cell, read by its quantity's reader
    from a traced run's observations: the flash share from the device
    time under the flash custom ops, the rest from the window."""
    from harness import arith
    w = bench.cell(cell)
    mix = bench.traffic(w["traffic"])
    entry_ = mix["entry"]
    rows = mix.get("rows", mix.get("batch"))
    seq = mix.get("seq_len", mix.get("prompt_len"))
    obs = {"entry": entry_, "model": bench.config(w["config"])["model"],
           "rows": rows, "seq_len": seq, "peak_window_bytes": 2 ** 31,
           "untraced": {"units": 4, "seconds": 2.0, "tokens": 4 * rows * seq},
           "profiled": {"units": 2, "window_s": 1.0, "busy_s": 0.75,
                        "launches": 300,
                        "op_device_s": {"repro_torch::flash_fwd": 0.2,
                                        "repro_torch::flash_dq": 0.1,
                                        "aten::mm": 0.4}}}
    got = {m["name"]: bench.reader(m["name"])(obs)
           for m in bench.per_layer(cell)}
    stem = {n.split(".")[0]: v for n, v in got.items()}
    assert stem["device_idle_share"] == pytest.approx(25.0)
    assert stem["launches_per_call"] == 150
    passes = ("fwd", "dq", "dkv") if entry_ == "train" else ("fwd",)
    assert stem["flash_roofline"] == pytest.approx(
        100 * 2 * arith.attention_flops(obs["model"], rows, seq, passes)
        / arith.PEAK_FLOPS["bfloat16"] / 0.3)
    kind = "train" if entry_ == "train" else "forward"
    assert stem["mfu"] == pytest.approx(
        100 * arith.model_flops(obs["model"], kind, 4 * rows * seq) / 2.0
        / arith.PEAK_FLOPS["bfloat16"])
    if "peak_mem_gib" in stem:
        assert stem["peak_mem_gib"] == 2.0
