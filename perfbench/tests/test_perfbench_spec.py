"""``BENCHMARK.json`` against the contract's shape, and everything its
names lead to found by name: configurations, traffic mixes, limits and
one reader a per-layer metric."""

import json
import math
import re

import pytest

from conftest import HERE, ROOT, SERVE, TRAIN

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    s = _spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["perfbench"]
    assert s["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_sources():
    s = _spec()
    names = [c["name"] for c in s["configs"]] + \
        [w["name"] for w in s["workloads"]] + \
        [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files(bench):
    s = _spec()
    configs = {c["name"]: c for c in s["configs"]}
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"]
        assert configs[w["config"]]["file"] == \
            f"perfbench/configs/{w['config']}.json"
        assert sorted(configs[w["config"]]["reduced"]) == \
            sorted(cfg["reduced"])
        mix = bench.traffic(w["traffic"])
        assert mix["entry"] in ("train", "generate")
        assert bench.limits(w["name"])
        per = bench.per_layer(w["name"])
        assert per, w["name"]
        assert len(bench.end_to_end(w["name"])) >= 2
    for c in s["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in s["workloads"])


def test_every_per_layer_metric_has_a_reader(bench):
    for m in _spec()["per_layer"]:
        path = bench.reader_path(m["name"])
        assert path.is_file() and path.parent == HERE / "metrics"
        assert callable(bench.reader(m["name"]))


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_config_builds_the_ports_model_and_layout(bench, cell):
    """The configuration file builds the port's model, and the
    reference's parameter layout is the port's, leaf for leaf."""
    from harness.entries import model_config
    from reference.params import flatten, specs
    from repro_torch.models import LM
    from repro_torch.models.params import tree_leaves
    m = bench.config(bench.cell(cell)["config"])["model"]
    model = LM(model_config(m), device="cpu")
    ours = {n: s.shape for n, s in flatten(specs(m))}
    theirs = {n: tuple(d.shape) for n, d in flatten(model.skeleton())}
    assert ours == theirs
    assert sum(math.prod(s) for s in ours.values()) == \
        sum(math.prod(d.shape) for d in tree_leaves(model.skeleton()))
