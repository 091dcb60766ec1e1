"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and a reader a per-layer metric, all under
``perfbench/``.  A metric's reader is ``metrics/<metric>.py``, or where
there is none ``metrics/<stem>.py``, ``<stem>`` the name before its
first dot: ``mfu.py`` reads ``mfu.train`` and ``mfu.prefill``, each in
the cells that ``BENCHMARK.json`` lists for it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "Bench", "load", "load_json"]

HERE = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, spec: dict, root: Path = HERE):
        self.spec = spec
        self.root = root

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        return load_json(self.root / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.root / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return load_json(self.root / "limits" / f"{cell}.json")["limits"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell])]

    def reader_path(self, metric: str) -> Path:
        own = self.root / "metrics" / f"{metric}.py"
        return own if own.is_file() else \
            self.root / "metrics" / f"{metric.split('.')[0]}.py"

    def reader(self, metric: str):
        """The ``read(obs)`` function of the metric's reader."""
        path = self.reader_path(metric)
        mod_name = "perfbench_metric_" + path.stem.replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def load(root: Path = HERE) -> Bench:
    return Bench(load_json(root.parent / "BENCHMARK.json"), root)
