"""Finds a cell's files by name, so that a configuration, a traffic mix
or a per-layer metric is added by adding files:

  configs/<config>.json     the deployment (source, reduced, assumed)
  workloads/<cell>.json     the cell: its configuration, traffic kind,
                            chips and parameters
  traffic/<kind>.py         the driver of a traffic kind (`prepare`)
  metrics/<metric>.py       the reader of a per-layer metric (`read`);
                            for a metric `<family>.<part>` without a file
                            of its own, `metrics/<family>.py`

and BENCHMARK.json, at the checkout's root, for the metrics each cell
reports.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


class Registry:
    def __init__(self, root: str = HERE, benchmark: str | None = None):
        self.root = root
        self.benchmark_path = benchmark or os.path.join(
            os.path.dirname(HERE), "BENCHMARK.json")

    def _json(self, *parts):
        with open(os.path.join(self.root, *parts)) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name + ".json")

    def workload(self, name: str) -> dict:
        return self._json("workloads", name + ".json")

    def _module(self, kind: str, name: str):
        path = os.path.join(self.root, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"bench_port_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def traffic(self, kind: str):
        return self._module("traffic", kind)

    def reader(self, metric: str):
        name = metric
        if not os.path.exists(os.path.join(self.root, "metrics",
                                           metric + ".py")):
            name = metric.split(".", 1)[0]
        return self._module("metrics", name).read

    def benchmark(self) -> dict:
        with open(self.benchmark_path) as f:
            return json.load(f)

    def metrics_of(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: with trace the per-layer
        metrics that list the cell, else the end-to-end ones that list it
        or list no cells."""
        b = self.benchmark()
        if trace:
            return [m for m in b["per_layer"] if cell in m["workloads"]]
        return [m for m in b["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]
