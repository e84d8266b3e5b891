"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one per-layer metric is a file of its own, found by name under the
benchmark's folder (the manifest's first ``paths`` entry):

* a configuration: the ``file`` its entry names (JSON); its ``system``
  and ``reference`` keys name modules of :mod:`portbench.systems` and
  :mod:`portbench.reference`;
* a traffic mix: ``traffic/<traffic>.json``;
* a cell's correctness limits: ``limits/<workload>.json``;
* a per-layer metric: ``metrics/<name>.py``, whose ``read(ctx)``
  returns the metric's value or None where it finds nothing to read.

So a later configuration, mix or metric is new files and new entries in
``BENCHMARK.json``, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType


class Manifest:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.bench_dir = os.path.join(self.root, self.data["paths"][0])

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._named("configs", name)
        with open(self.path(entry["file"])) as f:
            return json.load(f)

    def _json(self, folder: str, name: str) -> dict:
        with open(os.path.join(self.bench_dir, folder, f"{name}.json")) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a ``workloads`` key where the cell reports the
        end-to-end metric they move."""
        moved = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def metric_module(self, name: str) -> ModuleType:
        path = os.path.join(self.bench_dir, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
