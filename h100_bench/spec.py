"""The benchmark's data, found by name.

``BENCHMARK.json`` names the cells, configurations and metrics. Whatever
belongs to one of them sits in files of its own under the benchmark's
folder (``paths[0]``), found by its name:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the model's fields, ``dtype``, ``source``, ``reduced``, ``assumed``;
* ``traffic/<traffic>.json``: a traffic mix, whose ``kind`` names its
  driver, ``drivers/<kind>.py``, and the driver's parameters;
* ``metrics/<metric>.py``: the reader of a per-layer metric;
* ``limits/<cell>.json``: the limit of each number the cell compares.

So a later change adds a configuration, a mix, a cell or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCHMARK_JSON = Path(__file__).resolve().parents[1] / "BENCHMARK.json"


class Bench:
    def __init__(self, path: Path = BENCHMARK_JSON):
        self.path = Path(path)
        self.base = self.path.parent
        self.data = json.loads(self.path.read_text())
        self.root = self.base / self.data["paths"][0]
        self._modules: Dict[Path, ModuleType] = {}

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> Dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.base / entry["file"]).read_text())

    def traffic(self, name: str) -> Dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> Dict[str, float]:
        return json.loads((self.root / "limits" / f"{cell}.json").read_text())["limits"]

    def _load(self, path: Path) -> ModuleType:
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"h100_bench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def driver(self, kind: str) -> ModuleType:
        return self._load(self.root / "drivers" / f"{kind}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return self._load(self.root / "metrics" / f"{name}.py")

    @staticmethod
    def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves") is None or metric["moves"] in reported

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell, [])]

    def per_layer(self, cell: str) -> List[Dict]:
        reported = [m["name"] for m in self.end_to_end(cell)]
        return [m for m in self.data["per_layer"] if self._applies(m, cell, reported)]
