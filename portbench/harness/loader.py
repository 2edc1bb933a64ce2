"""Find every piece of a cell by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the cells
(``workloads``) and the metrics. For a cell the loader reads

- its configuration from the ``file`` its ``configs`` entry names,
- its traffic mix from ``portbench/traffic/<traffic>.json``, which names its driver
  ``portbench/drivers/<driver>.py``,
- its correctness limits from ``portbench/limits/<cell>.json``,
- each metric's reader from ``portbench/metrics/<metric>.py``.

A cell reports every end-to-end metric whose ``workloads`` list it, or that has no
such list; with tracing, every per-layer metric chosen the same way.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    driver: object
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = ROOT

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric: dict):
        path = self.root / "portbench" / "metrics" / f"{metric['name']}.py"
        return load_module(path, "portbench_metric_" + metric["name"].replace(".", "_"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{workload['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{name}.json").read_text())
    driver = load_module(root / "portbench" / "drivers" / f"{mix['driver']}.py",
                         "portbench_driver_" + mix["driver"])
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and ("workloads" in m or m["moves"] in reported)]
    return Cell(name, workload, config, mix, limits, driver, end_to_end, per_layer, root)
