"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root,
the configuration file it names, ``traffic/<traffic>.json`` and one
reader ``metrics/<metric>.py`` per metric the cell reports.  Nothing here
lists cells, configurations, mixes or metrics: a new one is new files and
a new entry in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

__all__ = ["HERE", "ROOT", "Cell", "load_cell", "load_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and the metrics it reports (``end_to_end`` with ``--trace 0``,
    ``per_layer`` with ``--trace 1``)."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                           f"{sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = json.loads((ROOT / entry["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def load_cell(name: str) -> Cell:
    return Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)


def load_reader(metric: str) -> ModuleType:
    """The reader module of ``metric``: ``metrics/<metric>.py``, loaded
    by its path (metric names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "streambench_metric_" + metric.replace(".", "_"),
        HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
