"""Finding a cell's parts by name.

``BENCHMARK.json`` (at ``root``) names the cells, configurations and
metrics; the files behind the names sit in the benchmark's folder:

  * a configuration's file is its ``file`` entry;
  * a traffic mix is ``workloads/<traffic>.json``, whose ``driver`` names
    ``drivers/<driver>.py``;
  * a cell's correctness limits are ``limits/<cell>.json``;
  * a per-layer metric's reader is ``metrics/<metric>.py``, a kernel's
    costs ``costs/<kernel>.py``.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, Optional[float]]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, reported_e2e: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or it has none and (a per-layer metric) the end-to-end
    metric it moves is reported there."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported_e2e


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at ``path`` as a module called ``name`` (metric and
    driver files carry dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())

    def limits(self, cell: str) -> Dict[str, Optional[float]]:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        e2e = [m for m in self.spec["end_to_end"]
               if _applies(m, name, [])]
        names = [m["name"] for m in e2e]
        per_layer = [m for m in self.spec["per_layer"]
                     if _applies(m, name, names)]
        return Cell(name=name, chips=int(w["chips"]),
                    config_name=w["config"], config=self.config(w["config"]),
                    traffic_name=w["traffic"],
                    traffic=self.traffic(w["traffic"]),
                    limits=self.limits(name), end_to_end=e2e,
                    per_layer=per_layer)

    def driver(self, cell: Cell) -> ModuleType:
        name = cell.traffic["driver"]
        return load_module(self.dir / "drivers" / f"{name}.py",
                           f"bench_driver_{name}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}")

    def costs(self, kernel: str) -> ModuleType:
        return load_module(self.dir / "costs" / f"{kernel}.py",
                           f"bench_costs_{kernel}")
