"""Finds everything of one cell by the names in ``BENCHMARK.json``.

A cell (``workloads[]``) names its configuration and its traffic mix;
``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json`` and
``bench/workloads/<cell>.json`` hold them, and each metric of
``end_to_end`` and ``per_layer`` that the cell reports has its reader in
``bench/metrics/<metric>.py``.  Each model of a configuration names its
reference family, ``bench/reference/families/<name>.py`` (weights, plain
forward pass, work counts), by its ``"reference"`` key.  Adding a cell, a
configuration, a mix, a family or a per-layer metric is adding such files
and entries: nothing here names one but the default family.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Mapping

BENCH = Path(__file__).resolve().parent.parent
# the family of a model entry that names none
DEFAULT_FAMILY = "gqa"


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]            # the BENCHMARK.json workload entry
    config: Dict[str, Any]           # bench/configs/<config>.json
    traffic: Dict[str, Any]          # bench/traffic/<traffic>.json
    serve: Dict[str, Any]            # bench/workloads/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH          # where the cell's files were found

    @property
    def chips(self) -> int:
        return int(self.entry.get("chips", 1))

    def family(self, model: str) -> ModuleType:
        """The reference family of the configuration's ``model``."""
        return load_family(self.config["models"][model].get(
            "reference", DEFAULT_FAMILY), self.bench_dir)


def _load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Mapping, cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # without a list: every cell that reports the metric it moves
    return metric["moves"] in e2e_of_cell


def load_cell(benchmark: Mapping, name: str, bench_dir: Path = BENCH
              ) -> Cell:
    entries = {w["name"]: w for w in benchmark["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; have {sorted(entries)}")
    entry = entries[name]
    e2e = [m for m in benchmark["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in benchmark["per_layer"]
                 if _reports(m, name, names)]
    cell = Cell(
        name=name, entry=entry,
        config=_load(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=_load(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        serve=_load(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)
    for model in cell.config["models"]:
        cell.family(model)
    return cell


_FAMILIES: Dict[Path, ModuleType] = {}


def load_family(name: str, bench_dir: Path = BENCH) -> ModuleType:
    """The module ``bench/reference/families/<name>.py``, loaded once."""
    path = (bench_dir / "reference" / "families" / f"{name}.py").resolve()
    if path not in _FAMILIES:
        if not path.is_file():
            have = sorted(p.stem for p in path.parent.glob("*.py")
                          if not p.stem.startswith("_"))
            raise ValueError(f"no reference family {name!r} ({path} is "
                             f"not there); have {have}")
        mod_name = f"bench_family_{name}_{len(_FAMILIES)}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod     # for its dataclasses' annotations
        spec.loader.exec_module(mod)
        _FAMILIES[path] = mod
    return _FAMILIES[path]


def reader(metric: str, bench_dir: Path = BENCH) -> Callable:
    """``read(ctx) -> float | None`` of ``bench/metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_benchmark(root: Path) -> Dict[str, Any]:
    return _load(root / "BENCHMARK.json")
