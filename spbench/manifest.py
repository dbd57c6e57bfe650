"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell ``<config>.<mix>`` names a configuration entry, whose ``file`` holds
the deployment, and a traffic mix, ``traffic/<mix>.json``; its limits are
``limits/<cell>.json`` and each metric's reader is ``metrics/<name>.py``
(or, for ``<base>.<qualifier>``, ``metrics/<base>.py``). A configuration
whose file names a ``driver`` is run by ``drivers/<driver>.py``; one
without runs through ``harness.run_cell``.
Adding a cell, a mix or a metric adds files and manifest entries and edits
none of these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]      # the manifest's metric entries this cell
    per_layer: List[Dict]       # reports, in manifest order
    package: Path               # where the cell's files were found


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT,
            package: Optional[Path] = None) -> Cell:
    """The cell named ``workload``: its configuration, traffic, limits and
    metrics. ``package`` is the directory of the data files (this package
    by default)."""
    manifest = load_manifest(root)
    package = PACKAGE if package is None else Path(package)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    config = _load_json(root / entry["file"])
    traffic = _load_json(package / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(package / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"]
                    if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"]
                   if _reports(m, workload)],
        package=package)


def load_module(path: Path) -> ModuleType:
    """Import a reader, generator or driver file by its path (metric names
    may hold dots, which module names cannot). The module is entered in
    ``sys.modules``, as an import would, so its dataclasses resolve."""
    name = "spbench_file_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(package: Path, metric: str) -> ModuleType:
    """``metrics/<metric>.py``; failing that, the reader of the name before
    its first dot, so that ``useful_gflop_s.spmm`` (a quantity split by the
    cells that report it, each with its own bound) reads as
    ``useful_gflop_s`` does."""
    path = package / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = package / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path)


def generator(package: Path, name: str) -> ModuleType:
    return load_module(package / "gen" / f"{name}.py")


def driver(package: Path, name: str) -> ModuleType:
    """``drivers/<name>.py``: the ``run_cell`` of a configuration that
    names it."""
    return load_module(package / "drivers" / f"{name}.py")


def runner(cell: Cell):
    """The ``run_cell`` that runs ``cell``: its configuration's driver, or
    the sparse harness's."""
    name = cell.config.get("driver")
    if name is None:
        from spbench import harness
        return harness.run_cell
    return driver(cell.package, name).run_cell
