"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and which
metrics each reports. Each piece is a file of its own, found by the name
that the listing gives:

* a cell:          ``benchmark/workloads/<cell>.json`` (its configuration,
                   driver, traffic parameters and check limits);
* a configuration: ``benchmark/configs/<config>.json``;
* a driver:        ``benchmark/drivers/<driver>.py`` (a class ``Driver``);
* a per-layer metric: ``benchmark/metrics/<metric>.py`` (a function
                   ``read(window, info)`` that returns a number, or None
                   where the run gives it nothing to read).

Adding a cell or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import List, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cells(root: str = ROOT) -> List[str]:
    return [w["name"] for w in spec(root)["workloads"]]


def cell(name: str, root: str = ROOT) -> Tuple[dict, dict]:
    """(workload, configuration) of the cell `name`."""
    entry = next((w for w in spec(root)["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    work = _json(root, "benchmark", "workloads", f"{name}.json")
    conf = _json(root, "benchmark", "configs", f"{entry['config']}.json")
    return work, conf


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def cell_metrics(name: str, root: str = ROOT) -> Tuple[List[dict],
                                                        List[dict]]:
    """(end-to-end, per-layer) metric entries that cell `name` reports."""
    s = spec(root)
    return ([m for m in s["end_to_end"] if _reports(m, name)],
            [m for m in s["per_layer"] if _reports(m, name)])


def driver(name: str, root: str = ROOT):
    """The class ``Driver`` of ``benchmark/drivers/<name>.py``."""
    if root == ROOT:
        return importlib.import_module(f"benchmark.drivers.{name}").Driver
    return _load(os.path.join(root, "benchmark", "drivers", f"{name}.py"),
                 f"benchmark.drivers._{name}").Driver


def metric(name: str, root: str = ROOT):
    """The module of the per-layer metric `name`."""
    return _load(os.path.join(root, "benchmark", "metrics", f"{name}.py"),
                 "benchmark.metrics." + name.replace(".", "__"))


def _load(path: str, module: str):
    spec_ = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod

