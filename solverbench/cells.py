"""Cells, found by name: `BENCHMARK.json` at the root of the checkout
names each cell's configuration and traffic mix; their data sit in files
of their own.

* a configuration: the `file` its entry in BENCHMARK.json names;
* a traffic mix: `traffic/<name>.json`;
* the limits of a cell's correctness check: `limits/<cell>.json`;
* a metric: `metrics/<name>.py`, a reader with `read(run) -> float | None`.

A later cell, configuration, mix or metric is added as files and entries,
without an edit here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: the BENCHMARK.json entries of the metrics this cell reports
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    """Does `cell` report the end-to-end `metric`: a cell of its
    `workloads` list, every cell where it has none."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of the dict `bench`)."""
    if bench is None:
        bench = json.loads(BENCHMARK.read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has: {', '.join(sorted(work))})")
    w = work[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    # a per-layer metric names the cells that report it
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "solverbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
