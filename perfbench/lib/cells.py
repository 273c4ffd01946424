"""Cells by name: ``BENCHMARK.json`` lists them, and each part of a cell
lives in a file of its own that is found by the name it is listed under.

* ``perfbench/configs/<config>.json`` — the model configuration as run;
* ``perfbench/traffic/<traffic>.json`` — the traffic mix's parameters,
  read by the driver its ``driver`` key names,
  ``perfbench/drivers/<driver>.py``;
* ``perfbench/limits/<workload>.json`` — the limits of the numbers that
  decide the cell's ``correct``;
* ``perfbench/metrics/<metric>.py`` — a per-layer metric's reader.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries, and edits no file that is here.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

#: the checkout's root: ``BENCHMARK.json`` and ``perfbench/`` lie in it
ROOT = pathlib.Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what its names point to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the metric entries this cell reports, trace 0
    per_layer: list       # those it reports in a traced run


def benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: pathlib.Path, what: str) -> dict:
    if not path.is_file():
        raise LookupError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; LookupError
    naming what is missing."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise LookupError(f"no workload {name!r} in BENCHMARK.json: "
                          f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise LookupError(f"{name}: no configuration {w['config']!r}")
    pb = root / "perfbench"
    config = _read_json(root / configs[w["config"]]["file"],
                        f"configuration {w['config']}")
    traffic = _read_json(pb / "traffic" / f"{w['traffic']}.json",
                         f"traffic {w['traffic']}")
    limits = _read_json(pb / "limits" / f"{name}.json", f"limits of {name}")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def driver(cell: Cell, root: pathlib.Path = ROOT):
    """The module that drives the cell's traffic."""
    return _load(root / "perfbench" / "drivers" / f"{cell.traffic['driver']}.py",
                 f"perfbench_driver_{cell.traffic['driver']}")


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of the per-layer metric ``name``."""
    mod = _load(root / "perfbench" / "metrics" / f"{name}.py",
                "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def _load(path: pathlib.Path, module: str):
    if not path.is_file():
        raise LookupError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
