"""Finds a cell's parts by name: the cell in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, whose `driver` names the general loop in
`drivers/`), the metrics it reports, and each per-layer metric's reader
(`metrics/<name>.py`, a module with `read(rec) -> float | None`).

A later change adds a cell, a configuration, a mix or a metric as files
of its own; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import NamedTuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: str = REPO) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json under {root}")
    with open(path) as f:
        return json.load(f)


def _json(kind: str, name: str, bench: str = BENCH) -> dict:
    path = os.path.join(bench, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """A metric without `workloads` is reported by every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = REPO, bench: str = BENCH) -> Cell:
    spec = load_benchmark(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in spec['workloads']]}")
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]]
    if not conf:
        raise KeyError(f"workload {name!r}: no config {w['config']!r}")
    config = _json("configs", w["config"], bench)
    traffic = _json("traffic", w["traffic"], bench)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if reports(m, name)])


def driver(traffic: dict):
    """The general loop a mix names (`drivers/<driver>.py`)."""
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def metric_reader(name: str, bench: str = BENCH):
    """`metrics/<name>.py` as a module (names may hold dots)."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"per-layer metric {name!r}: no reader "
                                f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(metrics: list, rec: dict, bench: str = BENCH) -> dict:
    """{name: {"value", "unit"}} for every per-layer metric whose reader
    finds something in `rec`; a reader that finds nothing returns None
    and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], bench).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
