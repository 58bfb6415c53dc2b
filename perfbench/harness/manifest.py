"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration and a traffic mix; each piece lives in a file
of its own, so that a later change adds a cell, a mix or a metric as new
files and entries and edits none:

- the configuration: the `file` of its entry under `configs`
  (`perfbench/configs/<name>.json`);
- the traffic mix: `perfbench/traffic/<traffic>.json`, whose `generator`
  names a module `perfbench/gen/<generator>.py` with `make(...)`;
- a per-layer metric: `perfbench/metrics/<metric name>.py`, with
  `read(record)`;
- the cell's limits on the numbers that decide `correct`:
  `perfbench/limits/<cell name>.json`.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # number -> limit
    end_to_end: list  # metric entries every cell reports with --trace 0
    per_layer: list  # metric entries every cell reports with --trace 1


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(name: str, root: str = ROOT) -> Cell:
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    bench = os.path.join(root, "perfbench")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(os.path.join(root, configs[w["config"]]["file"])),
        traffic=load_json(os.path.join(bench, "traffic", f"{w['traffic']}.json")),
        limits=load_json(os.path.join(bench, "limits", f"{name}.json")),
        end_to_end=m["end_to_end"],
        per_layer=m["per_layer"],
    )


def generator(traffic: dict):
    """The module `perfbench/gen/<traffic["generator"]>.py`."""
    return importlib.import_module(f"perfbench.gen.{traffic['generator']}")


def metric_reader(name: str, root: str = ROOT):
    """`read(record)` of `perfbench/metrics/<name>.py`."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
