"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<w>`` of ``workloads`` runs the configuration file of its
``config`` (``configs[...]["file"]``) under ``traffic/<w>.json``; a
per-layer metric ``<name>`` is read by ``metrics/<name>.py``, whose
``read(window)`` returns a number or ``None`` when it finds nothing to read.
A later cell, traffic mix or metric is a new file and a new entry here,
never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: str = ROOT) -> Cell:
    spec = benchmark(root)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"the cells are {sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(name, _json(os.path.join(root, conf["file"])),
                _json(os.path.join(HERE, "traffic", f"{name}.json")), int(w["chips"]),
                [m for m in spec["end_to_end"] if reports(m, name)],
                [m for m in spec["per_layer"] if reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
