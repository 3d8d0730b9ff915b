"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<w>`` of ``workloads`` runs the configuration file of its
``config`` (``configs[...]["file"]``) under ``traffic/<w>.json``; a
per-layer metric ``<name>`` is read by ``metrics/<name>.py``, whose
``read(window)`` returns a number or ``None`` when it finds nothing to read.
A later cell, traffic mix, metric or configuration is a new file and a new
entry here, never an edit.

A configuration brings what the benchmark does not have as files of its own:

- its code: a ``code`` entry whose ``family`` is not one that
  :mod:`.codes` builds names ``families/<family>.py``, plain NumPy that
  imports nothing of the program or of JAX, whose ``build(code: dict)`` returns
  ``(hx [m, n] uint8, proto or None, lift or None)``: the matrix the program
  and the reference both get, and a protograph and lift for lifted BP;
- its reference: a ``"reference": "<name>"`` key names
  ``references/<name>.py`` in place of :mod:`.reference`, a copy in plain
  torch that imports nothing of the program or of JAX.  The check calls only these of
  it: ``supports(decoder) -> str | None`` (the reason it cannot check the
  configuration's ``decoder``, or ``None``), ``FloodGraph(H, device)`` (with
  ``n``, ``rank``), ``LiftedGraph(proto, lift, device)``, ``prior(p, n)``,
  ``flood_bp`` and ``lifted_bp`` ``(graph, synd, llr0, decoder, dtype=...)``
  (BP results ``hard``, ``llr``, ``converged``, ``iterations``),
  ``osd_cs(graph, synd, llr, decoder)`` (the decoder's OSD: ``osd0``,
  ``osdw`` and each row's ``elim_ops``) and ``syndromes_of(graph, x)``.
  ``decoder`` is the configuration's whole ``decoder`` entry, as the program
  gets it.  A run and the control refuse a configuration whose reference
  does not support its decoder before they build the program or the pool.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
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
    home: str = HERE  # the benchmark's directory: families/, references/, metrics/


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
    home = os.path.join(root, os.path.basename(HERE))
    return Cell(name, _json(os.path.join(root, conf["file"])),
                _json(os.path.join(home, "traffic", f"{name}.json")), int(w["chips"]),
                [m for m in spec["end_to_end"] if reports(m, name)],
                [m for m in spec["per_layer"] if reports(m, name)], home)


def load(home: str, kind: str, name: str):
    """The module ``<home>/<kind>/<name>.py``, loaded by path; a name that is
    no benchmark name, or a file that is not there, raises."""
    if not NAME.match(name):
        raise ValueError(f"{kind}/{name!r}: not a benchmark name")
    path = os.path.join(home, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_spec.name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, home: str = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load(home, "metrics", metric).read


def reference(c: Cell):
    """The reference that checks cell ``c``: ``references/<name>.py`` where
    the configuration names one, else :mod:`.reference`.  Raises
    ``SystemExit`` with the reference's reason where it does not support the
    configuration's decoder."""
    name = c.config.get("reference")
    ref = (load(c.home, "references", name) if name is not None
           else importlib.import_module(f"{__package__}.reference"))
    why = ref.supports(c.config["decoder"])
    if why is not None:
        raise SystemExit(f"{c.name}: the reference {name or 'reference.py'} cannot check "
                         f"this configuration's decoder: {why}")
    return ref
