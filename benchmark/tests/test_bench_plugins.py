"""A configuration brings its own code construction (``families/<family>.py``)
and its own reference (``references/<name>.py``) as new files: in a
temporary root that holds the benchmark's files and such a configuration, a
run on the CPU builds the code from the family file and is checked by the
reference file; the default reference refuses every decoder option it does
not compute before anything is built."""

import json
import os
import re
import shutil
import sys
import time

import numpy as np
import pytest

from benchmark import cell, codes, control, reference, spec, traffic

# the [[72,12,6]] bivariate bicycle code of Bravyi et al., arXiv:2308.07915:
# l = m = 6, A = x^3 + y + y^2, B = y^3 + x + x^2
BB72 = {"family": "bivariate_bicycle", "l": 6, "m": 6,
        "A": [[3, 0], [0, 1], [0, 2]], "B": [[0, 3], [1, 0], [2, 0]]}
FAMILY = '''"""Bivariate bicycle codes: hx = [A | B], A and B sums of monomials
x^a y^b, x = S_l (x) I_m and y = I_l (x) S_m, S_k the cyclic shift."""

import numpy as np


def _monomial(a, b, l, m):
    x = np.roll(np.eye(l, dtype=np.uint8), a, axis=1)
    y = np.roll(np.eye(m, dtype=np.uint8), b, axis=1)
    return np.kron(x, y)


def build(code):
    l, m = int(code["l"]), int(code["m"])
    A, B = (sum(_monomial(a, b, l, m) for a, b in code[k]) % 2 for k in ("A", "B"))
    return np.hstack([A, B]).astype(np.uint8), None, None
'''
DECODER = {"bp_method": "minimum_sum", "ms_scaling_factor": 0.0, "max_iter": 0,
           "osd_method": "osd_cs", "osd_order": 7}
CELL = "bb72.p06.b48"
TRAFFIC = {"p": 0.06, "batch": 48, "pool": 3, "warmup_batches": 1, "check_batches": 2,
           "check_osd_rows": 12}
# a copy of the reference whose osd_cs flips one bit of its first osdw
FLIP = '''

_osd_cs = osd_cs


def osd_cs(g, synd, llr, decoder):
    o = _osd_cs(g, synd, llr, decoder)
    osdw = o.osdw.clone()
    if osdw.numel():
        osdw[0, 0] ^= 1
    return o._replace(osdw=osdw)
'''


def _root(tmp_path, reference_file=None):
    """A root with the benchmark's files and the [[72,12,6]] configuration
    and cell, its family file, and ``reference_file`` (name, source) if
    given; returns the cell."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    home = tmp_path / "benchmark"
    (home / "families").mkdir(exist_ok=True)
    (home / "families" / "bivariate_bicycle.py").write_text(FAMILY)
    conf = {"name": "bb72", "code": BB72, "decoder": DECODER, "reduced": []}
    if reference_file is not None:
        name, source = reference_file
        conf["reference"] = name
        (home / "references").mkdir(exist_ok=True)
        (home / "references" / f"{name}.py").write_text(source)
    (home / "configs" / "bb72.json").write_text(json.dumps(conf))
    (home / "traffic" / f"{CELL}.json").write_text(json.dumps(TRAFFIC))
    b = spec.benchmark()
    b["configs"].append({"name": "bb72", "source": "https://arxiv.org/abs/2308.07915",
                         "file": "benchmark/configs/bb72.json", "reduced": [],
                         "why": "a bivariate bicycle code"})
    b["workloads"].append({"name": CELL, "config": "bb72", "traffic": CELL, "chips": 1,
                           "why": "the family and reference files of a configuration"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return spec.cell(CELL, root=str(tmp_path))


def _run(c, seed=2**31 + 11):
    return cell.run(c.name, seed, 0.2, False, t_start=time.perf_counter(), device="cpu",
                    cell=c)


def _source():
    with open(reference.__file__) as f:
        return f.read()


def test_a_family_file_builds_the_code(tmp_path):
    c = _root(tmp_path)
    H, proto, lift = codes.build(c.config["code"], c.home)
    assert proto is None and lift is None
    assert H.shape == (36, 72) and H.dtype == np.uint8
    assert (H.sum(1) == 6).all() and (H.sum(0) == 3).all()
    assert reference.FloodGraph(H, "cpu").rank == 30  # k = 72 - 2 * 30 = 12


def test_a_family_file_runs_end_to_end(tmp_path):
    out = _run(_root(tmp_path))
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["osd_rows_checked"]["value"] >= 1


def test_a_missing_family_file_names_its_path(tmp_path):
    home = str(tmp_path / "benchmark")
    path = os.path.join(home, "families", "no_such.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        codes.build({"family": "no_such"}, home)
    with pytest.raises(ValueError, match="not a benchmark name"):
        codes.build({"family": "../codes"}, home)


@pytest.mark.parametrize("name,source,correct", [("copy", "", True), ("flipped", FLIP, False)],
                         ids=["copy", "flipped"])
def test_the_configurations_reference_checks_the_run(tmp_path, name, source, correct):
    c = _root(tmp_path, (name, _source() + source))
    out = _run(c)
    assert out["correct"] is correct
    assert (out["checks"]["osd_rows_differ"]["value"] == 0) is correct
    assert sys.modules[f"benchmark_references_{name}"].__file__ == os.path.join(
        c.home, "references", f"{name}.py")


def test_the_control_takes_the_configurations_reference(tmp_path):
    refuse = '\n\ndef supports(decoder):\n    return "this copy refuses every decoder"\n'
    c = _root(tmp_path, ("refusing", _source() + refuse))
    with pytest.raises(SystemExit, match="this copy refuses every decoder"):
        control.control(c.name, 1, device="cpu", cell=c)


@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_cells_take_the_default_reference(name):
    assert spec.reference(spec.cell(name)) is reference


@pytest.mark.parametrize("key,value", [
    ("bp_method", "product_sum"), ("bp_method", "ps"), ("schedule", "serial"),
    ("schedule", "layered"), ("osd_method", "osd_e"), ("osd_method", "osd0"),
    ("osd_method", "osd_0"), ("bp_method", "no_such"), ("input_vector_type", "received_vector"),
    ("osd_order", None)])
def test_the_default_reference_refuses_before_anything_is_built(key, value, monkeypatch):
    c = spec.cell("hgp400.p05.b16384")
    dec = dict(c.config["decoder"], **{key: value})
    if value is None:
        del dec[key]
    c = c._replace(config=dict(c.config, decoder=dec))
    assert reference.supports(dec) is not None

    def built(*args, **kw):
        raise AssertionError("built before the reference was asked")

    for mod, fn in ((cell, "build_program"), (traffic, "make_pool"), (codes, "build")):
        monkeypatch.setattr(mod, fn, built)
    with pytest.raises(SystemExit, match=key):
        _run(c)
    with pytest.raises(SystemExit, match=key):
        control.control(c.name, 1, device="cpu", cell=c)


@pytest.mark.parametrize("change", [
    {}, {"bp_method": "ms"}, {"bp_method": "MIN_SUM"}, {"osd_method": "osdcs"},
    {"schedule": "parallel"}, {"osd_order": 0}])
def test_the_default_reference_takes_the_programs_names(change):
    assert reference.supports(dict(DECODER, **change)) is None
