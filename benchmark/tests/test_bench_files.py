"""Every file the benchmark names loads, and every name, unit and entry of
``BENCHMARK.json`` keeps to the benchmark's rules."""

import json
import os

import pytest

from benchmark import spec

B = spec.benchmark()
NAMES = ([c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
         + [m["name"] for m in B["end_to_end"] + B["per_layer"]])


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"][:2] == ["python3", "benchmark/run.py"] and len(B["command"]) <= 32
    assert B["paths"] == ["benchmark"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    with open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_names(name):
    assert spec.NAME.match(name), name


def test_names_are_unique():
    for group in (B["configs"], B["workloads"], B["end_to_end"] + B["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", B["end_to_end"] + B["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert spec.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in B["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in B["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert callable(spec.reader(metric["name"]))
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in B["workloads"]}


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cells_load(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    c = spec.cell(w["name"])
    for key in ("p", "batch", "pool", "warmup_batches", "check_batches", "check_osd_rows"):
        assert key in c.traffic
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "syndromes_per_s"}
    assert c.per_layer


@pytest.mark.parametrize("conf", B["configs"], ids=lambda c: c["name"])
def test_configs_load(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("benchmark/configs/")
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        data = json.load(f)
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"] == []
    assert conf["source"].startswith("https://")


def test_every_file_is_named_by_a_name():
    for d in ("configs", "traffic", "metrics"):
        for f in os.listdir(os.path.join(spec.HERE, d)):
            if f == "__pycache__":
                continue
            stem = f.rsplit(".", 1)[0]
            assert spec.NAME.match(stem), f
            assert stem in NAMES, f"{d}/{f} is named by no entry of BENCHMARK.json"


def test_every_family_and_reference_file_is_a_configurations():
    named = {"families": set(), "references": set()}
    for conf in B["configs"]:
        with open(os.path.join(spec.ROOT, conf["file"])) as f:
            data = json.load(f)
        named["families"].add(data["code"]["family"])
        named["references"].add(data.get("reference"))
    for d, names in named.items():
        path = os.path.join(spec.HERE, d)
        for f in os.listdir(path) if os.path.isdir(path) else []:
            if f != "__pycache__":
                assert f.endswith(".py") and f[:-3] in names, f"{d}/{f} is no configuration's"
