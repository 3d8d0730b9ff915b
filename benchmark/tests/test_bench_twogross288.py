"""The two-gross code's space-time configuration: its family file builds the
matrix its parameters state, and the two readers of K1's wide plan,
``bp_flood.wide_row_pct`` and ``bp_flood_wide_roofline``, on hand-built
windows: the share, 0.0 when stages ran and no launch took the wide plan,
None without the counters or without the recorder."""

import json
import os

import numpy as np
import pytest

from benchmark import codes, reference, spans, spec
from benchmark.trace import Event, Window
from benchmark.work import Work

WIDE = "void (anonymous namespace)::bp_flood_wide_kernel<3>(unsigned char const*, float const*)"
GLOBAL = "(anonymous namespace)::bp_flood_global_kernel(unsigned char const*, float const*)"


def test_family_builds_the_stated_matrix():
    with open(os.path.join(spec.HERE, "configs", "twogross288.ph18.json")) as f:
        conf = json.load(f)
    H, proto, lift = codes.build(conf["code"])
    par = conf["parameters"]
    assert proto is None and lift is None and H.dtype == np.uint8
    assert H.shape == (par["m"], par["n"]) == ((par["rounds"] + 1) * par["hx_rows"],
                                                (par["rounds"] + 1) * par["N"]
                                                + par["rounds"] * par["hx_rows"])
    assert int(H.sum()) == par["edges"]
    assert set(H.sum(1).tolist()) == {par["row_weight"] - 1, par["row_weight"]}
    assert set(H.sum(0).tolist()) == {par["column_weight"] - 1, par["column_weight"]}
    assert reference.FloodGraph(H, "cpu").rank == par["rank"]
    hx = H[:par["hx_rows"], :par["N"]]
    assert reference.FloodGraph(hx, "cpu").rank == par["hx_rank"]
    assert par["N"] - 2 * par["hx_rank"] == par["K"]


def _window(counters, events=((WIDE, 0, 4e5), (GLOBAL, 5e5, 1e5))):
    w = Window(1.0, 4, [Event(*e) for e in events], {"bp": Work(1e9, 0.0, 0.0)})
    w.program = None if counters is None else spans.Program([], dict(counters))
    return w


STAGED = {"bp.stage_rows.1": 4096, "bp.stage_rows.2": 180, "bp.stage_rows.3": 120,
          "bp.row_iters.1": 900_000, "bp.row_iters.2": 300_000, "bp.row_iters.3": 800_000,
          "host_syncs": 3}


@pytest.mark.parametrize("counters,want", [
    (dict(STAGED, **{"bp_flood.wide_rows": 300}), 100.0 * 300 / 4396),
    (STAGED, 0.0),  # stages ran, none on the wide plan
    ({"bp.row_iters.1": 512, "host_syncs": 3}, None),  # a program without the stage counters
    (None, None),  # a program that recorded nothing
])
def test_wide_row_pct(counters, want):
    got = spec.reader("bp_flood.wide_row_pct")(_window(counters))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("counters,events,want", [
    # the bp work's least time, times the wide share of the row-iterations,
    # over the wide kernel's 0.4 s
    (dict(STAGED, **{"bp_flood.wide_row_iters": 1_100_000}), None,
     100.0 * Work(1e9, 0.0, 0.0).seconds() * 1_100_000 / 2_000_000 / 0.4),
    (dict(STAGED, **{"bp_flood.wide_row_iters": 0}), None, 0.0),  # the counter, no iterations
    (STAGED, None, None),  # a program without the counter
    (dict(STAGED, **{"bp_flood.wide_row_iters": 5}), [(GLOBAL, 0, 4e5)], None),  # no launch
    ({"bp_flood.wide_row_iters": 5}, None, None),  # no row-iteration counters
    (None, None, None),  # a program that recorded nothing
])
def test_wide_roofline(counters, events, want):
    w = _window(counters) if events is None else _window(counters, events)
    got = spec.reader("bp_flood_wide_roofline")(w)
    assert got == (None if want is None else pytest.approx(want))
