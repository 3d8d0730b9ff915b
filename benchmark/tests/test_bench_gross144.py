"""The gross code's space-time configuration: its family file builds the
matrix its parameters state, and ``bp.resumed_iter_pct`` reads the staged
BP's row-iteration counters (with the two roofline copies reading as their
originals) on a hand-built window."""

import json
import os

import numpy as np
import pytest

from benchmark import codes, reference, spans, spec
from benchmark.trace import Event, Window
from benchmark.work import Work


def test_family_builds_the_stated_matrix():
    with open(os.path.join(spec.HERE, "configs", "gross144.ph12.json")) as f:
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
    # the first detector block holds hx on round 0's data: rank 66 of 72
    hx = H[:par["hx_rows"], :par["N"]]
    assert reference.FloodGraph(hx, "cpu").rank == par["hx_rank"]
    assert set(hx.sum(1).tolist()) == {6} and set(hx.sum(0).tolist()) == {3}


K1 = "void bp_flood_team_kernel<8, false>(unsigned char const*, float const*)"
K5 = "osd_large_kernel(int const*)"


def _window(counters):
    w = Window(1.0, 4, [Event(K1, 0, 4e5), Event(K5, 5e5, 1e5)],
               {"bp": Work(1e9, 0.0, 0.0), "osd": Work(2e8, 0.0, 0.0)})
    w.program = None if counters is None else spans.Program([], dict(counters))
    return w


@pytest.mark.parametrize("counters,want", [
    ({"bp.row_iters.1": 600, "bp.row_iters.2": 300, "bp.row_iters.3": 100,
      "bp.stage_rows.2": 7, "host_syncs": 3}, 40.0),
    ({"bp.row_iters.1": 512}, 0.0),
    ({"bp.stage_rows.1": 512, "host_syncs": 3}, None),  # a program without the counters
    (None, None),  # a program that recorded nothing
])
def test_resumed_iter_pct_and_the_roofline_copies(counters, want):
    w = _window(counters)
    got = spec.reader("bp.resumed_iter_pct")(w)
    assert got == (None if want is None else pytest.approx(want))
    for name in ("bp_flood_roofline", "osd_large_roofline"):
        copy = spec.reader(name + ".gross144")(w)
        assert copy == spec.reader(name)(w) and copy > 0
