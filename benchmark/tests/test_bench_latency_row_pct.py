"""``bp_flood.latency_row_pct`` reads K1's latency-plan rows over the rows of
every staged BP launch from the program's counters, on a hand-built window:
None without the recorder or without the stage counters, 0.0 when stages ran
and no launch took the latency plan, the share otherwise."""

import pytest

from benchmark import spans, spec
from benchmark.trace import Event, Window
from benchmark.work import Work

K1 = "void bp_flood_team_kernel<8, false>(unsigned char const*, float const*)"


def _window(counters):
    w = Window(1.0, 4, [Event(K1, 0, 4e5)], {"bp": Work(1e9, 0.0, 0.0)})
    w.program = None if counters is None else spans.Program([], dict(counters))
    return w


@pytest.mark.parametrize("counters,want", [
    ({"bp.stage_rows.1": 4096, "bp.stage_rows.2": 180, "bp.stage_rows.3": 120,
      "bp_flood.latency_rows": 300, "host_syncs": 3}, 100.0 * 300 / 4396),
    ({"bp.stage_rows.1": 16384, "bp.stage_rows.2": 4200, "host_syncs": 6}, 0.0),  # none engaged
    ({"bp.row_iters.1": 512, "host_syncs": 3}, None),  # a program without the stage counters
    (None, None),  # a program that recorded nothing
])
def test_latency_row_pct(counters, want):
    got = spec.reader("bp_flood.latency_row_pct")(_window(counters))
    assert got == (None if want is None else pytest.approx(want))
