"""``osd_large.cluster_row_pct`` reads the rows K5's cluster plan took over
every row K5 decoded from the program's counters, on a hand-built window:
the share, 0.0 when K5 ran and no launch took the cluster plan, None when
K5 did not run, without its counters or without the recorder."""

import pytest

from benchmark import spans, spec
from benchmark.trace import Event, Window
from benchmark.work import Work

K5 = "void (anonymous namespace)::osd_large_kernel<5, true>(int const*, int const*)"


def _window(counters):
    w = Window(1.0, 4, [Event(K5, 0, 4e5)], {"osd": Work(1e9, 0.0, 0.0)})
    w.program = None if counters is None else spans.Program([], dict(counters))
    return w


@pytest.mark.parametrize("counters,want", [
    ({"osd_large.rows": 3, "osd_large.cluster_rows": 3, "osd.rows": 3}, 100.0),
    ({"osd_large.rows": 145, "osd_large.cluster_rows": 16}, 100.0 * 16 / 145),
    ({"osd_large.rows": 129, "osd.rows": 129, "host_syncs": 4}, 0.0),  # none engaged
    ({"osd.rows": 0, "host_syncs": 3}, None),  # K5 did not run
    ({"osd.rows": 96, "bp.stage_rows.1": 4096}, None),  # a program without K5's counters
    (None, None),  # a program that recorded nothing
])
def test_cluster_row_pct(counters, want):
    got = spec.reader("osd_large.cluster_row_pct")(_window(counters))
    assert got == (None if want is None else pytest.approx(want))
