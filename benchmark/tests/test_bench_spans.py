"""The pipeline's host-glue metrics and the span-named idle gaps, on a
hand-built window of device events and program spans."""

import sys
import types

import pytest

from benchmark import spans, spec
from benchmark.trace import MARKER, Event, Window

K1 = "void bp_flood_team_kernel<3>(unsigned char const*, float const*)"
K2 = "osd_cs_warp_kernel(int const*)"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)"
T = 1_790_000_000_000_000_000  # a time.time_ns() of the span clock
BASE_US = (T - T // (spans.BASE_S * 10**9) * spans.BASE_S * 10**9) / 1e3  # T on the trace
NEW = ("pipeline.host_syncs_per_batch", "pipeline.glue_idle_pct", "pipeline.host_ms_per_batch")


def events():
    return [Event(MARKER + "(long)", 0, 1), Event(K1, 10, 100), Event(FILL, 105, 10),
            Event(K2, 130, 20), Event(MARKER + "(long)", 200, 1), Event(K1, 205, 100),
            Event(K2, 320, 30)]


# (name, start us, end us, id, parent, batch) on the trace's clock
SPANS = [
    ("decode_batch", 0, 160, 0, None, 0), ("input", 0, 8, 1, 0, 0),
    ("sync.input", 1, 8, 2, 1, 0), ("bp", 8, 118, 3, 0, 0), ("bp.stage", 9, 12, 4, 3, 0),
    ("osd", 118, 158, 5, 0, 0), ("osd.partition", 118, 126, 6, 5, 0),
    ("sync.osd_partition", 118, 126, 7, 6, 0), ("osd.kernel", 126, 130, 8, 5, 0),
    ("decode_batch", 200, 360, 9, None, 1), ("input", 200, 204, 10, 9, 1),
    ("sync.input", 200, 204, 11, 10, 1), ("bp", 204, 310, 12, 9, 1),
    ("osd", 310, 358, 13, 9, 1),
]
COUNTERS = {"host_syncs": 5, "host_syncs.input": 2, "host_syncs.osd_partition": 1,
            "host_syncs.bp_partition": 2}


def program(shift_us=0):
    """The spans on the ``time.time_ns()`` clock, ``shift_us`` off the
    trace's."""
    return spans.Program([spans.Span(n, T + round((a + shift_us) * 1000),
                                     T + round((b + shift_us) * 1000), i, p, bt)
                          for n, a, b, i, p, bt in SPANS],
                         dict(COUNTERS))


def window(prog):
    w = Window(400e-6, 2, events(), {})
    w.program = prog
    return w


@pytest.mark.parametrize("shift_us", [0, -1234.5, 7_000_000])
def test_readers(shift_us):
    w = window(program(shift_us))
    assert spec.reader("pipeline.host_syncs_per_batch")(w) == pytest.approx(2.5)
    # 320 us of decode_batch less 19 us of sync spans, over two batches
    assert spec.reader("pipeline.host_ms_per_batch")(w) == pytest.approx(0.1505)
    # idle inside the decode_batch spans: 160 - 125 and 160 - 130 us of 400
    glue = spec.reader("pipeline.glue_idle_pct")(w)
    assert glue == pytest.approx(100 * 65 / 400)
    assert glue <= spec.reader("device.idle_pct")(w) == pytest.approx(100 * 145 / 400)


def test_nothing_recorded_is_none(monkeypatch):
    w = window(None)
    for name in NEW:
        assert spec.reader(name)(w) is None, name
    # a program without the recorder: nothing to collect
    monkeypatch.setitem(sys.modules, "bp_osd_tpu_torch.utils.profiling", types.ModuleType("x"))
    w = Window(400e-6, 2, events(), {})
    for name in NEW:
        assert spec.reader(name)(w) is None, name
    assert w.program is None


def test_glue_needs_markers():
    w = Window(400e-6, 2, [e for e in events() if MARKER not in e.name], {})
    w.program = program()
    assert spec.reader("pipeline.glue_idle_pct")(w) is None
    assert spec.reader("pipeline.host_syncs_per_batch")(w) == pytest.approx(2.5)


STARTS = [0, 400, 950, 1300, 2000, 2300]  # batch starts, us: uneven, as a host runs


def long_window(lost, late_us=0.0, starts=STARTS, trace_us=0.0):
    """Six batches: a marker, K1 and K2 each, ``decode_batch`` open 160 us
    from ``late_us`` after its marker; ``lost`` markers missing from the
    start (negative: from the end; a tuple: those at these places)."""
    ev, sp = [], []
    for b, s in enumerate(starts):
        t = s + trace_us
        ev += [Event(MARKER + "(long)", t, 1), Event(K1, t + 10, 100), Event(K2, t + 130, 20)]
        a = T + round((s + late_us) * 1000) + 5_000_000_000  # the host clock: 5 s off
        sp.append(spans.Span("decode_batch", a, a + 160_000, b, None, b))
    marks = [i for i, e in enumerate(ev) if MARKER in e.name]
    gone = set([marks[i] for i in lost] if isinstance(lost, tuple) else
               marks[:lost] if lost >= 0 else marks[lost:])
    w = Window(3000e-6, len(starts), [e for i, e in enumerate(ev) if i not in gone], {})
    w.program = spans.Program(sp, {"host_syncs": 6})
    return w


@pytest.mark.parametrize("lost", [0, 1, 2, -1, -2, (3,), (1, 4)])
def test_markers_set_the_clock_with_some_lost(lost):
    w = long_window(lost)
    assert spans.clock(w, w.program)(T + 5_000_000_000 + 400_000) == pytest.approx(400)
    # each batch: 160 us open, 120 of them busy
    assert spec.reader("pipeline.glue_idle_pct")(w) == pytest.approx(100 * 6 * 40 / 3000)


def test_late_markers_shift_the_clock():
    """The markers are the device's timeline: spans opening 15 us after
    their markers read as opening with them."""
    w = long_window(0, late_us=15.0)
    assert spans.clock(w, w.program)(T + 5_000_000_000 + 15_000) == pytest.approx(0)


def test_breakdown_is_untouched_by_spans():
    plain = Window(400e-6, 2, events(), {}).breakdown()
    assert window(program()).breakdown() == plain
    assert spans.named_gaps(window(None), None) == pytest.approx(dict(plain["idle_gaps"]))


@pytest.mark.parametrize("shift_us", [0, 55.25])
def test_named_gaps_split_by_span(shift_us):
    w = window(program(shift_us))
    got = spans.named_gaps(w, w.program)
    want = {"decode_batch/input/sync.input": 10, "decode_batch/bp": 10,
            "decode_batch/bp/bp.stage": 1,
            "decode_batch/osd/osd.partition/sync.osd_partition": 8,
            "decode_batch/osd/osd.kernel": 4, "decode_batch/osd": 18, "decode_batch": 2,
            "between batches (harness: sync, clock, next submit)": 40}
    assert got == pytest.approx({k: v / 1e6 for k, v in want.items()})
    plain = dict(w.breakdown()["idle_gaps"])
    assert sum(got.values()) == pytest.approx(sum(plain.values()))


@pytest.mark.parametrize("lost", [(2,), (0, 3), -1])
@pytest.mark.parametrize("stray_us", [0.0, 180.0, -260.0])
def test_even_batches_take_their_own_marker(lost, stray_us):
    """Batches 2 ms apart fit a neighbour's marker as well as their own;
    the trace's base, off by less than a quarter of that, picks each one's."""
    starts = [2000 * i for i in range(8)]
    at = BASE_US + 5_000_000 + stray_us  # the spans' own trace time, off by stray_us
    w = long_window(lost, starts=starts, trace_us=at)
    to_us = spans.clock(w, w.program)
    assert to_us(T + 5_000_000_000 + 4_000_000) == pytest.approx(at + 4000)
    assert spec.reader("pipeline.glue_idle_pct")(w) == pytest.approx(100 * 8 * 40 / 3000)

