"""The reduction of a traced window to the per-layer metrics, on a synthetic
list of device events."""

import pytest

from benchmark import spec
from benchmark.trace import MARKER, Event, Window, busy_us, short_name
from benchmark.work import Work

K1 = "void bp_flood_team_kernel<3>(unsigned char const*, float const*)"
K2 = "osd_cs_warp_kernel(int const*)"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)"


def window(work=None):
    ev = [Event(MARKER + "(long)", 0, 1), Event(K1, 10, 100), Event(FILL, 105, 10),
          Event(K2, 130, 20), Event(MARKER + "(long)", 200, 1), Event(K1, 205, 100),
          Event(K2, 320, 30)]
    return Window(400e-6, 2, ev, work if work is not None else
                  {"bp": Work(0, 0, 1e6), "osd": Work(3.35e12 * 5e-6)})


def test_busy_is_the_union():
    w = window()
    assert busy_us(w.events) == pytest.approx(105 + 20 + 100 + 30)  # K1 and the fill overlap
    assert w.busy_s == pytest.approx(255e-6)
    assert len(w.events) == 5  # markers are not the program's


def test_readers():
    w = window()
    assert spec.reader("pipeline.launches_per_batch")(w) == pytest.approx(2.5)
    assert spec.reader("device.idle_pct")(w) == pytest.approx(100 * (1 - 255 / 400))
    osd = spec.reader("osd_cs_roofline")(w)
    assert osd == pytest.approx(100 * 5e-6 / 50e-6)
    assert spec.reader("osd_large_roofline")(w) is None  # no K5 in the window
    assert spec.reader("bp_lifted_roofline")(w) is None
    assert spec.reader("bp_flood_roofline")(w) == pytest.approx(
        100 * Work(0, 0, 1e6).seconds() / 200e-6)
    assert spec.reader("step_mfu")(w) == pytest.approx(
        100 * Work(3.35e12 * 5e-6, 0, 1e6).seconds() / 400e-6)


def test_nothing_to_read_is_none():
    w = Window(1.0, 3, [], {})
    for m in spec.benchmark()["per_layer"]:
        assert spec.reader(m["name"])(w) is None, m["name"]


def test_breakdown():
    b = window().breakdown()
    assert b["device_ops"][0] == ["bp_flood_team_kernel<3>", pytest.approx(200e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["between batches (harness: sync, clock, next submit)"] == pytest.approx(50e-6)
    assert gaps["decode_batch entry, before bp_flood_team_kernel<3>"] == pytest.approx(13e-6)
    assert gaps["in decode_batch: bp_flood_team_kernel<3> -> osd_cs_warp_kernel"] == \
        pytest.approx(15e-6)
    fill = short_name(FILL)
    assert gaps[f"in decode_batch: {fill} -> osd_cs_warp_kernel"] == pytest.approx(15e-6)
    assert all(len(v) <= 10 for v in b.values())


def test_short_name():
    assert short_name(FILL) == ("at::native::vectorized_elementwise_kernel<4, "
                                "at::native::FillFunctor<float>>")
