"""pipeline.glue_idle_pct: the share of the traced window in which no
kernel, copy or set ran on the device while a ``decode_batch`` span of the
program was open, in %: the idle the program's host glue leaves, the part of
``device.idle_pct`` inside the decode (the rest is the harness's, between
batches); None when the program records no spans (benchmark/spans.py)."""

from benchmark import spans


def read(window):
    prog = spans.of(window)
    if prog is None or window.window_s <= 0:
        return None
    idle = spans.glue_idle_s(window, prog)
    return None if idle is None else 100.0 * idle / window.window_s
