"""pipeline.host_syncs_per_batch: the program's counter ``host_syncs`` over
the traced window's batches: the places a batch's host waits for the card
(the input check, the prior's copy, each read of a failure count, the copy
of OSD's pairs table), each a leaf span ``sync.<site>``; None when the
program records no spans (benchmark/spans.py)."""

from benchmark import spans


def read(window):
    prog = spans.of(window)
    if prog is None or window.batches <= 0:
        return None
    return prog.counters.get("host_syncs", 0) / window.batches
