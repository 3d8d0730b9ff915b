"""pipeline.host_ms_per_batch: the program's ``decode_batch`` span time less
the part its ``sync.*`` spans cover (the host waiting for the card), over
the traced window's batches, in ms: the host's own work a batch (Python,
checks, enqueues); None when the program records no spans
(benchmark/spans.py)."""

from benchmark import spans


def read(window):
    prog = spans.of(window)
    if prog is None or window.batches <= 0:
        return None
    return 1e3 * spans.host_s(prog) / window.batches
