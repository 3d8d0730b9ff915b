"""bp_flood.wide_row_pct: the rows that K1's wide plan took over the rows of
every staged BP launch, in %, from the program's counters:
``bp_flood.wide_rows`` (each launch of ``ops/cuda_bp.py:bp_flood`` in the
wide plan adds its rows) over the sum of ``bp.stage_rows.<i>`` (the rows of
stage ``i``); 0.0 when stages ran and no launch took the wide plan, None
when the program records no stage counter (benchmark/spans.py)."""

from benchmark import spans

PREFIX = "bp.stage_rows."


def read(window):
    prog = spans.of(window)
    if prog is None:
        return None
    rows = sum(v for k, v in prog.counters.items()
               if k.startswith(PREFIX) and k[len(PREFIX):].isdigit())
    if rows <= 0:
        return None
    return 100.0 * prog.counters.get("bp_flood.wide_rows", 0) / rows
