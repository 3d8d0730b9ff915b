"""bp.resumed_iter_pct: the row-iterations that the staged BP ran in its
resumed stages (2 and up) over all it ran, in %, from the program's device
counters ``bp.row_iters.<i>`` (the iterations the rows of stage ``i`` ran
there, added by K1 as each row finishes); None when the program records no
such counter (benchmark/spans.py)."""

from benchmark import spans

PREFIX = "bp.row_iters."


def read(window):
    prog = spans.of(window)
    if prog is None:
        return None
    by_stage = {int(k[len(PREFIX):]): v for k, v in prog.counters.items()
                if k.startswith(PREFIX) and k[len(PREFIX):].isdigit()}
    total = sum(by_stage.values())
    if total <= 0:
        return None
    return 100.0 * sum(v for i, v in by_stage.items() if i >= 2) / total
