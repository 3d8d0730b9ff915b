"""osd_large.cluster_row_pct: the rows that K5's cluster plan took over all
rows K5 decoded, in %, from the program's counters: ``osd_large.rows``
(each launch of ``ops/cuda_osd_large.py:osd_large`` adds its rows) and
``osd_large.cluster_rows`` (those of the launches in the cluster plan);
0.0 when K5 ran and no launch took the cluster plan, None when K5 did not
run or the program records no such counter (benchmark/spans.py)."""

from benchmark import spans


def read(window):
    prog = spans.of(window)
    if prog is None:
        return None
    rows = prog.counters.get("osd_large.rows", 0)
    if rows <= 0:
        return None
    return 100.0 * prog.counters.get("osd_large.cluster_rows", 0) / rows
