"""The program's spans and counters over the traced window, and what the
per-layer metrics of the pipeline's host glue read from them.

While ``torch.profiler`` records the traced window, the program's recorder
(``bp_osd_tpu_torch.utils.profiling``) records too: each ``decode_batch``
call is a root span with the pipeline's phases below it, and each place
where the host waits for the card is a leaf span ``sync.<site>``, counted in
the counter ``host_syncs``.  :func:`of` collects them once a window, after
the window has closed, and keeps them on the window as ``window.program``;
it is None for a program without the recorder, and then every reader here
gives None.

Span times are ``time.time_ns()``, device events the trace's microseconds.
The trace's device clock strays from the host's by 0.1-0.3 ms from one
trace to the next, and by milliseconds at times (an H100, torch 2.11), so
:func:`clock` anchors the spans on the device's own timeline by the
window's markers: each batch's marker kernel starts on an idle card just
before its ``decode_batch`` opens (some 10-30 us before, on an H100), and
the median over the window's batches of marker start minus span start is
the offset.  A trace may lose a marker anywhere in the window, and batches
may follow each other so evenly that a span fits a neighbour's marker as
well as its own: the host clock (the trace's ``baseTimeNanoseconds``,
which ``benchmark/trace.py`` does not keep, set by libkineto's rule) picks
each span's marker first.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import NamedTuple

from .trace import MARKER, short_name

ROOT = "decode_batch"
SYNC = "sync."
LOST = 2  # markers a trace may lose before its first batch's, or after its last's
BASE_S = 7_889_238  # a trace's ts counts from the start of such an interval (libkineto)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    batch: int


class Program(NamedTuple):
    spans: list
    counters: dict


def _collect():
    try:
        from bp_osd_tpu_torch.utils.profiling import collect
    except ImportError:  # a program without the recorder
        return None
    rec = collect()
    if not rec.spans:
        return None
    return Program([Span(s.name, s.start_ns, s.end_ns, s.id, s.parent, s.batch)
                    for s in rec.spans], dict(rec.counters))


def of(window):
    """The program's spans and counters of ``window``, collected at the
    first call; None when it recorded none."""
    if not hasattr(window, "program"):
        window.program = _collect()
    return window.program


def roots(prog: Program) -> list:
    """The ``decode_batch`` spans, in start order."""
    return sorted((s for s in prog.spans if s.name == ROOT and s.parent is None),
                  key=lambda s: s.start_ns)


def _nearest(marks: list, x: float) -> float:
    i = bisect.bisect_left(marks, x)
    return min((marks[j] for j in (i - 1, i) if 0 <= j < len(marks)), key=lambda m: abs(m - x))


def clock(window, prog: Program):
    """A function from a span time (ns) to the trace's microseconds, or
    None: the median distance from each ``decode_batch`` start to its
    nearest marker, for the first guess that puts the most starts within a
    quarter of the markers' median spacing of one.  The guesses, in turn:
    the trace's base (:data:`BASE_S`), then the first span on each of the
    first :data:`LOST` + 1 markers, then the last span on each of the
    last."""
    rs = roots(prog)
    marks = sorted(e.start_us for e in window.all_events if MARKER in e.name)
    if not rs or not marks:
        return None
    t0 = rs[0].start_ns
    xs = [(r.start_ns - t0) / 1e3 for r in rs]
    tol = (statistics.median(b - a for a, b in zip(marks, marks[1:])) / 4
           if len(marks) > 1 else float("inf"))
    base = t0 // (BASE_S * 10**9) * BASE_S * 10**9
    guesses = ([(t0 - base) / 1e3] + [m - xs[0] for m in marks[:LOST + 1]]
               + [m - xs[-1] for m in reversed(marks[-LOST - 1:])])
    best = []
    for c in guesses:
        d = []
        for x in xs:
            n = _nearest(marks, x + c)
            if abs(n - x - c) < tol:
                d.append(n - x)
        if len(d) > len(best):
            best = d
    if not best:
        return None
    off = statistics.median(best)
    return lambda ns: (ns - t0) / 1e3 + off


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def glue_idle_s(window, prog: Program):
    """Seconds in which the device ran none of the program's events while
    a ``decode_batch`` span was open; None without a clock."""
    to_us = clock(window, prog)
    if to_us is None:
        return None
    open_ = _union((to_us(r.start_ns), to_us(r.end_ns)) for r in roots(prog))
    busy = _union((e.start_us, e.start_us + e.dur_us) for e in window.events)
    inside = sum(e - s for s, e in open_)
    return (inside - _overlap(open_, busy)) / 1e6


def host_s(prog: Program) -> float:
    """Seconds of ``decode_batch`` spans less the part their ``sync.*``
    spans cover: the host's own work."""
    rs = roots(prog)
    batches = {r.batch for r in rs}
    synced = sum(s.end_ns - s.start_ns for s in prog.spans
                 if s.name.startswith(SYNC) and s.batch in batches)
    return (sum(r.end_ns - r.start_ns for r in rs) - synced) / 1e9


def _paths(prog: Program) -> dict:
    by_id = {s.id: s for s in prog.spans}
    paths = {}

    def path(s):
        if s.id not in paths:
            up = by_id.get(s.parent)
            paths[s.id] = s.name if up is None else path(up) + "/" + s.name
        return paths[s.id]

    for s in prog.spans:
        path(s)
    return paths


def _innermost(prog: Program, to_us) -> list:
    """``(start_us, end_us, path)`` pieces of the spans' intervals, each
    labelled by the innermost span open over it, in start order."""
    paths = _paths(prog)
    kids = defaultdict(list)
    for s in prog.spans:
        kids[s.parent].append(s)
    pieces = []
    for s in prog.spans:
        cur = to_us(s.start_ns)
        for k in sorted(kids[s.id], key=lambda k: k.start_ns):
            ks = to_us(k.start_ns)
            if ks > cur:
                pieces.append((cur, ks, paths[s.id]))
            cur = max(cur, to_us(k.end_ns))
        end = to_us(s.end_ns)
        if end > cur:
            pieces.append((cur, end, paths[s.id]))
    pieces.sort()
    return pieces


def _gaps(window) -> list:
    """The idle gaps of ``Window.breakdown``: ``(start_us, end_us, label)``."""
    out = []
    prev, end = None, float("-inf")
    for e in window.all_events:
        if prev is not None and e.start_us > end:
            if MARKER in e.name:
                label = "between batches (harness: sync, clock, next submit)"
            elif MARKER in prev.name:
                label = "decode_batch entry, before " + short_name(e.name)
            else:
                label = f"in decode_batch: {short_name(prev.name)} -> {short_name(e.name)}"
            out.append((end, e.start_us, label[:160]))
        if e.start_us + e.dur_us > end:
            end = e.start_us + e.dur_us
            prev = e
    return out


def named_gaps(window, prog: Program | None) -> dict:
    """Seconds of idle gap by label: the gaps of ``Window.breakdown``, each
    split over the innermost program spans open during it by the time each
    covers (labelled with the span's path, e.g. ``decode_batch/osd/
    osd.partition/sync.osd_partition``), the rest under its kernel-pair
    label.  The gaps and their total are those of ``Window.breakdown``."""
    to_us = clock(window, prog) if prog is not None else None
    pieces = _innermost(prog, to_us) if to_us is not None else []
    starts = [p[0] for p in pieces]
    out = defaultdict(float)
    for a, b, label in _gaps(window):
        cur = a
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(pieces) and pieces[i][0] < b:
            lo, hi = max(pieces[i][0], cur), min(pieces[i][1], b)
            if hi > lo:
                if lo > cur:
                    out[label] += (lo - cur) / 1e6
                out[pieces[i][2]] += (hi - lo) / 1e6
                cur = hi
            i += 1
        if b > cur:
            out[label] += (b - cur) / 1e6
    return dict(out)
