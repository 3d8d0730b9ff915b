"""Profiling and timing helpers, and the program's span and counter recorder.

Port of ``bp_osd_tpu/utils/profiling.py`` over ``torch.profiler``: a trace
of the enclosed block (CPU activity, and CUDA activity when a card is
present) exported as a Chrome trace, viewable in Perfetto or
``chrome://tracing``.

The recorder keeps the decode path's phases as spans and its host-side
counts as counters, in memory until :func:`collect` returns and clears
them.  It records between :func:`enable` and :func:`disable`, inside
:func:`trace`, and while a ``torch.profiler`` session records on this
process, so a trace taken from outside the program can be read beside the
program's phases.  Otherwise :func:`span` returns one shared no-op context
and :func:`count` returns at once.

A span holds its name, its start and end as ``time.time_ns()`` (the host
clock of a ``torch.profiler`` Chrome trace: its ``ts`` plus its
``baseTimeNanoseconds``), the span open around it on the same thread, the
batch id of its root span (one ``decode_batch`` call) and a few
attributes.  A span ``sync.<site>`` (:func:`sync`) is a leaf around a place
where the host waits for the card (a read of a device value, a copy of a
host array to the card); each one counts in ``host_syncs`` and
``host_syncs.<site>``.  The kernel wrappers count their launches while the
recorder is on as ``launches.<wrapper>``.  A kernel counts on the card into
a :func:`device_counter`, which :func:`collect` reads once into the
counters, outside any batch.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _torch_profiler

__all__ = ["Record", "Span", "Timer", "block", "collect", "count", "device_counter", "disable",
           "enable", "span", "sync", "trace"]

# one lock for every count: the launch counts of the kernel wrappers
# (``ops.count_launch``) and the recorder's counters; shards on several
# cards launch from several threads, and ``+= 1`` is not atomic
COUNT_LOCK = threading.Lock()

_on = False  # enable() / disable()
_counts: collections.Counter = collections.Counter()
_device_counts: dict = {}  # (names, device) -> int64 tensor the kernels add to
_buffers: list = []  # (thread, its event buffer)
_local = threading.local()
_ids = itertools.count()
_batches = itertools.count()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    id: int
    parent: int | None  # id of the span open around it on its thread
    batch: int  # id shared by the spans under one root
    tid: int  # native thread id
    attrs: dict


class Record(NamedTuple):
    spans: list  # closed spans, each root after its descendants
    counters: dict  # name -> count


def enable() -> None:
    """Record spans and counts until :func:`disable`."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


def _buffer() -> list:
    """This thread's event buffer: ``(name, attrs, start)`` opens a span,
    an int (its end) closes the innermost open one."""
    try:
        return _local.buf
    except AttributeError:
        buf = _local.buf = []
        with COUNT_LOCK:
            _buffers.append((threading.current_thread(), buf))
        return buf


class _Open:
    __slots__ = ("buf", "attrs", "name")

    def __init__(self, name: str, attrs: dict):
        self.buf, self.attrs, self.name = _buffer(), attrs, name

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.buf.append((self.name, self.attrs, time.time_ns()))
        return self

    def __exit__(self, *exc):
        self.buf.append(time.time_ns())
        return False


def span(name: str, **attrs):
    """A context that records the span ``name`` with ``attrs`` around its
    block; the shared no-op when the recorder is off."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return _NOOP
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when the recorder is on."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return
    with COUNT_LOCK:
        _counts[name] += int(n)


def device_counter(names: tuple, device):
    """While the recorder is on: an int64 tensor on ``device``, a slot for
    each of ``names``, that kernels add their counts to, the same one until
    :func:`collect` reads it into the counters ``names``; None when the
    recorder is off, so a kernel given it does no atomics."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return None
    key = (tuple(names), torch.device(device))
    with COUNT_LOCK:
        buf = _device_counts.get(key)
        if buf is None:
            buf = _device_counts[key] = torch.zeros(len(names), dtype=torch.int64,
                                                    device=device)
    return buf


def sync(site: str):
    """The leaf span ``sync.<site>`` around a place where the host waits for
    the card, counted in ``host_syncs`` and ``host_syncs.<site>``."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return _NOOP
    with COUNT_LOCK:
        _counts["host_syncs"] += 1
        _counts["host_syncs." + site] += 1
    return _Open("sync." + site, {})


def _closed(tid: int, buf: list, out: list) -> None:
    """Move the spans of ``buf``'s whole closed trees into ``out``; a tree
    still open stays in ``buf``."""
    depth = cut = 0
    for i in range(len(buf)):
        depth += 1 if type(buf[i]) is tuple else -1
        if depth == 0:
            cut = i + 1
    events = buf[:cut]
    del buf[:cut]  # the owner only appends, after ``cut``
    stack = []
    for ev in events:
        if type(ev) is tuple:
            up = stack[-1] if stack else None
            stack.append((next(_ids), up[0] if up else None,
                          up[2] if up else next(_batches), ev))
        else:
            sid, parent, batch, (name, attrs, start) = stack.pop()
            out.append(Span(name, start, ev, sid, parent, batch, tid, attrs))


def collect() -> Record:
    """The spans closed and the counts made since the last call; clears
    them.  A span still open is returned by a later call, once its root
    has closed.  Reading a :func:`device_counter` waits for the card, so
    call it outside any batch."""
    spans: list = []
    with COUNT_LOCK:
        buffers = list(_buffers)
        counters = dict(_counts)
        _counts.clear()
        devices = list(_device_counts.items())
        _device_counts.clear()
    for (names, _), buf in devices:
        for name, v in zip(names, buf.tolist()):
            if v:
                counters[name] = counters.get(name, 0) + v
    for thread, buf in buffers:
        _closed(thread.native_id, buf, spans)
    with COUNT_LOCK:  # a finished thread's emptied buffer is not needed again
        _buffers[:] = [(t, b) for t, b in _buffers if b or t.is_alive()]
    return Record(spans, counters)


@contextlib.contextmanager
def trace(log_dir: str = "bp_osd_tpu_torch_trace"):
    """Capture a trace of the enclosed block into ``log_dir/trace.json``,
    with the recorder on: the program's spans of the block are ``"X"``
    events of category ``program`` on the trace's time base, and its
    counters the top-level ``programCounters``.  What the recorder held
    before the block is dropped.

    ``log_dir`` is relative to the working directory unless absolute.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    collect()
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
    finally:
        if not was_on:
            disable()
    rec = collect()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"batch": s.batch, **s.attrs}}
        for s in rec.spans)
    doc["programCounters"] = rec.counters
    with open(path, "w") as f:
        json.dump(doc, f)


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree):
    """Wait for the card when any tensor in a tree of dicts, lists and tuples
    lies on it; returns the tree."""
    if any(t.is_cuda for t in _tensors(tree)):
        torch.cuda.synchronize()
    return tree


class Timer:
    """Wall-clock timer; wrap device work in :func:`block` to time it.

    >>> with Timer() as t:
    ...     block(decode(syndromes))
    >>> t.elapsed
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
