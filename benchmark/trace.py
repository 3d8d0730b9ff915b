"""The traced window: device events under ``torch.profiler`` and what the
per-layer metrics read from them.

The profiler records CUDA activity only (kernels, copies and sets on the
device, with their device times), so its host work is small and does not
inflate the window as a trace of host activity would.  Each batch of the
traced window starts with a marker, a ``torch.cuda._sleep(0)`` kernel, so
that idle gaps can be named by the phase around them; markers are not
counted as the program's work.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

from .work import Work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


class Event(NamedTuple):
    name: str
    start_us: float
    dur_us: float


def record(fn):
    """``fn()`` under ``torch.profiler`` with CUDA activity; returns its
    result and the device events, in start order, markers included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f).get("traceEvents", [])
    events = [Event(str(e.get("name", "")), float(e["ts"]), float(e.get("dur", 0.0)))
              for e in raw
              if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATS]
    events.sort(key=lambda e: e.start_us)
    return out, events


def short_name(name: str) -> str:
    """A kernel's name without ``void``, its arguments and deep templates."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:96]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.start_us):
        s, f = e.start_us, e.start_us + e.dur_us
        if f <= end:
            continue
        busy += f - max(s, end)
        end = f
    return busy


class Window:
    """What the per-layer metrics read: the traced window's length, its
    batches, the program's device events in it and the needed work of the
    decodes it ran (``work["bp"]``, ``work["osd"]``)."""

    def __init__(self, window_s: float, batches: int, events, work: dict):
        self.window_s = window_s
        self.batches = batches
        self.all_events = list(events)
        self.events = [e for e in self.all_events if MARKER not in e.name]
        self.work = work
        self.busy_s = busy_us(self.events) / 1e6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the events whose name holds one of ``names``."""
        return sum(e.dur_us for e in self.events if any(s in e.name for s in names)) / 1e6

    def roofline_pct(self, stage: str, names):
        """The least time for ``stage``'s needed work over the device time of
        the kernels ``names``, in %; None when either is missing."""
        t = self.kernel_seconds(names)
        w: Work | None = self.work.get(stage)
        if t <= 0 or w is None or w.seconds() <= 0:
            return None
        return 100.0 * w.seconds() / t

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing around them."""
        ops = defaultdict(float)
        for e in self.events:
            ops[short_name(e.name)] += e.dur_us / 1e6
        gaps = defaultdict(float)
        prev = None
        end = float("-inf")
        for e in self.all_events:
            if prev is not None and e.start_us > end:
                if MARKER in e.name:
                    label = "between batches (harness: sync, clock, next submit)"
                elif MARKER in prev.name:
                    label = "decode_batch entry, before " + short_name(e.name)
                else:
                    label = f"in decode_batch: {short_name(prev.name)} -> {short_name(e.name)}"
                gaps[label[:160]] += (e.start_us - end) / 1e6
            if e.start_us + e.dur_us > end:
                end = e.start_us + e.dur_us
                prev = e
        def best(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}
