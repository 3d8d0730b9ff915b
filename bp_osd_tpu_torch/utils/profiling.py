"""Profiling and timing helpers.

Port of ``bp_osd_tpu/utils/profiling.py`` over ``torch.profiler``: a trace
of the enclosed block (CPU activity, and CUDA activity when a card is
present) exported as a Chrome trace, viewable in Perfetto or
``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "Timer", "block"]


@contextlib.contextmanager
def trace(log_dir: str = "bp_osd_tpu_torch_trace"):
    """Capture a trace of the enclosed block into ``log_dir/trace.json``.

    ``log_dir`` is relative to the working directory unless absolute.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
