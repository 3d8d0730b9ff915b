"""Utilities: profiling, timing."""

from .profiling import Timer, block, trace

__all__ = ["trace", "Timer", "block"]
