"""Utilities: profiling, the span and counter recorder, timing."""

from .profiling import Timer, block, trace

__all__ = ["trace", "Timer", "block"]
