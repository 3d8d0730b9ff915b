"""bp_flood_wide_roofline: K1's wide plan (``bp_flood_wide_kernel`` in
csrc/bp_flood.cu)'s share of its roofline, in %: the least time for the
needed bp work of the traced window's decodes (benchmark/work.py) times the
share of their row-iterations that the wide plan ran (the program's device
counter ``bp_flood.wide_row_iters`` over the sum of ``bp.row_iters.<i>``),
over the device time of the wide kernel's launches.  Both the work and the
time are the wide kernel's own.  None when the program records no such
counter, or no launch of the kernel is in the window (benchmark/spans.py)."""

from benchmark import spans

KERNELS = ("bp_flood_wide_kernel",)  # the kernel's name in the trace (a substring)
PREFIX = "bp.row_iters."


def read(window):
    prog = spans.of(window)
    work = window.work.get("bp")
    t = window.kernel_seconds(KERNELS)
    if prog is None or work is None or t <= 0:
        return None
    total = sum(v for k, v in prog.counters.items()
                if k.startswith(PREFIX) and k[len(PREFIX):].isdigit())
    wide = prog.counters.get("bp_flood.wide_row_iters")
    if total <= 0 or wide is None:
        return None
    return 100.0 * work.seconds() * wide / total / t
