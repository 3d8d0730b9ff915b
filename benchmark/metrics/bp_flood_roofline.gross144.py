"""bp_flood_roofline.gross144: K1 (csrc/bp_flood.cu)'s share of its roofline
in the gross code's space-time cell, in %: the reader of bp_flood_roofline
(the least time for the needed bp work of the traced window's decodes,
benchmark/work.py, over the device time of the kernel's launches in that
window), reported under its own name there."""

KERNELS = ("bp_flood_team_kernel", "bp_flood_global_kernel")  # the kernel's names in the trace (substrings)


def read(window):
    return window.roofline_pct("bp", KERNELS)
