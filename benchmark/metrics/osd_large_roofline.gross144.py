"""osd_large_roofline.gross144: K5 (csrc/osd_large.cu)'s share of its
roofline in the gross code's space-time cell, in %: the reader of
osd_large_roofline (the least time for the needed osd work of the traced
window's decodes, benchmark/work.py, over the device time of the kernel's
launches in that window), reported under its own name there."""

KERNELS = ("osd_large_kernel",)  # the kernel's names in the trace (substrings)


def read(window):
    return window.roofline_pct("osd", KERNELS)
