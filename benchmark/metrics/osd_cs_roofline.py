"""osd_cs_roofline: K2 (csrc/osd_cs.cu, osd_cs)'s share of its roofline, in %: the least time for the
needed osd work of the traced window's decodes (benchmark/work.py) over the
device time of the kernel's launches in that window."""

KERNELS = ("osd_cs_warp_kernel",)  # the kernel's names in the trace (substrings)


def read(window):
    return window.roofline_pct("osd", KERNELS)
