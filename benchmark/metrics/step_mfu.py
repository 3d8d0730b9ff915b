"""step_mfu: the least time the H100 could take for the needed work of every
decode in the traced window (BP and OSD together), over the window, in %:
the whole step's share of the chip's peak, which bounds what any kernel's
roofline share can give end to end."""

from benchmark.work import total


def read(window):
    works = [w for w in window.work.values() if w is not None]
    if window.window_s <= 0 or not works:
        return None
    return 100.0 * total(works).seconds() / window.window_s
