"""device.idle_pct: the share of the traced window in which no kernel, copy
or set ran on the device (1 - union of their intervals / window), in %."""


def read(window):
    if window.window_s <= 0 or not window.events:
        return None
    return 100.0 * (1.0 - window.busy_s / window.window_s)
