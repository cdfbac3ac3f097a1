"""device_idle_pct.<family>: the share of the traced window in which no
operation ran on the device, 100 (1 - busy / window), busy the union of the
profiler's device intervals."""


def read(td):
    if td.window_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
