"""Device: the fixed-time profiler slices' time in which no kernel, copy
or set ran on the device, over the slices' time, in %."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return float(100.0 * (t.window_s - t.busy_s) / t.window_s)
