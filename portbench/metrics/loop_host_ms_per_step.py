"""Engine loop: host wall time outside every stage call, per logical step,
over the steps no profiler slice touched."""


def read(rec):
    n, outside = 0, 0.0
    for t0, t1, calls in rec.steps(traced=False):
        outside += (t1 - t0) - sum(c.t1 - c.t0 for c in calls)
        n += 1
    return float(outside / n * 1e3) if n else None
