"""Stage calls: host wall time of stage a's decode calls (each ends in a
device-to-host copy) over the decode steps they ran, outside the profiler
slices."""

STAGE = "a"


def read(rec):
    si = rec.names.index(STAGE)
    calls = [c for c in rec.calls(traced=False)
             if c.stage == si and c.kind == "decode"]
    steps = sum(c.k for c in calls)
    return float(sum(c.t1 - c.t0 for c in calls) / steps * 1e3) \
        if steps else None
