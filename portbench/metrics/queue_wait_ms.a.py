"""Engine loop: the mean wait of the window's requests in stage a's queue,
from being queued (``serve``'s entry) to the entry of the prefill call that
admitted them (``TokenResult.stage_times``), each less what of it
lies in the steps a profiler slice touched."""

STAGE = "a"


def read(rec):
    si = rec.names.index(STAGE)
    traced = [(s, e) for s, e, _ in rec.steps(traced=True)]
    waits = []
    for _, _, res in rec.requests():
        times = getattr(res, "stage_times", {}).get(si)
        if times is None:
            continue
        queued, joined = times
        waits.append(joined - queued - sum(
            max(0.0, min(e, joined) - max(s, queued)) for s, e in traced))
    return float(sum(waits) / len(waits) * 1e3) if waits else None
