"""Stage calls: host wall time of every prefill call over the prompts they
prefilled, outside the profiler slices."""


def read(rec):
    calls = [c for c in rec.calls(traced=False) if c.kind == "prefill"]
    prompts = sum(len(c.lens) for c in calls)
    return float(sum(c.t1 - c.t0 for c in calls) / prompts * 1e3) \
        if prompts else None
