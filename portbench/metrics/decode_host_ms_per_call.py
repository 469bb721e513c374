"""Stage calls: the host's part of a decode call, both stages: its prep
and launch (checks, the graph key, the host inputs, the graph's input
copies and replay) and post (the bookkeeping after the read-backs), all but
its wait on the read-backs (``CallSpan``, ``SlotEngineStats.spans``), mean
over the window's decode calls outside the steps a profiler slice
touched.

Read under CUPTI: per-layer metrics are read in traced runs only, where
``Slicer.prime`` has loaded CUPTI before the window, and CUPTI slows every
graph launch for the rest of the process, inside the slices or not. This
number is therefore the host's part with the profiler loaded, several
times the untraced one; it compares traced runs with traced runs, and does
not say what a call costs the host in an untraced run."""


def read(rec):
    t0, t1 = rec.bursts[0].t_sub, rec.bursts[-1].t_end
    traced = [(s, e) for s, e, _ in rec.steps(traced=True)]
    host, n = 0.0, 0
    for eng in rec.recorder.stages:
        spans = getattr(eng.stats, "spans", None)
        if spans is None:
            return None
        for c in spans:
            if c.kind != "decode" or c.t_enter < t0 or c.t_exit > t1 \
                    or any(s < c.t_exit and c.t_enter < e for s, e in traced):
                continue
            host += (c.t_launched - c.t_enter) + (c.t_exit - c.t_synced)
            n += 1
    return float(host / n * 1e3) if n else None
