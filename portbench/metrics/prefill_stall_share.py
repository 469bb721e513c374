"""Engine loop: of the time between each request's first and last token at
its resolving stage (``TokenResult.first_token_t``, ``.done_t``), the share
that lies inside a prefill call of any stage (``CallSpan``,
``SlotEngineStats.spans``), both outside the steps a profiler slice
touched, in %."""
import bisect


def _inside(intervals, a, b):
    """Seconds of [a, b] inside the disjoint ``intervals``."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in intervals)


def read(rec):
    t0, t1 = rec.bursts[0].t_sub, rec.bursts[-1].t_end
    prefills = []
    for eng in rec.recorder.stages:
        spans = getattr(eng.stats, "spans", None)
        if spans is None:
            return None
        prefills += [(c.t_enter, c.t_exit) for c in spans
                     if c.kind == "prefill" and t0 <= c.t_enter
                     and c.t_exit <= t1]
    prefills.sort()
    ends = [e for _, e in prefills]
    traced = [(s, e) for s, e, _ in rec.steps(traced=True)]
    stalled = streamed = 0.0
    for _, _, res in rec.requests():
        a = getattr(res, "first_token_t", None)
        b = getattr(res, "done_t", None)
        if a is None or b is None:
            continue
        streamed += (b - a) - _inside(traced, a, b)
        i = bisect.bisect_right(ends, a)
        while i < len(prefills) and prefills[i][0] < b:
            s, e = max(prefills[i][0], a), min(prefills[i][1], b)
            stalled += (e - s) - _inside(traced, s, e)
            i += 1
    return float(100.0 * stalled / streamed) if streamed > 0 else None
