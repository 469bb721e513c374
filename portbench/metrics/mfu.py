"""Model step: the whole step's share of the chip's peak, in %: the least
time the chip could take for every prefill and decode call of the
untraced steps (``counting``: FLOPs at 989 TFLOP/s or bytes at 3.35 TB/s,
whichever is longer), over those steps' wall time."""


def read(rec):
    bound = wall = 0.0
    for t0, t1, calls in rec.steps(traced=False):
        wall += t1 - t0
        bound += sum(rec.call_bound_s(c) for c in calls)
    return float(100.0 * bound / wall) if wall > 0 else None
