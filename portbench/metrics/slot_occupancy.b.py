"""Engine loop: the rows stage b's decode calls in the window decoded, over
the slots they ran, each call weighted by its steps: sum of rows * k over
sum of n_slots * k of the stage's decode ``CallSpan``s
(``SlotEngineStats.spans``), in %."""

STAGE = "b"


def read(rec):
    eng = rec.recorder.stages[rec.names.index(STAGE)]
    spans = getattr(eng.stats, "spans", None)
    if spans is None:
        return None
    t0, t1 = rec.bursts[0].t_sub, rec.bursts[-1].t_end
    rows = slots = 0
    for s in spans:
        if s.kind == "decode" and t0 <= s.t_enter and s.t_exit <= t1:
            rows += s.rows * s.k
            slots += eng.n_slots * s.k
    return float(100.0 * rows / slots) if slots else None
