"""Engine loop: tokens of resolved requests over every token the stages
decoded for the window's requests (each visited stage's stream, and the
speculative tokens thrown away), in %."""


def read(rec):
    useful = sum(len(res.tokens) for _, _, res in rec.requests()
                 if res.resolver >= 0)
    decoded = sum(len(g) for _, _, res in rec.requests()
                  for g in res.stage_gaps.values())
    decoded += sum(b.spec_discarded for b in rec.bursts)
    return float(100.0 * useful / decoded) if decoded else None
