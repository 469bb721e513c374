"""95th percentile, over every request of the window, of the gap between
its streamed tokens at the resolving stage: (last token - first token) /
(tokens - 1)."""
import numpy as np


def read(rec):
    times = rec.token_times()
    gaps = [(times[r.rid][1] - times[r.rid][0]) / (len(res.tokens) - 1)
            for _, r, res in rec.requests() if len(res.tokens) > 1]
    return float(np.percentile(gaps, 95) * 1e3)
