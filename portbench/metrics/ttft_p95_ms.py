"""95th percentile, over every request of the window, of the time from its
burst's submission to the first token of the stage that resolved it (the
end of that stage's prefill call in the request's ``first_token_step``)."""
import numpy as np


def read(rec):
    times = rec.token_times()
    ttft = [times[r.rid][0] - b.t_sub for b, r, _ in rec.requests()]
    return float(np.percentile(ttft, 95) * 1e3)
