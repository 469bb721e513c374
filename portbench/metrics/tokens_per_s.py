"""Output tokens of the requests resolved in the window, over the window's
wall time (the first burst's submission to the last burst's end)."""


def read(rec):
    tokens = sum(len(res.tokens) for _, _, res in rec.requests()
                 if res.resolver >= 0)
    return float(tokens / rec.window_s)
