"""Kernels: the decode-attention kernel's share of its roofline, in %: the
least time of each of its launches in the fixed-time profiler slices
(``counting``; each slot's valid length from the slot depths before the
call), over its device time there by kernel name."""
from portbench import counting

KERNEL = "decode_kernel"


def read(rec):
    if rec.trace is None:
        return None
    spent = rec.trace.steps.device_seconds(KERNEL)
    bound = 0.0
    for c in rec.calls(traced=True):
        m = rec.models[c.stage]
        if c.traced != "steps" or c.kind != "decode" \
                or m["family"] != "dense":
            continue
        for valid in rec.decode_valid(c):
            bound += m["num_layers"] * counting.bound_s(
                *counting.decode_attention_launch(m, valid))
    return float(100.0 * bound / spent) if spent > 0 and bound > 0 else None
