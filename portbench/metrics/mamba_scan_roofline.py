"""Kernels: the selective-scan kernel's share of its roofline, in %: the
least time of each of its launches in the prefill slices, each one prefill
call traced alone (one launch a layer of every exact-length prompt;
exponentials at 4.18 T/s or bytes at 3.35 TB/s, ``counting``), over its
device time there by kernel name."""
from portbench import counting

KERNEL = "mamba_scan_kernel"


def read(rec):
    if rec.trace is None:
        return None
    spent = rec.trace.prefills.device_seconds(KERNEL)
    bound = 0.0
    for c in rec.calls(traced=True):
        m = rec.models[c.stage]
        if c.traced != "prefill" or m["family"] != "ssm":
            continue
        for n in c.lens:
            exps, nbytes = counting.mamba_scan_launch(m, n)
            bound += m["num_layers"] * counting.bound_s(nbytes=nbytes,
                                                        exps=exps)
    return float(100.0 * bound / spent) if spent > 0 and bound > 0 else None
