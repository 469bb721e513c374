"""From process start to the first burst: the kernels built or loaded,
the weights drawn on the device, every reachable graph captured."""


def read(rec):
    return float(rec.setup_s)
