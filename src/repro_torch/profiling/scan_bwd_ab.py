r"""Times the checkout's selective-scan backward kernel against another
version of its source on the card, at the backward shapes ``chip_smoke.py``
times, and reads both builds' gradients against the plain reverse
recurrence.

    PYTHONPATH=src python -m repro_torch.profiling.scan_bwd_ab OTHER.cu \
        [NVCC_FLAG ...]

``OTHER.cu`` is a source with the checkout's C entry point
(``mamba_scan_bwd_launch``, ``OTHER_ARGS`` below), for example the last
version that walked the sequence for the chunk states itself and wrote
them into its 17th argument:

    git show 3c70e1f:src/repro_torch/kernels/csrc/mamba_scan_bwd.cu \
        > build/ab/scan_before.cu

or a copy of the checkout's source with one design step changed, for
example each decay taken again in the reverse step:

    sed 's/const float ek = e\[tl\]\[k\];/const float ek = ex2(dtv * a2[k]);/' \
        src/repro_torch/kernels/csrc/mamba_scan_bwd.cu > build/ab/again.cu

(a copy may include ``csrc/*.cuh``; NVCC_FLAGs after OTHER.cu, such as
``-D`` definitions, go to its build). It is built with the checkout's nvcc
flags (into
``build/flash_bwd_ab/``, ``flash_bwd_ab.build_lib``) and called directly,
with outputs and scratch allocated per call (the dB, dC partials at one a
block, enough for any cluster size) and a copy of its own of the forward
kernel's chunk states, which it reads or overwrites; the checkout runs
through ``mamba_scan_bwd`` with the same states, as the forward hands
them over. At each shape (falcon-mamba-7b's and jamba's training shape,
B 4 x S 512 x Di 8192 x N 16, x bf16, and B 1 at S 200) the two builds run
in the order checkout, other, other, checkout, each timed as
``chip_smoke.py`` times a kernel (``decode_ab._device_ms``: CUDA events
around 16 queued calls behind a device-side sleep, inputs cycled past the
50 MB L2, median of 7 windows); then one more window of each under
``torch.profiler`` splits a call's device time by ``__global__`` function
(``flash_bwd_ab._split``: the scan and the partials' reduction). One JSON
line per shape gives both builds' two medians, their split, whether their
gradients are bit-equal, and for each build its largest error over the
limit chip_smoke holds (1e-5 of each gradient's largest plain entry, a
bf16 dx also 2^-8 of its value). The last line is the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels.mamba_scan import (_BWD_ARGS, _X_DTYPES, _CH,
                                            mamba_scan, mamba_scan_bwd)
from repro_torch.profiling.decode_ab import _device_ms
from repro_torch.profiling.flash_bwd_ab import _split, build_lib
from repro_torch.profiling.hw import L2_BYTES

OTHER_ARGS = _BWD_ARGS
TOL = 1e-5
# (row, B, S, Di, N): chip_smoke's timed backward rows, x bf16, no h0
SHAPES = (("train", 4, 512, 8192, 16), ("s200", 1, 200, 8192, 16))


def inputs(g, b: int, s: int, di: int, n: int):
    """The scan's operands as the SSM layer makes them, a cotangent dy,
    and the forward kernel's chunk states for them."""
    dt = F.softplus(torch.randn(b, s, di, generator=g, device="cuda") * 0.5
                    - 3.0)
    a = -torch.exp(torch.rand(di, n, generator=g, device="cuda") * 1.1)
    bm = torch.randn(b, s, n, generator=g, device="cuda")
    cm = torch.randn(b, s, n, generator=g, device="cuda")
    d = torch.randn(di, generator=g, device="cuda")
    x = torch.randn(b, s, di, generator=g, device="cuda").bfloat16()
    dy = torch.randn(b, s, di, generator=g, device="cuda")
    states = mamba_scan(dt, a, bm, cm, d, x, return_states=True)[2]
    return dt, a, bm, cm, d, x, dy, states


def _other_bwd(fn, dt, a, bm, cm, d, x, dy, states):
    """One launch of the other build: outputs and scratch allocated as the
    wrapper allocates them, the partials at one a block."""
    b, s, di = x.shape
    n = a.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    ddt, dx = torch.empty(b, s, di, **f32), torch.empty_like(x)
    da, dd = torch.empty(di, n, **f32), torch.empty(di, **f32)
    db, dc = torch.empty(b, s, n, **f32), torch.empty(b, s, n, **f32)
    part_bc = torch.empty(2, b, -(-di // _CH), s, n, **f32)
    part_ad = torch.empty(b, di * (n + 1), **f32)
    rc = fn(dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            d.data_ptr(), x.data_ptr(), None, dy.data_ptr(), None,
            ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
            dd.data_ptr(), dx.data_ptr(), None, states.data_ptr(),
            part_bc.data_ptr(), part_ad.data_ptr(), b, s, di, n,
            dt.stride(0), dt.stride(1), bm.stride(0), bm.stride(1),
            cm.stride(0), cm.stride(1), x.stride(0), x.stride(1),
            dy.stride(0), dy.stride(1), _X_DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "scan_bwd_ab other")
    return ddt, da, db, dc, dd, dx


def over_limit(got, want) -> float:
    """The largest |got - want| over its limit: TOL of the gradient's
    largest plain entry, a bf16 dx (the sixth) also 2^-8 of its value."""
    worst = 0.0
    for i, (x, w) in enumerate(zip(got, want)):
        tol = TOL * w.abs().max() + torch.zeros_like(w)
        if i == 5 and x.dtype == torch.bfloat16:
            tol = tol + w.abs() * 2.0 ** -8
        worst = max(worst, float(((x.float() - w).abs() / tol).max()))
    return worst


def main(other: str, *flags: str) -> int:
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    other_fn = build_lib(Path(other), *flags, entry="mamba_scan_bwd_launch",
                         argtypes=OTHER_ARGS).launch
    for name, b, s, di, n in SHAPES:
        def make():
            t = inputs(g, b, s, di, n)
            return t + (t[7].clone(),)

        builds = {
            "checkout": lambda dt, a, bm, cm, d, x, dy, st, _: mamba_scan_bwd(
                dt, a, bm, cm, d, x, None, dy, states=st)[:6],
            "other": lambda dt, a, bm, cm, d, x, dy, _, st: _other_bwd(
                other_fn, dt, a, bm, cm, d, x, dy, st)}
        nbytes = b * s * di * (4 + 2 + 4 + 4 + 2)
        sets = [make() for _ in range(max(2, min(64, math.ceil(
            2 * L2_BYTES / nbytes))))]
        dt, a, bm, cm, d, x, dy = sets[0][:7]
        want = ref.mamba_scan_bwd_ref(dt, a, bm, cm, d, x.float(), None,
                                      dy)[:6]
        ms, grads = {"checkout": [], "other": []}, {}
        for which in ("checkout", "other", "other", "checkout"):
            call = builds[which]
            grads[which] = call(*sets[0])
            ms[which].append(_device_ms([lambda t=t, c=call: c(*t)
                                         for t in sets]))
        split = {which: _split([lambda t=t, c=call: c(*t) for t in sets],
                               match="mamba_scan_bwd")
                 for which, call in builds.items()}
        print(json.dumps({
            "shape": name, "B": b, "S": s, "Di": di, "N": n, "ms": ms,
            "split": split,
            "bit_equal": all(torch.equal(x, y) for x, y in
                             zip(grads["checkout"], grads["other"])),
            **{f"{which}_over_limit": over_limit(grads[which], want)
               for which in ("checkout", "other")}}), flush=True)
        del sets, want, grads
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(*sys.argv[1:]))
