r"""Times the checkout's flash-attention backward kernel against another
version of its source on the card, at every backward shape
``chip_smoke.py`` holds, and reads both builds' bf16 gradients against the
plain backward.

    PYTHONPATH=src python -m repro_torch.profiling.flash_bwd_ab OTHER.cu

``OTHER.cu`` is a source with the checkout's C entry point
(``OTHER_ARGS`` below), for example the last version that walked the keys
for each row's log-sum-exp itself and wrote it into its ``lse`` argument:

    git show 59ef629:src/repro_torch/kernels/csrc/flash_attention_bwd.cu \
        > build/ab/before.cu

or a variant of the checkout's source (it may include ``csrc/*.cuh``).
It is built with the checkout's nvcc flags (into ``build/flash_bwd_ab/``)
and called directly, with outputs and scratch allocated per call as the
wrapper allocates them, and a copy of its own of the plain log-sum-exp
(``ref.flash_attention_lse_ref``), which it reads or overwrites; the
checkout runs through ``flash_attention_bwd`` with the same values, as
the forward would hand them over. At each shape the two builds run in the order
checkout, other, other, checkout, each timed as ``chip_smoke.py`` times a
kernel (CUDA events around 16 queued calls behind a device-side sleep,
inputs cycled past the 50 MB L2, median of 7 windows); then one more
window of each under ``torch.profiler`` splits a call's device time by
kernel (``split``: ms a call of each ``__global__`` function the launch
runs, the dq and the dk/dv kernels apart). One JSON line per shape gives
both builds' two medians, their split, whether their gradients are
bit-equal, and for each build the largest error over each gradient's
largest plain entry and its largest reading of two elementwise limits:
``output`` (2^-8 of the plain value plus 1e-4 of the largest: the f32
sums rounded once) and ``operands`` (``output`` plus 6 x 2^-8 x the
root-sum-square of the terms of the product where P or dS is rounded to a
bf16 operand: ``rounding_scale``). The last line is the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.profiling.decode_ab import _device_ms
from repro_torch.profiling.hw import L2_BYTES

ROUND_SIGMAS = 6
F32_TOL = 1e-4
# flash_attention_bwd_launch(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
# Sq, Sk, H, KV, D, 10 strides, causal, window, q_offset, dtype, stream)
OTHER_ARGS = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
              + (ctypes.c_longlong,) * 10 + (ctypes.c_int,) * 4
              + (ctypes.c_void_p,))
# (row, B, Sq, Sk, H, KV, hd, causal, window): chip_smoke's backward rows
SHAPES = (
    ("qwen2", 8, 512, 512, 14, 2, 64, True, 0),
    ("olmo", 4, 512, 512, 16, 16, 128, True, 0),
    ("danube", 1, 4200, 4200, 32, 8, 80, True, 4096),
    ("internvl", 4, 456, 456, 14, 2, 64, True, 0),
    ("seamless", 4, 500, 500, 16, 16, 64, False, 0),
    ("seamless_cross", 4, 128, 500, 16, 16, 64, False, 0),
    ("seamless_decoder", 4, 128, 128, 16, 16, 64, True, 0),
)


def rounding_scale(q, k, v, o, do, causal: bool, window: int):
    """(dq, dk, dv)-shaped f32 root-sum-squares of the terms that a bf16
    rounding of P (in dV = P^T.dO) and of dS = P (dP - D) (in dq = dS.K
    and dk = dS^T.Q, times 1/sqrt(hd)) would move: each rounded weight
    moves its term by at most 2^-8 of itself, so a gradient moves by a sum
    of standard deviation at most 2^-8 / sqrt(3) times this scale."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    p = ref._flash_probs(qf, kf, causal, window)          # (b, kv, g, q, s)
    do5 = dof.reshape(b, sq, kv, g, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do5, vf)
    delta = (dof * of).sum(-1).reshape(b, sq, kv, g).permute(0, 2, 3, 1)
    ds2 = (p * (dp - delta[..., None])).square_()
    del dp
    scale = 1.0 / math.sqrt(d)
    dq = scale * torch.einsum("bkgqs,bskd->bqkgd", ds2, kf.square()) \
        .sqrt_().reshape(b, sq, h, d)
    dk = scale * torch.einsum("bkgqs,bqkgd->bskd", ds2,
                              qf.reshape(b, sq, kv, g, d).square()).sqrt_()
    del ds2
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.square_(),
                      do5.square()).sqrt_()
    return dq, dk, dv


def build_lib(src: Path, *flags: str, entry: str = "flash_attention_bwd_"
              "launch", argtypes=OTHER_ARGS) -> ctypes.CDLL:
    """``src`` built with the checkout's nvcc flags and ``flags`` into
    ``build/flash_bwd_ab/`` and loaded; its C entry point ``entry`` bound
    as ``.launch`` (``argtypes``)."""
    out_dir = build.BUILD_DIR.parent / "flash_bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{src.stem}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, "-I",
                    str(build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    out = ctypes.CDLL(str(lib))
    out.launch = getattr(out, entry)
    out.launch.argtypes = list(argtypes)
    out.launch.restype = ctypes.c_int
    return out


def _other_bwd(fn, q, k, v, o, do, lse, causal: bool, window: int):
    """One launch of the other build: its outputs and its D scratch
    allocated as the wrapper allocates them."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), b, sq, sk, h, kv, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), o.stride(0), o.stride(1), do.stride(0),
            do.stride(1), int(causal), int(window), 0, 1,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_bwd_ab other")
    return dq, dk, dv


def _split(fns, per_window: int = 16, match: str = "flash_bwd") -> dict:
    """Device ms a call of each kernel the calls launch whose name holds
    ``match``, from one torch.profiler window of ``per_window`` calls
    (cycling over ``fns``), keyed by the ``__global__`` function's
    name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(per_window):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or match not in e.key:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        name = re.search(r"(\w+)(<|\()", e.key)
        key = name.group(1) if name else e.key
        out[key] = out.get(key, 0.0) + t_us / 1e3 / per_window
    return out


def _readings(grads, want, nus) -> dict:
    out = {"max_rel_err": 0.0, "output": 0.0, "operands": 0.0}
    for x, r, nu in zip(grads, want, nus):
        err = (x.float() - r).abs()
        floor = F32_TOL * r.abs().max()
        out["max_rel_err"] = max(out["max_rel_err"],
                                 float(err.max() / r.abs().max()))
        out["output"] = max(out["output"], float(
            (err / (r.abs() * 2.0 ** -8 + floor)).max()))
        out["operands"] = max(out["operands"], float(
            (err / ((r.abs() + ROUND_SIGMAS * nu) * 2.0 ** -8 + floor))
            .max()))
    return out


def inputs(g, b, sq, sk, h, kv, d, causal: bool, window: int):
    """bf16 q, k, v, dO from ``g``, o the f32 plain output rounded to
    bf16 (dense, as a forward kernel hands it over) and the plain
    log-sum-exp."""
    q = torch.randn(b, sq, h, d, generator=g, device="cuda")
    k = torch.randn(b, sk, kv, d, generator=g, device="cuda")
    v = torch.randn(b, sk, kv, d, generator=g, device="cuda")
    do = torch.randn(b, sq, h, d, generator=g, device="cuda")
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    return q, k, v, o.bfloat16().contiguous(), do, lse


def main(other: str) -> int:
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    other_fn = build_lib(Path(other)).launch
    for name, b, sq, sk, h, kv, d, causal, window in SHAPES:
        def make():
            t = inputs(g, b, sq, sk, h, kv, d, causal, window)
            return t + (t[5].clone(),)

        builds = {
            "checkout": lambda q, k, v, o, do, lse, _: flash_attention_bwd(
                q, k, v, o, do, causal=causal, window=window, lse=lse),
            "other": lambda q, k, v, o, do, _, lse: _other_bwd(
                other_fn, q, k, v, o, do, lse, causal, window)}
        nbytes = 2 * (4 * b * sq * h * d + 4 * b * sk * kv * d)
        sets = [make() for _ in range(max(2, min(64, math.ceil(
            2 * L2_BYTES / nbytes))))]
        want = ref.flash_attention_bwd_ref(*(t.float() for t in sets[0][:5]),
                                           causal=causal, window=window)
        nus = rounding_scale(*sets[0][:5], causal, window)
        ms, grads = {"checkout": [], "other": []}, {}
        for which in ("checkout", "other", "other", "checkout"):
            call = builds[which]
            grads[which] = call(*sets[0])
            ms[which].append(_device_ms([lambda s=s, c=call: c(*s)
                                         for s in sets]))
        split = {which: _split([lambda s=s, c=call: c(*s) for s in sets])
                 for which, call in builds.items()}
        print(json.dumps({
            "shape": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "KV": kv,
            "hd": d, "causal": causal, "window": window, "ms": ms,
            "split": split,
            "bit_equal": all(torch.equal(x, y) for x, y in
                             zip(grads["checkout"], grads["other"])),
            **{which: _readings(grads[which], want, nus)
               for which in ("checkout", "other")}}), flush=True)
        del sets, want, nus, grads
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
