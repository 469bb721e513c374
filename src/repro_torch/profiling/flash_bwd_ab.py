r"""Times the checkout's flash-attention backward kernel against another
version of its source on the card, at every backward shape
``chip_smoke.py`` holds, and reads both builds' bf16 gradients against the
plain backward.

    PYTHONPATH=src python -m repro_torch.profiling.flash_bwd_ab OTHER.cu

``OTHER.cu`` is built with the checkout's nvcc flags (into
``build/flash_bwd_ab/``); at each shape the two builds run in the order
checkout, other, other, checkout, each timed as ``chip_smoke.py`` times a
kernel (CUDA events around 16 queued calls behind a device-side sleep,
inputs cycled past the 50 MB L2, median of 7 windows). One JSON line per
shape gives both builds' two medians, whether their gradients are
bit-equal, and for each build the largest error over each gradient's
largest plain entry and its largest reading of two elementwise limits:
``output`` (2^-8 of the plain value plus 1e-4 of the largest: the f32
sums rounded once) and ``operands`` (``output`` plus 6 x 2^-8 x the
root-sum-square of the terms of the product where P or dS is rounded to a
bf16 operand: ``rounding_scale``). The last line is the card's
``nvidia-smi`` name and power limit.

PERF.md's single-operand comparison ran with the design this source
replaced as the checkout (P and dS split into bf16 hi + lo operands in
``accum_xb``, two products each), against that source without its lo
products:

    sed '/mma_bf16(out\[nt\], lo, bfr);/d' split.cu > single.cu
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (_BWD_ARGS,
                                                 flash_attention_bwd)
from repro_torch.profiling.decode_ab import _device_ms
from repro_torch.profiling.hw import L2_BYTES

KEY = "flash_attention_bwd.flash_attention_bwd_launch"
ROUND_SIGMAS = 6
F32_TOL = 1e-4
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


def _load(src: Path) -> ctypes._CFuncPtr:
    out_dir = build.BUILD_DIR.parent / "flash_bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{src.stem}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), "flash_attention_bwd_launch")
    fn.argtypes = list(_BWD_ARGS)
    fn.restype = ctypes.c_int
    return fn


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


def main(other: str) -> int:
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    fns = {"checkout": build.function("flash_attention_bwd",
                                      "flash_attention_bwd_launch",
                                      _BWD_ARGS),
           "other": _load(Path(other))}
    for name, b, sq, sk, h, kv, d, causal, window in SHAPES:
        def make():
            q = torch.randn(b, sq, h, d, generator=g, device="cuda")
            k = torch.randn(b, sk, kv, d, generator=g, device="cuda")
            v = torch.randn(b, sk, kv, d, generator=g, device="cuda")
            do = torch.randn(b, sq, h, d, generator=g, device="cuda")
            q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
            o = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=causal, window=window)
            return q, k, v, o.bfloat16(), do

        nbytes = 2 * (4 * b * sq * h * d + 4 * b * sk * kv * d)
        sets = [make() for _ in range(max(2, min(64, math.ceil(
            2 * L2_BYTES / nbytes))))]
        want = ref.flash_attention_bwd_ref(*(t.float() for t in sets[0]),
                                           causal=causal, window=window)
        nus = rounding_scale(*sets[0], causal, window)
        ms, grads = {"checkout": [], "other": []}, {}
        for which in ("checkout", "other", "other", "checkout"):
            build._fns[KEY] = fns[which]
            grads[which] = flash_attention_bwd(*sets[0], causal=causal,
                                               window=window)
            ms[which].append(_device_ms(
                [lambda s=s: flash_attention_bwd(*s, causal=causal,
                                                 window=window)
                 for s in sets]))
        build._fns[KEY] = fns["checkout"]
        print(json.dumps({
            "shape": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "KV": kv,
            "hd": d, "causal": causal, "window": window, "ms": ms,
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
