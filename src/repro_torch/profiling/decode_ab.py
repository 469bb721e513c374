r"""Times the checkout's decode-attention kernel against another version of
its source on the card, at every decode shape ``chip_smoke.py`` times.

    PYTHONPATH=src python -m repro_torch.profiling.decode_ab OTHER.cu

``OTHER.cu`` is built with the checkout's nvcc flags (into
``build/decode_ab/``); at each shape the two builds run in the order
checkout, other, other, checkout, each timed as ``chip_smoke.py`` times a
kernel (CUDA events around 16 queued calls behind a device-side sleep,
inputs cycled past the 50 MB L2, median of 7 windows). One JSON line per
shape gives both builds' two medians and whether their outputs are
bit-equal; the last line is the card's ``nvidia-smi`` name and power limit.
The kernel with its P.V columns 32 apart at every hd, for example, is

    sed 's/SPLIT = D % 32 == 0/SPLIT = false/' \
        src/repro_torch/kernels/csrc/decode_attention.cu > strided.cu
"""
from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import _ARGS, decode_attention
from repro_torch.profiling.hw import L2_BYTES

KEY = "decode_attention.decode_attention_launch"
RAGGED = (1, 2, 100, 256, 300, 511, 512, 512)
# (row, B, H, KV, hd, C, valid lengths, dtype): chip_smoke's decode rows
SHAPES = (
    ("qwen2", 8, 14, 2, 64, 512, RAGGED, torch.bfloat16),
    ("qwen3", 8, 64, 8, 128, 512, RAGGED, torch.bfloat16),
    ("olmo", 4, 16, 16, 128, 208, (201, 204, 206, 208), torch.bfloat16),
    ("moe", 8, 16, 16, 128, 512, RAGGED, torch.bfloat16),
    ("jamba", 1, 32, 8, 128, 204, (204,), torch.bfloat16),
    ("seamless", 4, 16, 16, 64, 500, (500,) * 4, torch.bfloat16),
    ("danube", 1, 32, 8, 80, 4096, (4096,), torch.bfloat16),
    ("danube_b8", 8, 32, 8, 80, 512, RAGGED, torch.bfloat16),
    ("qwen3_f32", 8, 64, 8, 128, 512, RAGGED, torch.float32),
)


def _device_ms(fns, reps: int = 7, per_window: int = 16) -> float:
    for f in fns[:2]:
        f()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_window):
            fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / per_window)
    return statistics.median(out)


def _load(src: Path) -> ctypes._CFuncPtr:
    out_dir = build.BUILD_DIR.parent / "decode_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{src.stem}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), "decode_attention_launch")
    fn.argtypes = list(_ARGS)
    fn.restype = ctypes.c_int
    return fn


def main(other: str) -> int:
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    fns = {"checkout": build.function("decode_attention",
                                      "decode_attention_launch", _ARGS),
           "other": _load(Path(other))}
    for name, b, h, kv, d, c, vl, dt in SHAPES:
        vl = torch.tensor(vl, dtype=torch.int32, device="cuda")
        nbytes = 2 * int(vl.sum()) * kv * d * dt.itemsize
        sets = [(torch.randn(b, h, d, generator=g, device="cuda").to(dt),
                 torch.randn(b, c, kv, d, generator=g, device="cuda").to(dt),
                 torch.randn(b, c, kv, d, generator=g, device="cuda").to(dt))
                for _ in range(max(2, min(128, math.ceil(
                    2 * L2_BYTES / nbytes))))]
        ms, outs = {"checkout": [], "other": []}, {}
        for which in ("checkout", "other", "other", "checkout"):
            build._fns[KEY] = fns[which]
            outs[which] = decode_attention(*sets[0], vl)
            ms[which].append(_device_ms(
                [lambda s=s: decode_attention(*s, vl) for s in sets]))
        build._fns[KEY] = fns["checkout"]
        print(json.dumps({"shape": name, "B": b, "H": h, "KV": kv, "hd": d,
                          "C": c, "dtype": str(dt), "ms": ms,
                          "bit_equal": torch.equal(outs["checkout"],
                                                   outs["other"])}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
