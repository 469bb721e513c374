r"""Where a tile's time goes in the flash-attention backward's bf16
kernels on the card, at every backward shape ``chip_smoke.py`` holds.

    PYTHONPATH=src python -m repro_torch.profiling.flash_bwd_phases

Builds the checkout's ``csrc/flash_attention_bwd.cu`` with
``-DFLASH_BWD_PHASES`` (into ``build/flash_bwd_ab/``): its kernels then
stamp ``clock64()`` around the phases of every tile they walk, on thread 0
of each consumer warpgroup, and sum the cycles on the device. After two
warm-up calls one call is read at each shape (inputs as
``flash_bwd_ab``'s). One JSON line per shape gives, for each of the two
kernels, its blocks and tiles, the mean cycles a tile spends in each
phase: ``wait`` (for its ring stage to land), ``scores`` (S and dP, or
their transposes, on wgmma, issued and waited), ``elementwise`` (P, dS and
the bf16 packing), ``products`` (dQ, or dV and dK, issued and waited, and
the stage released), and per block ``start`` (before the walk: D_i and the
first tiles in the dq kernel, the K and V tiles in the dk/dv kernel) and
the dq kernel's ``epilogue`` (the staged TMA store). Cycles are the SM's
clock, shared with the block's other warps and its neighbours; a stamp
costs a few. Times are ``flash_bwd_ab``'s, from the build without the
flag. The last line is the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.profiling.flash_bwd_ab import (SHAPES, _other_bwd,
                                                build_lib, inputs)

PHASES = ("wait", "scores", "elementwise", "products")


def _kernel(x, base: int, per_block: dict) -> dict:
    """The readings of one kernel from its 8 slots at ``base``: 4 phase
    sums, tiles, blocks, then ``per_block``'s names at their offsets."""
    tiles, blocks = max(x[base + 4], 1), max(x[base + 5], 1)
    out = {"blocks": x[base + 5], "tiles": x[base + 4]}
    out.update({p: x[base + i] / tiles for i, p in enumerate(PHASES)})
    out.update({p: x[base + i] / blocks for p, i in per_block.items()})
    return out


def main() -> int:
    lib = build_lib(build.CSRC / "flash_attention_bwd.cu",
                    "-DFLASH_BWD_PHASES")
    read = lib.flash_attention_bwd_phases
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 16)()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for name, b, sq, sk, h, kv, d, causal, window in SHAPES:
        q, k, v, o, do, lse = inputs(g, b, sq, sk, h, kv, d, causal, window)
        for _ in range(3):
            torch.cuda.synchronize()
            build.check(read(sums), "flash_bwd_phases")   # reads, zeroes
            _other_bwd(lib.launch, q, k, v, o, do, lse, causal, window)
        torch.cuda.synchronize()
        build.check(read(sums), "flash_bwd_phases")
        x = list(sums)
        print(json.dumps({
            "shape": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "KV": kv,
            "hd": d, "causal": causal, "window": window,
            "dq": _kernel(x, 0, {"start": 6, "epilogue": 7}),
            "dkdv": _kernel(x, 8, {"start": 6})}), flush=True)
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 1:
        sys.exit(__doc__)
    sys.exit(main())
