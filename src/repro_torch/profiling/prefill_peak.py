r"""The device memory one SSM prefill holds above what was in use before it,
beside a bound computed from the shapes.

    PYTHONPATH=src python -m repro_torch.profiling.prefill_peak

builds ``ARCH`` at full width (random bf16 weights from seed 0 on the
card), runs one ``prefill`` of ``BATCH`` x ``SEQ`` random tokens and
prints one JSON line: ``peak_bytes`` (the peak of
``torch.cuda.max_memory_allocated`` over the call, less what was
allocated before it), ``bound_bytes`` (``bound``), the returned cache's
bytes and the card's ``nvidia-smi`` name and power limit.

Another tree's package (a parent commit's, unpacked into a gitignored
directory) is measured by running this file with that tree's ``src`` on
the path, so that the model code is that tree's and the measurement
this one's:

    PYTHONPATH=OTHER/src python src/repro_torch/profiling/prefill_peak.py

``chip_smoke.py``'s ``serve_ssm`` phase calls ``measure`` on the weights
it serves.
"""
from __future__ import annotations

import gc
import json
import subprocess
from typing import Any, Dict

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib

# one SSM layer's live activations, in units of its in_proj output
# (B, S, 2 Di) in the activation dtype: the projection itself, the padded
# conv input and its output, the gate, the f32 dt and scan output (two
# units each), the norm's f32 temporaries and the residual stream
LAYER_COPIES = 8
SLACK = 256 << 20     # the caching allocator's rounding, cuBLAS workspace
# the one prefill measured: falcon-mamba-7b at full depth
ARCH, BATCH, SEQ = "falcon-mamba-7b", 1, 4096


def bound(cfg, batch: int, seq: int, cache_bytes: int,
          itemsize: int = 2) -> int:
    """The most a prefill should hold above its arguments: its cache twice
    (the layers' caches, then stacked over repetitions), one SSM layer's
    activations (``LAYER_COPIES`` in_proj outputs) and ``SLACK``. A
    prefill whose layers each kept their projection alive holds one more
    projection a layer."""
    if cfg.ssm is None:
        raise ValueError(f"prefill_peak: {cfg.name} has no SSM layers")
    proj = batch * seq * 2 * cfg.ssm.expand * cfg.d_model * itemsize
    return 2 * cache_bytes + LAYER_COPIES * proj + SLACK


def measure(params: Any, cfg, batch: int = BATCH,
            seq: int = SEQ) -> Dict[str, Any]:
    """One ``prefill`` of ``batch`` x ``seq`` random tokens on the card:
    its peak allocation above what was allocated before it, the bound,
    the cache's bytes and the seconds it took."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda",
                           generator=gen)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with torch.no_grad():
        logits, cache = model_lib.prefill(params, cfg, {"tokens": tokens})
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    cache_bytes = sum(t.nbytes for t in tree_lib.leaves(cache))
    out = {"arch": cfg.name, "batch": batch, "seq": seq,
           "layers": cfg.num_layers, "peak_bytes": int(peak),
           "bound_bytes": int(bound(cfg, batch, seq, cache_bytes)),
           "cache_bytes": int(cache_bytes),
           "logits_finite": bool(torch.isfinite(logits).all()),
           "prefill_ms": start.elapsed_time(end)}
    del logits, cache
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prefill_peak: no CUDA device")
    cfg = get_config(ARCH)
    params = model_lib.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                   device="cuda")
    row = measure(params, cfg)
    row["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
