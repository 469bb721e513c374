"""Top-1 minus top-2 certainty gap and greedy argmax over the vocab
(port of ``repro/kernels/top2gap.py:25-114``; CUDA kernel in
``csrc/top2gap.cu``).

``argmax_gap`` is the decode loop's per-step reduction (paper Eq. 5 plus
the greedy token): each step hands the host (B,) tokens and gaps instead of
(B, V) logits. On a CPU tensor the wrapper runs the plain version
(``ref.top2gap_ref``); on a CUDA tensor it launches the kernel or raises
(also where an input requires grad: the kernel has no backward,
``counts.forward_only``). Under the dry-run's cost counter it launches
nothing and is charged as its kernel (``counts.counter()``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, counts, ref

__all__ = ["top2gap", "argmax_gap", "load"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def load():
    """Build and load the kernel without launching it (the server does
    this before its consumer threads start)."""
    return build.function("top2gap", "top2gap_launch", _ARGS)


def top2gap(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (B, V) f32 or bf16 -> (gap (B,) f32, argmax (B,) i32); an
    exact top-1 tie gives gap 0 and the lowest index."""
    cost = counts.counter()
    if cost is not None:
        return cost.charged("top2gap", lambda: (
            scores.new_empty(scores.shape[:1], dtype=torch.float32),
            scores.new_empty(scores.shape[:1], dtype=torch.int32)), scores)
    if scores.device.type == "cpu":
        return ref.top2gap_ref(scores)
    if scores.device.type != "cuda":
        raise ValueError(f"top2gap: unsupported device {scores.device}")
    counts.forward_only("top2gap", scores)
    if scores.dim() != 2:
        raise ValueError(f"top2gap: scores must be (B, V), got "
                         f"{tuple(scores.shape)}")
    if scores.dtype not in _DTYPES:
        raise TypeError(f"top2gap: dtype {scores.dtype} is not f32/bf16")
    b, v = scores.shape
    if b < 1 or v < 2:
        raise ValueError(f"top2gap: needs B >= 1 and V >= 2, got ({b}, {v})")
    if scores.stride(1) != 1:
        raise ValueError("top2gap: the vocab axis must be contiguous")
    gap = torch.empty(b, dtype=torch.float32, device=scores.device)
    idx = torch.empty(b, dtype=torch.int32, device=scores.device)
    rc = load()(scores.data_ptr(), gap.data_ptr(), idx.data_ptr(), b, v,
                scores.stride(0), _DTYPES[scores.dtype],
                torch.cuda.current_stream(scores.device).cuda_stream)
    build.check(rc, "top2gap")
    counts.launched(top2gap)
    return gap, idx


top2gap.launches = 0


def argmax_gap(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused greedy-sampling reduction: scores (B, V) -> (argmax (B,) i32,
    top-1 minus top-2 gap (B,) f32), in the order of the JAX
    ``argmax_gap``."""
    gap, idx = top2gap(scores)
    return idx, gap
