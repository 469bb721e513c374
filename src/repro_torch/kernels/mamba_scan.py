"""Mamba-1 selective scan (port of ``repro/kernels/mamba_scan.py:22-110``;
CUDA kernel in ``csrc/mamba_scan.cu``).

The wrapper takes the Pallas kernel's operands plus an optional initial
state and returns the output and the last state, which the model's prefill
keeps as its SSM cache. On a CPU tensor it runs the plain version
(``ref.mamba_scan_ref``); on a CUDA tensor it launches the kernel or raises
(also where an input requires grad: the kernel has no backward,
``counts.forward_only``).
The decode step is a single recurrence and needs no kernel
(``models/mamba.py`` ``mamba_decode``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, counts, ref

__all__ = ["mamba_scan", "STATE_SIZES"]

STATE_SIZES = (4, 8, 16)   # d_state values the kernel is instantiated for
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 4
         + (ctypes.c_longlong,) * 8 + (ctypes.c_int, ctypes.c_void_p))


def _steps_strides(t: torch.Tensor, name: str, shape) -> Tuple[int, int]:
    """A (B, S, W) operand's batch and step strides; its last axis must be
    unit-stride."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mamba_scan: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.stride(2) != 1:
        raise ValueError(f"mamba_scan: {name}'s last axis must be "
                         f"contiguous")
    return t.stride(0), t.stride(1)


def mamba_scan(dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, d_vec: torch.Tensor, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt (B, S, Di) f32, a (Di, N) f32 (already ``-exp(A_log)``), b/c
    (B, S, N) f32, d_vec (Di,) f32, x (B, S, Di) f32 or bf16, h0 (B, Di, N)
    f32 or None (zero state) -> (y (B, S, Di) f32, h_last (B, Di, N) f32)."""
    if x.device.type == "cpu":
        return ref.mamba_scan_ref(dt, a, b_mat, c_mat, d_vec, x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    counts.forward_only("mamba_scan", dt, a, b_mat, c_mat, d_vec, x, h0)
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError("mamba_scan: x must be (B, S, Di) and a (Di, N)")
    bsz, s, d_inner = x.shape
    n = a.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan: d_state {n} is not one of "
                         f"{STATE_SIZES}")
    if bsz < 1 or s < 1 or bsz > 65535:
        raise ValueError(f"mamba_scan: needs 1 <= B <= 65535 and S >= 1, "
                         f"got B={bsz}, S={s}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"mamba_scan: x dtype {x.dtype} is not f32/bf16")
    tensors = [dt, a, b_mat, c_mat, d_vec] + ([] if h0 is None else [h0])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("mamba_scan: dt, a, b, c, d and h0 must be float32")
    if any(t.device != x.device for t in tensors):
        raise ValueError("mamba_scan: tensors on different devices")
    dt_s = _steps_strides(dt, "dt", (bsz, s, d_inner))
    b_s = _steps_strides(b_mat, "b", (bsz, s, n))
    c_s = _steps_strides(c_mat, "c", (bsz, s, n))
    x_s = _steps_strides(x, "x", (bsz, s, d_inner))
    if tuple(a.shape) != (d_inner, n) or tuple(d_vec.shape) != (d_inner,):
        raise ValueError("mamba_scan: a must be (Di, N) and d (Di,)")
    if h0 is not None and tuple(h0.shape) != (bsz, d_inner, n):
        raise ValueError(f"mamba_scan: h0 must be {(bsz, d_inner, n)}")
    if not all(t.is_contiguous() for t in (a, d_vec) + (
            () if h0 is None else (h0,))):
        raise ValueError("mamba_scan: a, d and h0 must be contiguous")
    y = torch.empty((bsz, s, d_inner), dtype=torch.float32, device=x.device)
    h_last = torch.empty((bsz, d_inner, n), dtype=torch.float32,
                         device=x.device)
    fn = build.function("mamba_scan", "mamba_scan_launch", _ARGS)
    rc = fn(dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            d_vec.data_ptr(), x.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), bsz, s, d_inner, n, *dt_s, *b_s, *c_s, *x_s,
            _X_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "mamba_scan")
    counts.launched(mamba_scan)
    return y, h_last


mamba_scan.launches = 0
