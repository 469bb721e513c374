"""Mamba-1 selective scan (port of ``repro/kernels/mamba_scan.py:22-110``;
CUDA kernel in ``csrc/mamba_scan.cu``), and its gradient
(``csrc/mamba_scan_bwd.cu``).

The wrapper takes the Pallas kernel's operands plus an optional initial
state and returns the output and the last state, which the model's prefill
keeps as its SSM cache. On a CPU tensor it runs the plain version
(``ref.mamba_scan_ref``), which autograd differentiates; on a CUDA tensor
it launches the kernel or raises. ``return_states=True`` also returns the
state entering every 32-step chunk, ``(B, ceil(S / 32), Di, N)`` f32,
which the same launch writes; without it the kernel writes none, and its
outputs are the same bits either way.

Gradients: where grad mode is on and an input requires grad, a CUDA call
goes through ``_MambaScan`` (a ``torch.autograd.Function``): its forward
is the same kernel launch with the chunk states written and saved, and
its backward launches ``mamba_scan_bwd`` on them (no TPU counterpart: the
JAX model differentiates its jnp scan), counted on its own wrapper. Every
other CUDA call launches the forward alone, without the states unless it
asks for them, as serving always has. Under activation recomputation a block's forward runs
again in the backward pass, and that launch is counted like any other.
The decode step, a single recurrence, has kernels of its own
(``kernels/mamba_step.py``, called by ``models/mamba.py``
``mamba_decode``).

Under the dry-run's cost counter (``counts.counter()``) nothing is
launched on either device: a call goes through the same autograd
Function (or the forward alone), and the forward and backward are each
charged as their kernel, on fake tensors only (``profiling/
trace_cost.py``); the checks that read addresses are skipped, as fakes
have none.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, counts, ref

__all__ = ["mamba_scan", "mamba_scan_bwd", "STATE_SIZES"]

STATE_SIZES = (4, 8, 16)   # d_state values the kernel is instantiated for
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4
         + (ctypes.c_longlong,) * 8 + (ctypes.c_int, ctypes.c_void_p))
_BWD_ARGS = ((ctypes.c_void_p,) * 19 + (ctypes.c_int,) * 4
             + (ctypes.c_longlong,) * 10 + (ctypes.c_int, ctypes.c_void_p))
_CH = 32       # channels per block (kCh in csrc/scan.cuh)


def _states_shape(x: torch.Tensor, a: torch.Tensor) -> Tuple[int, ...]:
    bsz, s, d_inner = x.shape
    return (bsz, -(-s // ref.SCAN_CHUNK), d_inner, a.shape[1])


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
               h0: Optional[torch.Tensor] = None,
               return_states: bool = False) -> Tuple[torch.Tensor, ...]:
    """dt (B, S, Di) f32, a (Di, N) f32 (already ``-exp(A_log)``), b/c
    (B, S, N) f32, d_vec (Di,) f32, x (B, S, Di) f32 or bf16, h0 (B, Di, N)
    f32 or None (zero state) -> (y (B, S, Di) f32, h_last (B, Di, N) f32),
    and with ``return_states`` also the state entering steps 0, 32, 64,
    ... (B, ceil(S / 32), Di, N) f32 (not differentiated).
    Differentiable on both devices (see the module docstring)."""
    strides = None
    if counts.counter() is None:
        if x.device.type == "cpu":
            out = ref.mamba_scan_ref(dt, a, b_mat, c_mat, d_vec, x, h0,
                                     return_states=return_states)
            if return_states:
                return out[0], out[1], out[2].detach()
            return out
        if x.device.type != "cuda":
            raise ValueError(f"mamba_scan: unsupported device {x.device}")
        strides = _check(dt, a, b_mat, c_mat, d_vec, x, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (dt, a, b_mat, c_mat, d_vec, x, h0)):
        y, h_last, states = _MambaScan.apply(dt, a, b_mat, c_mat, d_vec, x,
                                             h0, strides)
    else:
        y, h_last, states = _forward(dt, a, b_mat, c_mat, d_vec, x, h0,
                                     strides, return_states)
    return (y, h_last, states) if return_states else (y, h_last)


def _check(dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
           c_mat: torch.Tensor, d_vec: torch.Tensor, x: torch.Tensor,
           h0: Optional[torch.Tensor]) -> Tuple[int, ...]:
    """Raise on what the CUDA kernels do not take; returns dt's, b's, c's
    and x's (batch, step) strides."""
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
    strides = (_steps_strides(dt, "dt", (bsz, s, d_inner))
               + _steps_strides(b_mat, "b", (bsz, s, n))
               + _steps_strides(c_mat, "c", (bsz, s, n))
               + _steps_strides(x, "x", (bsz, s, d_inner)))
    if tuple(a.shape) != (d_inner, n) or tuple(d_vec.shape) != (d_inner,):
        raise ValueError("mamba_scan: a must be (Di, N) and d (Di,)")
    if h0 is not None and tuple(h0.shape) != (bsz, d_inner, n):
        raise ValueError(f"mamba_scan: h0 must be {(bsz, d_inner, n)}")
    if not all(t.is_contiguous() for t in (a, d_vec) + (
            () if h0 is None else (h0,))):
        raise ValueError("mamba_scan: a, d and h0 must be contiguous")
    return strides


def _forward(dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, d_vec: torch.Tensor, x: torch.Tensor,
             h0: Optional[torch.Tensor], strides: Tuple[int, ...],
             with_states: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on CUDA tensors that ``_check``
    passed (``strides``: what it returned): (y, h_last, states), states
    None unless ``with_states``; under the cost counter one charged call,
    on either device."""
    f32 = dict(dtype=torch.float32, device=x.device)
    cost = counts.counter()
    if cost is not None:
        return cost.charged("mamba_scan", lambda: (
                x.new_empty(x.shape, dtype=torch.float32),
                x.new_empty((x.shape[0], x.shape[2], a.shape[1]),
                            dtype=torch.float32),
                x.new_empty(_states_shape(x, a), dtype=torch.float32)
                if with_states else None),
            dt, a, b_mat, c_mat, d_vec, x, h0)
    bsz, s, d_inner = x.shape
    n = a.shape[1]
    y = torch.empty((bsz, s, d_inner), **f32)
    h_last = torch.empty((bsz, d_inner, n), **f32)
    states = torch.empty(_states_shape(x, a), **f32) if with_states else None
    fn = build.function("mamba_scan", "mamba_scan_launch", _ARGS)
    rc = fn(dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            d_vec.data_ptr(), x.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), None if states is None else states.data_ptr(),
            bsz, s, d_inner, n, *strides, _X_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "mamba_scan")
    counts.launched(mamba_scan)
    return y, h_last, states


mamba_scan.launches = 0


class _MambaScan(torch.autograd.Function):
    """The forward kernel, its chunk states saved for the backward
    kernel."""

    @staticmethod
    def forward(ctx, dt, a, b_mat, c_mat, d_vec, x, h0, strides):
        y, h_last, states = _forward(dt, a, b_mat, c_mat, d_vec, x, h0,
                                     strides, True)
        ctx.save_for_backward(dt, a, b_mat, c_mat, d_vec, x, h0, states)
        ctx.mark_non_differentiable(states)
        ctx.set_materialize_grads(False)
        return y, h_last, states

    @staticmethod
    def backward(ctx, dy, dh_last, _):
        dt, a, b_mat, c_mat, d_vec, x, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        ddt, da, db, dc, dd, dx, dh0 = mamba_scan_bwd(
            dt, a, b_mat, c_mat, d_vec, x, h0, dy, dh_last, states)
        return ddt, da, db, dc, dd, dx, dh0, None


def mamba_scan_bwd(dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, d_vec: torch.Tensor, x: torch.Tensor,
                   h0: Optional[torch.Tensor], dy: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None,
                   states: Optional[torch.Tensor] = None
                   ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of ``mamba_scan(dt, a, b_mat, c_mat, d_vec, x, h0)`` =
    (y, h_last) against dy (B, S, Di) f32 and dh_last (B, Di, N) f32 (None:
    zero): (ddt, da, db, dc, dd, dx, dh0) in the inputs' shapes, dx in x's
    dtype and the rest f32, dh0 None where h0 is None. ``states`` is the
    forward's third output on the same inputs (``return_states=True``);
    where it is None a CUDA call first launches the forward for it
    (counted on ``mamba_scan``). On a CPU tensor it runs the plain version
    (``ref.mamba_scan_bwd_ref``); on a CUDA tensor it launches
    ``csrc/mamba_scan_bwd.cu`` (two kernels, counted as one launch) or
    raises. Under the cost counter it is charged as its kernel."""
    cost = counts.counter()
    if cost is not None:
        return cost.charged("mamba_scan_bwd", lambda: tuple(
                None if t is None else t.new_empty(t.shape)
                for t in (dt, a, b_mat, c_mat, d_vec, x, h0)),
            dt, a, b_mat, c_mat, d_vec, x, h0, dy, dh_last, states=states)
    if x.device.type == "cpu":
        return ref.mamba_scan_bwd_ref(dt, a, b_mat, c_mat, d_vec, x, h0, dy,
                                      dh_last, states)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan_bwd: unsupported device {x.device}")
    strides = _check(dt, a, b_mat, c_mat, d_vec, x, h0)
    bsz, s, d_inner = x.shape
    n = a.shape[1]
    if dh_last is not None and tuple(dh_last.shape) != (bsz, d_inner, n):
        raise ValueError(f"mamba_scan_bwd: dh_last must be "
                         f"{(bsz, d_inner, n)}")
    if any(t is not None and (t.dtype != torch.float32
                              or t.device != x.device)
           for t in (dy, dh_last)):
        raise TypeError("mamba_scan_bwd: dy and dh_last must be float32 "
                        "on x's device")
    # autograd may hand over a gradient in any layout
    if dy.dim() == 3 and dy.stride(2) != 1:
        dy = dy.contiguous()
    dy_s = _steps_strides(dy, "dy", (bsz, s, d_inner))
    if dh_last is not None:
        dh_last = dh_last.contiguous()
    if states is not None and (
            tuple(states.shape) != _states_shape(x, a)
            or states.dtype != torch.float32 or states.device != x.device
            or not states.is_contiguous()):
        raise ValueError(f"mamba_scan_bwd: states must be contiguous f32 "
                         f"{_states_shape(x, a)} on x's device")
    if states is None:
        states = _forward(dt, a, b_mat, c_mat, d_vec, x, h0, strides,
                          True)[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    ddt = torch.empty((bsz, s, d_inner), **f32)
    dx = torch.empty((bsz, s, d_inner), dtype=x.dtype, device=x.device)
    da = torch.empty((d_inner, n), **f32)
    db = torch.empty((bsz, s, n), **f32)
    dc = torch.empty((bsz, s, n), **f32)
    dd = torch.empty((d_inner,), **f32)
    dh0 = None if h0 is None else torch.empty((bsz, d_inner, n), **f32)
    # scratch: the per-block dB, dC partials and per-row dA, dD ones
    part_bc = torch.empty((2, bsz, -(-d_inner // _CH), s, n), **f32)
    part_ad = torch.empty((bsz, d_inner * (n + 1)), **f32)
    fn = build.function("mamba_scan_bwd", "mamba_scan_bwd_launch", _BWD_ARGS)
    rc = fn(dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            d_vec.data_ptr(), x.data_ptr(),
            None if h0 is None else h0.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
            dd.data_ptr(), dx.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), states.data_ptr(),
            part_bc.data_ptr(), part_ad.data_ptr(), bsz, s, d_inner, n,
            *strides, *dy_s, _X_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "mamba_scan_bwd")
    counts.launched(mamba_scan_bwd)
    return ddt, da, db, dc, dd, dx, dh0


mamba_scan_bwd.launches = 0
