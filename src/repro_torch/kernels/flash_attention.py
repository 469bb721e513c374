"""Causal (optionally sliding-window) or full flash attention with GQA
(port of ``repro/kernels/flash_attention.py:26-112``; CUDA kernel in
``csrc/flash_attention.cu``).

The wrapper reads q as ``(B, Sq, H, hd)`` and k/v as ``(B, Sk, KV, hd)``
— the model's layouts — by strides, and writes ``(B, Sq, H, hd)``. In the
full form (``causal=False``: the encoder and the encoder-decoder's cross
attention) every query sees every key. In the causal and windowed forms
query i stands at key position ``q_offset + i``, and the keys run to the
last query's position: ``Sk == q_offset + Sq``. ``q_offset`` is 0 for a
whole sequence, and a chunk's start for the sequence-parallel attention,
whose queries are one chunk of the sequence over the keys up to its
end. On a CPU
tensor it runs the plain version (``ref.flash_attention_ref``); on a CUDA
tensor it launches the kernel or raises. bf16 runs on the tensor cores
(wgmma, TMA-fed tiles); f32, which only parity runs use, runs on the CUDA
cores so that it keeps f32 accuracy. ``return_lse=True`` also returns
each query row's log-sum-exp of its scaled scores, ``(B, H, Sq)`` f32
(``ref.flash_attention_lse_ref`` on the CPU), which the same launch
writes; without it the kernel writes none, and its output is the same
bits either way.

Gradients: where grad mode is on and q, k or v requires grad, a CUDA call
goes through ``_FlashAttention`` (a ``torch.autograd.Function``): its
forward is the same kernel launch with the log-sum-exp written and saved,
and its backward launches ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``) on it, counted on its own wrapper.
Every other CUDA call launches the forward alone, without the
log-sum-exp unless it asks for it, as serving always has. On the CPU
autograd runs through the plain version. Under activation recomputation
a block's forward runs again in the backward pass, and that launch is
counted like any other.

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

__all__ = ["flash_attention", "flash_attention_bwd", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 80, 128)  # head widths the kernel is instantiated for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6
         + (ctypes.c_longlong,) * 8 + (ctypes.c_int,) * 4
         + (ctypes.c_void_p,))
_BWD_ARGS = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
             + (ctypes.c_longlong,) * 10 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p,))


def _dense_heads(t: torch.Tensor) -> bool:
    es = t.element_size()
    return (t.stride(3) == 1 and t.stride(2) == t.shape[3]
            and t.data_ptr() % 16 == 0
            and all((t.stride(i) * es) % 16 == 0 for i in (0, 1)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, return_lse: bool = False):
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype. Query i sees key j iff j <= q_offset + i and (window == 0 or
    j > q_offset + i - window), which needs Sk == q_offset + Sq;
    ``causal=False`` sees every key. ``return_lse=True`` returns (out,
    lse) with lse (B, H, Sq) f32, each row's natural log of the sum of
    exp(scaled score) over the keys it sees (not differentiated).
    Differentiable on both devices (see the module docstring)."""
    if counts.counter() is None:
        if q.device.type == "cpu":
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)
            if not return_lse:
                return out
            return out, ref.flash_attention_lse_ref(
                q.detach(), k.detach(), causal=causal, window=window,
                q_offset=q_offset)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: unsupported device "
                             f"{q.device}")
        _check(q, k, v, causal, window, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, causal, window, q_offset)
    else:
        out, lse = _forward(q, k, v, causal, window, q_offset, return_lse)
    return (out, lse) if return_lse else out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int, q_offset: int) -> None:
    """Raise on what the CUDA kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (B, Sq, H, hd) and k, "
                         "v (B, Sk, KV, hd)")
    b, s, h, d = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or sk < 1:
        raise ValueError("flash_attention: q, k, v disagree on B or hd, or "
                         "there are no keys")
    ref._check_offset("flash_attention", s, sk, causal, q_offset)
    kv = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype "
                        "(f32 or bf16)")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: tensors on different devices")
    if h % kv or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: needs H % KV == 0 and hd in "
                         f"{HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if not all(_dense_heads(t) for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be dense over "
                         "(heads, hd) and 16-byte aligned")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, q_offset: int, with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on checked CUDA tensors: (out,
    lse), lse None unless ``with_lse`` (under the cost counter: one
    charged call, on either device)."""
    b, s, h, d = q.shape
    cost = counts.counter()
    if cost is not None:
        return cost.charged("flash_attention", lambda: (
            q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)
            if with_lse else None), q, k, v, causal=causal, window=window,
            q_offset=q_offset)
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = build.function("flash_attention", "flash_attention_launch", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, sk, h, kv, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            int(causal), int(window), int(q_offset), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    counts.launched(flash_attention)
    return out, lse


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel, which
    reads the log-sum-exp the forward wrote. Returns (out, lse); lse is
    not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _forward(q, k, v, causal, window, q_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)   # no zero gradient for lse
        ctx.form = (causal, window, q_offset)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        if dout is None:
            return None, None, None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, *ctx.form,
                                         lse=lse)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0, lse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention(q, k, v, causal, window,
    q_offset)`` = o
    against dout (B, Sq, H, hd): (dq, dk, dv) in q's, k's and v's shapes
    and dtype. On a CPU tensor it runs the plain version
    (``ref.flash_attention_bwd_ref``), which needs no ``lse``; on a CUDA
    tensor it launches ``csrc/flash_attention_bwd.cu`` (two kernels,
    counted as one launch) or raises. Both read D_i = dO_i . o_i from the
    ``o`` given. The bf16 kernel reads each row's log-sum-exp from
    ``lse``, (B, H, Sq) f32 as ``flash_attention(..., return_lse=True)``
    gives it, and raises without one; the f32 kernel (parity runs)
    computes its own. Under the cost counter it is charged as its
    kernel."""
    cost = counts.counter()
    if cost is not None:
        return cost.charged(
            "flash_attention_bwd", lambda: (
                q.new_empty(q.shape), k.new_empty(k.shape),
                v.new_empty(v.shape)), q, k, v, o, dout, causal=causal,
            window=window, q_offset=q_offset, lse=lse)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                           window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _check(q, k, v, causal, window, q_offset)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and dout must have q's "
                         "shape")
    if any(t.dtype != q.dtype or t.device != q.device for t in (o, dout)):
        raise TypeError("flash_attention_bwd: o and dout must share q's "
                        "dtype and device")
    b, s, h, d = q.shape
    if q.dtype == torch.bfloat16:
        if lse is None:
            raise ValueError("flash_attention_bwd: the bf16 kernel reads "
                             "the forward's log-sum-exp: pass lse")
        if (lse.shape != (b, h, s) or lse.dtype != torch.float32
                or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError("flash_attention_bwd: lse must be a contiguous "
                             "(B, H, Sq) f32 tensor on q's device")
    else:   # the f32 kernel writes its own there
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    # autograd may hand over a gradient in any layout
    o, dout = (t if _dense_heads(t) else t.contiguous() for t in (o, dout))
    sk, kv = k.shape[1], k.shape[2]
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                        _BWD_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), b, s, sk, h, kv, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), o.stride(0), o.stride(1), dout.stride(0),
            dout.stride(1), int(causal), int(window), int(q_offset),
            _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_bwd")
    counts.launched(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0
