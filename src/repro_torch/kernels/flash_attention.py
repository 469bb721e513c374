"""Causal (optionally sliding-window) or full flash attention with GQA
(port of ``repro/kernels/flash_attention.py:26-112``; CUDA kernel in
``csrc/flash_attention.cu``).

The wrapper reads q as ``(B, Sq, H, hd)`` and k/v as ``(B, Sk, KV, hd)``
— the model's layouts — by strides, and writes ``(B, Sq, H, hd)``. Keys
have a length of their own only in the full form (``causal=False``: the
encoder-decoder's cross attention); the causal and windowed forms need
``Sk == Sq``. On a CPU
tensor it runs the plain version (``ref.flash_attention_ref``); on a CUDA
tensor it launches the kernel or raises. bf16 runs on the tensor cores
(wgmma, TMA-fed tiles); f32, which only parity runs use, runs on the CUDA
cores so that it keeps f32 accuracy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts, ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 80, 128)  # head widths the kernel is instantiated for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
         + (ctypes.c_longlong,) * 8 + (ctypes.c_int,) * 3
         + (ctypes.c_void_p,))


def _dense_heads(t: torch.Tensor) -> bool:
    es = t.element_size()
    return (t.stride(3) == 1 and t.stride(2) == t.shape[3]
            and t.data_ptr() % 16 == 0
            and all((t.stride(i) * es) % 16 == 0 for i in (0, 1)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype. Query i sees key j iff j <= i and (window == 0 or j > i -
    window), which needs Sk == Sq; ``causal=False`` sees every key."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (B, Sq, H, hd) and k, "
                         "v (B, Sk, KV, hd)")
    b, s, h, d = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or sk < 1:
        raise ValueError("flash_attention: q, k, v disagree on B or hd, or "
                         "there are no keys")
    if causal and sk != s:
        raise ValueError(f"flash_attention: the causal and windowed forms "
                         f"need as many keys as queries (Sq {s}, Sk {sk})")
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
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    fn = build.function("flash_attention", "flash_attention_launch", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            sk, h, kv, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            int(causal), int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    counts.launched(flash_attention)
    return out


flash_attention.launches = 0
