"""One-token GQA decode attention over the model's KV-cache layout
(port of ``repro/kernels/decode_attention.py:23-100``; CUDA kernel in
``csrc/decode_attention.cu``).

Unlike the Pallas kernel, which takes ``(B, HKV, C, D)``, the wrapper
reads the model's ``(B, C, KV, hd)`` per-layer cache view in place, by
strides, so a decode step makes no transpose. On a CPU tensor it runs the
plain version (``ref.decode_attention_ref``); on a CUDA tensor it launches
the kernel or raises (also where an input requires grad: the kernel has
no backward, ``counts.forward_only``); under the dry-run's cost counter
it launches nothing and is charged as its kernel (``counts.counter()``).
One launch splits each row's
positions over a cluster of 8 blocks per KV head and merges their
partials on chip. With ``return_lse=True`` the merging block also writes
each row's log-sum-exp, the partial that a sharded flash-decode combines
across cache shards (``models/attention.py`` ``_combine_partials``).
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from repro_torch.kernels import build, counts, ref

__all__ = ["decode_attention", "MAX_GROUP", "HEAD_DIMS"]

MAX_GROUP = 8              # query heads per KV head the kernel serves
HEAD_DIMS = (32, 64, 80, 128)  # head widths the kernel is instantiated for
# (q dtype, cache dtype) -> the kernel's dtype code; f32 q over a bf16
# cache is how f32 params attend over the engine's bf16 slot pool
_DTYPES = {(torch.float32, torch.float32): 0,
           (torch.bfloat16, torch.bfloat16): 1,
           (torch.float32, torch.bfloat16): 2}
_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5
         + (ctypes.c_longlong,) * 4 + (ctypes.c_int, ctypes.c_void_p))


def _aligned(t: torch.Tensor, dims) -> bool:
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(d) * es) % 16 == 0 for d in dims)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: Union[int, torch.Tensor],
                     return_lse: bool = False):
    """q (B, H, hd); k/v (B, C, KV, hd) (any strides over B and C, dense
    over KV and hd); valid_len scalar or (B,) — row b attends to cache slots
    ``< valid_len[b]`` (none: the row's output is 0); q and the cache f32
    or bf16 alike, or f32 q over a bf16 cache. -> (B, H, hd) in q's dtype,
    and with ``return_lse`` also the rows' log-sum-exp of their scaled
    scores (B, H) f32 (-inf where a row has no valid slot). The output is
    the same either way."""
    cost = counts.counter()
    if cost is not None:
        return cost.charged(
            "decode_attention", lambda: (q.new_empty(q.shape), q.new_empty(
                q.shape[:2], dtype=torch.float32)) if return_lse
            else q.new_empty(q.shape), q, k, v, valid_len, return_lse)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    counts.forward_only("decode_attention", q, k, v)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: q must be (B, H, hd) and k, v "
                         "(B, C, KV, hd)")
    b, h, d = q.shape
    _, c, kv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError("decode_attention: q and the cache disagree on B "
                         "or hd")
    code = _DTYPES.get((q.dtype, k.dtype))
    if code is None or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}: needs one dtype (f32 or bf16), or f32 q "
                        f"over a bf16 cache")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("decode_attention: tensors on different devices")
    if h % kv or h // kv > MAX_GROUP or d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: needs H % KV == 0, "
                         f"H / KV <= {MAX_GROUP}, hd in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != d or not _aligned(t, (0, 1)):
            raise ValueError("decode_attention: the cache must be dense "
                             "over (KV, hd) and 16-byte aligned")
    if not isinstance(valid_len, torch.Tensor):
        valid_len = torch.full((b,), int(valid_len), dtype=torch.int32,
                               device=q.device)
    vl = torch.broadcast_to(valid_len, (b,))
    if vl.dtype != torch.int32 or vl.device != q.device:
        vl = vl.to(device=q.device, dtype=torch.int32)
    vl = vl.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = build.function("decode_attention", "decode_attention_launch", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, h,
            kv, c, d, k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), code,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "decode_attention")
    counts.launched(decode_attention)
    return (out, lse) if return_lse else out


decode_attention.launches = 0
