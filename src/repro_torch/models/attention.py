"""GQA attention: full-sequence (train/prefill, causal or the encoder's
full form) and single-token decode against a KV cache, flat or
sliding-window ring, and the encoder-decoder's cross attention (port of
``repro/models/attention.py:41-272`` and ``:377-410``).

Where the JAX model computes attention in jnp, the port calls the kernels:
``prefill_attention`` and ``attention_forward`` run ``flash_attention``,
``decode_attention`` runs the decode kernel, and cross attention runs
``flash_attention`` in its full form over the encoder's keys (prefill,
forward) or the decode kernel with every key valid (a decode step's one
query per row). For CPU tensors the kernel
wrappers run their plain versions. The sharding hooks (``constrain``,
``decode_attention_sharded``) are not ported yet.

``decode_attention`` updates the cache IN PLACE: each row writes its new
K/V into slot ``cache_index`` (``mod C`` under a sliding window) of the
cache views it is given, then the kernel attends over the first
``valid_len = min(cache_index + 1, C)`` slots. That is the JAX mask —
``idx <= cache_index``, or every slot once a ring is full — because the
softmax does not depend on the order of the slots.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import Params, apply_rope

__all__ = ["kv_cache_len", "attention_forward", "prefill_attention",
           "decode_attention", "make_cross_kv", "cross_attention",
           "cross_attention_cached"]


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = _head_rmsnorm(q, p["q_norm_scale"], cfg.norm_eps)
        k = _head_rmsnorm(k, p["k_norm_scale"], cfg.norm_eps)
    return q, k, v


def _head_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def attention_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, is_causal: bool = True
                      ) -> torch.Tensor:
    """Full-sequence self-attention (scoring, no cache output): causal
    (windowed under a sliding window), or with ``is_causal=False`` the
    encoder's form, every query over every key (RoPE still applied, no
    window)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=is_causal,
                          window=cfg.sliding_window if is_causal else 0)
    return out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def kv_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Sliding-window archs keep a ring buffer of the window size."""
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def prefill_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal attention over the prompt; returns the output and the filled
    cache (padded, or cut and rolled, to the cache length)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]

    c_len = kv_cache_len(cfg, max_len)
    if s >= c_len:
        cache = {"k": k[:, s - c_len:], "v": v[:, s - c_len:]}
        # ring alignment: slot = position % c_len under a sliding window
        if cfg.sliding_window > 0:
            shift = (s - c_len) % c_len
            cache = {n: torch.roll(a, shift, dims=1)
                     for n, a in cache.items()}
        cache = {n: a.contiguous() for n, a in cache.items()}
    else:
        cache = {}
        for n, a in (("k", k), ("v", v)):
            full = a.new_zeros((b, c_len) + tuple(a.shape[2:]))
            full[:, :s] = a
            cache[n] = full
    return out, cache


def _row_index(cache_index: Union[int, torch.Tensor], b: int,
               device: torch.device) -> torch.Tensor:
    ci = torch.as_tensor(cache_index, device=device)
    return torch.broadcast_to(ci, (b,)).long()


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     cache_index: Union[int, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x (B, 1, D); cache k/v (B, C, KV, hd), written in
    place; cache_index is the number of tokens already in context (the new
    token's position): a scalar, or ``(B,)`` for a ragged batch."""
    b = x.shape[0]
    ci = _row_index(cache_index, b, x.device)
    positions = ci.reshape(b, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)

    c_len = cache["k"].shape[1]
    slot = torch.remainder(ci, c_len) if cfg.sliding_window > 0 else ci
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    valid_len = torch.clamp(ci + 1, max=c_len).to(torch.int32)
    out = decode_kernel(q[:, 0], cache["k"], cache["v"], valid_len)
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return out, cache


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def make_cross_kv(p: Params, cfg: ModelConfig, memory: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder memory (B, Sk, D) -> cross K/V (B, Sk, KV, hd): raw
    ``wk``/``wv``, no bias, no RoPE."""
    b, sk, _ = memory.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    ck = (memory @ p["wk"]).reshape(b, sk, kv, hd)
    cv = (memory @ p["wv"]).reshape(b, sk, kv, hd)
    return ck, cv


def cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor) -> torch.Tensor:
    """x (B, Sq, D) attends to encoder memory (B, Sk, D): no mask, no
    RoPE."""
    ck, cv = make_cross_kv(p, cfg, memory)
    return cross_attention_cached(p, cfg, x, ck, cv)


def cross_attention_cached(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor
                           ) -> torch.Tensor:
    """Cross attention against precomputed K/V (B, Sk, KV, hd), every key
    valid. One query per row (a decode step) is the decode kernel's form,
    with ``valid_len = Sk``; more queries run the flash kernel's full form
    over Sk keys."""
    b, sq, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, sq, h, hd)
    if sq == 1:
        out = decode_kernel(q[:, 0], ck, cv, ck.shape[1])
    else:
        out = flash_attention(q, ck, cv, causal=False)
    return out.reshape(b, sq, h * hd) @ p["wo"]
