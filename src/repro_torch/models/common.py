"""Shared model building blocks: norms, RoPE, FFN, embedding and LM head
and the token cross-entropy (port of ``repro/models/common.py:83-193``).

Plain functions over a parameter dict that keeps the JAX pytree's layout
and dtypes: norm scales stay float32 under bfloat16 weights, every norm and
rotation computes in float32 and casts back, and the LM head multiplies in
the activation dtype before the float32 cast.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

__all__ = ["Params", "apply_norm", "rope_frequencies", "apply_rope",
           "apply_ffn", "embed_tokens", "lm_logits", "cross_entropy_loss"]


def apply_norm(p: Params, x: torch.Tensor, norm_type: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    elif norm_type in ("layernorm", "nonparametric_ln"):
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            out = out * p["scale"] + p["bias"]
    else:
        raise ValueError(norm_type)
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate halves. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq    # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_ffn(p: Params, x: torch.Tensor,
              activation: str = "silu") -> torch.Tensor:
    """Gated FFN (SwiGLU; GeGLU with the tanh GELU, as ``jax.nn.gelu``)."""
    h = x @ p["w_gate"]
    gate = F.silu(h) if activation == "silu" else F.gelu(h, approximate="tanh")
    return (gate * (x @ p["w_up"])) @ p["w_down"]


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) token ids -> (B, S, D) rows of the embedding table."""
    return p["embedding"][tokens.long()]


def lm_logits(p: Params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    """Final logits in float32: the product runs in the activation dtype."""
    w = p["embedding"].T if tie else p["lm_head"]
    return (x @ w.to(x.dtype)).float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in float32 (the single-device branch of
    the reference): logsumexp minus the gold logit, masked where the label
    is ``ignore_id``, over max(count, 1). logits (B, S, V), labels (B, S).
    The reference's one-hot branch for a vocab-sharded mesh waits for the
    distributed port."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
