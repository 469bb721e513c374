"""Pieces the plain references share: float32 RMS norm, products with a
weight matrix in float32 or through float8 e4m3 (the control), and the LM
head in column blocks. Plain torch; nothing of the port."""
from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "strict", "rms", "q8", "weight", "mm", "head"]

PRECISIONS = ("f32", "fp8")
_E4M3_MAX = 448.0


def strict() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for each slice along
    ``dim`` (its largest magnitude to the format's largest), back in f32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / _E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A (k, n) weight in f32, or rounded with a scale per output column."""
    w = w.float()
    return q8(w, 0) if precision == "fp8" else w


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., k) @ w (k, n), w already through ``weight``; in fp8 the
    activations rounded with a scale per token."""
    if precision == "fp8":
        x = q8(x, -1)
    return x @ w


def head(h: torch.Tensor, w: torch.Tensor, precision: str,
         block: int = 16384) -> torch.Tensor:
    """h (n, d) @ w (d, V), the weight taken to ``precision`` a block of
    columns at a time."""
    out = h.new_empty(h.shape[0], w.shape[1])
    for lo in range(0, w.shape[1], block):
        hi = min(lo + block, w.shape[1])
        out[:, lo:hi] = mm(h, weight(w[:, lo:hi], precision), precision)
    return out
