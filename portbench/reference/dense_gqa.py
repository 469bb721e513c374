"""Plain float32 forward of the dense GQA decoder family (Qwen2, Qwen3).

Pre-norm blocks: RMS norm, attention with grouped K/V heads (query head h
reads K/V head h // (H / KV)), optional biases on q, k, v (Qwen2) and an RMS
norm over each head's q and k (Qwen3), rotary positions on the two halves
of each head (inverse frequencies theta^(-2i / hd)), causal softmax scaled
by 1 / sqrt(hd); then RMS norm and a SwiGLU FFN, silu(x Wg) * (x Wu) Wd; a
final RMS norm and the LM head (the embedding's transpose where tied).
Every norm has the configuration's ``norm_eps``.

Written from the published architecture and checked against the port's
plain versions; it computes everything in float32 from the weights the
benchmark drew, one layer at a time over every sequence, so that only one
layer is ever widened. Imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from portbench.reference.common import head, mm, rms, strict, weight

__all__ = ["final_hidden", "logits"]

_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1, halves rotated."""
    s, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal GQA: q (S, H, hd), k and v (S, KV, hd) -> (S, H * hd)."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(s, h * hd)


def final_hidden(m: dict, params: dict, seqs: List[torch.Tensor],
                 starts: List[int], precision: str = "f32") -> torch.Tensor:
    """The final norm's output (sum of len - start rows, d) f32 at the
    positions start..len-1 of each token sequence."""
    strict()
    eps, theta = m["norm_eps"], m["rope_theta"]
    H, KV = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    emb = params["embed"]["embedding"]
    xs = [emb[s].float() for s in seqs]
    blk = params["blocks"][0]
    at, ff = blk["attn"], blk["ffn"]
    for layer in range(m["num_layers"]):
        w = {n: weight(t[layer], precision)
             for n, t in list(at.items()) + list(ff.items())
             if n in _MATRICES}
        for i, x in enumerate(xs):
            s = x.shape[0]
            h = rms(x, blk["norm1"]["scale"][layer], eps)
            q, k, v = (mm(h, w[n], precision) for n in ("wq", "wk", "wv"))
            if m.get("qkv_bias", False):
                q = q + at["bq"][layer].float()
                k = k + at["bk"][layer].float()
                v = v + at["bv"][layer].float()
            q, k, v = q.view(s, H, hd), k.view(s, KV, hd), v.view(s, KV, hd)
            if m.get("qk_norm", False):
                q = rms(q, at["q_norm_scale"][layer], eps)
                k = rms(k, at["k_norm_scale"][layer], eps)
            a = _attention(_rope(q, theta), _rope(k, theta), v)
            x = x + mm(a, w["wo"], precision)
            h = rms(x, blk["norm2"]["scale"][layer], eps)
            gate = F.silu(mm(h, w["w_gate"], precision))
            x = x + mm(gate * mm(h, w["w_up"], precision), w["w_down"],
                       precision)
            xs[i] = x
        del w
    fn = params["final_norm"]["scale"]
    return torch.cat([rms(x[st:], fn, eps) for x, st in zip(xs, starts)])


def logits(m: dict, params: dict, h: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """(n, V) f32 logits of final-norm rows ``h``."""
    e = params["embed"]
    w = e["embedding"].T if m.get("tie_embeddings", False) else e["lm_head"]
    return head(h, w, precision)
