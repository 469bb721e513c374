"""Mixture-of-experts FFN, single-shard path (port of
``repro/models/moe.py:34-178`` and ``:262-281``).

``apply_moe_local`` is the reference's sort-based dispatch: route each
token to its top-k experts, scatter the kept (token, expert) entries into
an ``(E_pad, C, D)`` buffer of ``C`` slots per expert, run every padded
expert over its slots in one batched product, gather back and combine.
Entries past an expert's capacity ``C`` are dropped, so the output depends
on how many tokens share the call.

Everything runs on the device with no host synchronisation (no boolean
mask indexing, ``.nonzero()`` or ``.item()``), so a captured decode step
(``serving/graphs.py``) can replay it. The JAX scatter ``.at[dest].set(...,
mode="drop")`` becomes a write into a buffer with one sentinel row at
index ``E_pad * C``, which takes every dropped entry and is then cut off;
``jnp.take(..., mode="fill")`` becomes a gather from the expert output
with one zero row appended. The combine adds each token's k contributions
in order, in the activation dtype, as the reference's scatter-add does,
and deterministically (no atomics), so a graph replay stays bit-equal to
an eager call.

The expert-parallel path (``apply_moe_ep``) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import Params, apply_ffn

__all__ = ["EP_MULTIPLE", "padded_num_experts", "make_moe_params",
           "aux_load_balance_loss", "apply_moe_local", "apply_moe"]

EP_MULTIPLE = 16  # production data-axis size; experts pad to a multiple


def padded_num_experts(m: MoEConfig) -> int:
    e = m.num_experts
    if e > EP_MULTIPLE and e % EP_MULTIPLE != 0:
        return -(-e // EP_MULTIPLE) * EP_MULTIPLE
    return e


def make_moe_params(cfg: ModelConfig, normal: Callable) -> Params:
    """The JAX ``make_moe_params`` tree. ``normal(shape)`` draws scaled
    normal weights in the model dtype, ``normal(shape, dtype)`` in
    ``dtype`` (the router is float32)."""
    m = cfg.moe
    d, fe = cfg.d_model, m.expert_d_ff
    e_pad = padded_num_experts(m)
    p: Params = {
        "router": normal((d, e_pad), torch.float32),
        "w_gate": normal((e_pad, d, fe)),
        "w_up": normal((e_pad, d, fe)),
        "w_down": normal((e_pad, fe, d)),
    }
    if m.num_shared_experts > 0:
        shared_ff = m.num_shared_experts * (m.shared_d_ff or m.expert_d_ff)
        p["shared"] = {
            "w_gate": normal((d, shared_ff)),
            "w_up": normal((d, shared_ff)),
            "w_down": normal((shared_ff, d)),
            # qwen2-moe gates the shared expert output per token
            "gate": normal((d, 1)),
        }
    return p


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _route(p: Params, m: MoEConfig, x2d: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (T, k) f32, expert_idx (T, k) i64, router_probs
    (T, E_pad) f32)."""
    e_pad = p["router"].shape[-1]
    logits = x2d.float() @ p["router"]                  # (T, E_pad) f32
    if e_pad > m.num_experts:  # mask padded experts
        pad = torch.arange(e_pad, device=logits.device) >= m.num_experts
        logits = logits.masked_fill(pad, -1e30)
    if m.norm_topk_prob:
        probs = F.softmax(logits, dim=-1)
        weights, idx = torch.topk(probs, m.top_k, dim=-1)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
    else:
        # llama4-style: sigmoid of the selected logits
        top_logits, idx = torch.topk(logits, m.top_k, dim=-1)
        weights = torch.sigmoid(top_logits)
        probs = F.softmax(logits, dim=-1)
    return weights, idx, probs


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e (f = token fraction,
    p = mean router prob). Encourages uniform expert load."""
    t = probs.shape[0]
    experts = torch.arange(probs.shape[-1], device=idx.device)
    onehot = (idx[..., None] == experts).float()            # (T, k, E)
    f = onehot.sum((0, 1)) / max(t * idx.shape[-1], 1)
    return num_experts * (f * probs.mean(0)).sum()


def _capacity(tokens: int, k: int, e: int, factor: float) -> int:
    c = int(-(-tokens * k * factor // e))
    c = max(c, 8)
    c = -(-c // 8) * 8  # multiple of 8 (the reference's TPU sublane)
    return min(c, max(tokens, 8))


def _dispatch_indices(expert_idx: torch.Tensor, e_pad: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch. expert_idx (T, k) -> (dest (T*k,), src_token
    (T*k,)), both int64.

    ``dest`` is the flat slot ``expert * C + position_in_expert`` for kept
    entries and ``e_pad * C`` (the sentinel: dropped) for overflow; within
    an expert, entries keep their token-major order (a stable sort)."""
    t, k = expert_idx.shape
    dev = expert_idx.device
    flat = expert_idx.reshape(t * k)
    order = torch.argsort(flat, stable=True)                 # (T*k,)
    sorted_expert = flat[order]
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(e_pad, device=dev,
                                    dtype=sorted_expert.dtype), side="left")
    pos = torch.arange(t * k, device=dev) - group_start[sorted_expert]
    dest_sorted = torch.where(pos < capacity,
                              sorted_expert * capacity + pos,
                              torch.full_like(pos, e_pad * capacity))
    # scatter dest back to unsorted (token-major) order
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted
    src_token = torch.arange(t * k, device=dev) // k
    return dest, src_token


def _expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, activation: str) -> torch.Tensor:
    """Batched per-expert gated FFN. buf (E, C, D) -> (E, C, D): the
    reference's einsums ``ecd,edf->ecf`` and ``ecf,efd->ecd`` as batched
    matrix products."""
    return apply_ffn({"w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                     buf, activation)


def _shared_expert(p: Params, x2d: torch.Tensor,
                   activation: str) -> torch.Tensor:
    sp = p["shared"]
    out = apply_ffn(sp, x2d, activation)
    gate = torch.sigmoid(x2d.float() @ sp["gate"].float())
    return out * gate.to(out.dtype)


# ---------------------------------------------------------------------------
# Local (single-shard) path
# ---------------------------------------------------------------------------

def apply_moe_local(p: Params, cfg: ModelConfig, x2d: torch.Tensor,
                    capacity_factor: float = 1.25, with_aux: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x2d (T, D) -> (y (T, D), aux_loss scalar f32). ``with_aux=False``
    skips the load-balance loss and returns ``None`` in its place: prefill
    and decode discard it, as ``jax.jit`` drops it from theirs."""
    m = cfg.moe
    e_pad = p["router"].shape[-1]
    t, d = x2d.shape
    weights, idx, probs = _route(p, m, x2d)
    cap = _capacity(t, m.top_k, m.num_experts, capacity_factor)
    dest, src_token = _dispatch_indices(idx, e_pad, cap)

    buf = x2d.new_zeros(e_pad * cap + 1, d)        # + the sentinel row
    buf[dest] = x2d[src_token]
    out = _expert_ffn(buf[:-1].view(e_pad, cap, d), p["w_gate"], p["w_up"],
                      p["w_down"], cfg.activation)
    out_flat = torch.cat([out.reshape(e_pad * cap, d),
                          out.new_zeros(1, d)])[dest]
    contrib = (out_flat * weights.reshape(-1, 1).to(out_flat.dtype)
               ).view(t, m.top_k, d)
    # token t's entries are rows t*k .. t*k+k-1: added in that order
    y = torch.zeros_like(x2d)
    for j in range(m.top_k):
        y = y + contrib[:, j]
    if m.num_shared_experts > 0:
        y = y + _shared_expert(p, x2d, cfg.activation)
    aux = aux_load_balance_loss(probs, idx, m.num_experts) if with_aux \
        else None
    return y, aux


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = 1.25, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux scalar or ``None``): the local
    path over all B*S tokens of the call."""
    b, s, d = x.shape
    y, aux = apply_moe_local(p, cfg, x.reshape(b * s, d), capacity_factor,
                             with_aux)
    return y.reshape(b, s, d), aux
