"""Mixture-of-experts FFN (port of ``repro/models/moe.py``): the
single-shard path and the expert-parallel one.

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

``apply_moe_ep`` is the reference's expert-parallel ``shard_map`` body
over a mesh, on this process's tokens and this process's expert blocks
(``distributed.sharding.local_params``: the experts split over the
expert axis, their width F over the model axis): route locally, size the
capacity from the local token count, dispatch, one ``all_to_all`` over
the data axis (each process receives its experts' slots from every
process of the axis), the local experts' FFN, one sum over the model
axis, the ``all_to_all`` back, and the same ordered combine. The aux
loss is averaged over the data axis. The collectives are differentiable
(``distributed.compat``), so each expert block's gradient, gathered from
every process's tokens, stays with the process that holds it. Because
the capacity follows the local token count, the tokens an expert drops
can differ from the single-shard path's over the same batch (the
reference's own EP does the same). Without expert parallelism under a
mesh, the local path runs on the whole experts with F split over the
model axis.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import compat
from repro_torch.distributed.context import DistContext, get_context
from repro_torch.models.common import (Params, apply_ffn, model_blocks,
                                       tp_in, tp_out)

__all__ = ["EP_MULTIPLE", "padded_num_experts", "make_moe_params",
           "aux_load_balance_loss", "apply_moe_local", "apply_moe_ep",
           "apply_moe"]

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


def _dispatch(x2d: torch.Tensor, dest: torch.Tensor, src_token: torch.Tensor,
              e_pad: int, cap: int) -> torch.Tensor:
    """The (E_pad, C, D) slot buffer: each kept entry's token at its slot,
    zeros elsewhere (dropped entries land on a sentinel row, cut off)."""
    d = x2d.shape[-1]
    buf = x2d.new_zeros(e_pad * cap + 1, d)        # + the sentinel row
    buf[dest] = x2d[src_token]
    return buf[:-1].view(e_pad, cap, d)


def _combine(out: torch.Tensor, dest: torch.Tensor, weights: torch.Tensor,
             t: int, k: int) -> torch.Tensor:
    """Each token's k expert outputs (gathered from the (E_pad, C, D)
    expert output, a zero row for a dropped entry), weighted, added in
    order: token t's entries are rows t*k .. t*k+k-1."""
    d = out.shape[-1]
    out_flat = torch.cat([out.reshape(-1, d), out.new_zeros(1, d)])[dest]
    contrib = (out_flat * weights.reshape(-1, 1).to(out_flat.dtype)
               ).view(t, k, d)
    y = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, activation: str) -> torch.Tensor:
    """Batched per-expert gated FFN. buf (E, C, D) -> (E, C, D): the
    reference's einsums ``ecd,edf->ecf`` and ``ecf,efd->ecd`` as batched
    matrix products."""
    return apply_ffn({"w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                     buf, activation)


def _shared_expert(p: Params, cfg: ModelConfig,
                   x2d: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    m = cfg.moe
    out = apply_ffn(sp, x2d, cfg.activation,
                    m.num_shared_experts * (m.shared_d_ff or m.expert_d_ff))
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
    t = x2d.shape[0]
    weights, idx, probs = _route(p, m, x2d)
    cap = _capacity(t, m.top_k, m.num_experts, capacity_factor)
    dest, src_token = _dispatch_indices(idx, e_pad, cap)

    # under a mesh the experts' F may be split over the model axis
    nf = model_blocks(m.expert_d_ff)
    out = tp_out(_expert_ffn(
        tp_in(_dispatch(x2d, dest, src_token, e_pad, cap), nf),
        p["w_gate"], p["w_up"], p["w_down"], cfg.activation), nf)
    y = _combine(out, dest, weights, t, m.top_k)
    if m.num_shared_experts > 0:
        y = y + _shared_expert(p, cfg, x2d)
    aux = aux_load_balance_loss(probs, idx, m.num_experts) if with_aux \
        else None
    return y, aux


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------

def _moe_ep_body(x_loc: torch.Tensor, router: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, *, cfg: ModelConfig, data_axis: str,
                 model_axis: str, capacity_factor: float, e_pad: int,
                 with_aux: bool, aux_axes: Tuple[str, ...]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One process's part. x_loc (T_loc, D); w_* its expert blocks
    (E_pad / ep, D, F / nm) and (E_pad / ep, F / nm, D). Returns (y_loc
    (T_loc, D), the aux loss averaged over ``aux_axes``, or None): the
    data axis, and the pod axis too where the tokens are split over it
    (the reference averages over the data axis and leaves a per-pod
    value to its replicated output)."""
    m = cfg.moe
    t_loc = x_loc.shape[0]
    weights, idx, probs = _route({"router": router}, m, x_loc)
    cap = _capacity(t_loc, m.top_k, m.num_experts, capacity_factor)
    dest, src_token = _dispatch_indices(idx, e_pad, cap)
    buf = _dispatch(x_loc, dest, src_token, e_pad, cap)
    # data-axis exchange: (E, C, D) -> (E / ep, ep C, D); this process's
    # experts receive their slots from every process of the axis
    buf = compat.all_to_all(buf, data_axis, split_axis=0, concat_axis=1)
    # each model-axis process uses its F block (the slots' gradient sums
    # over the axis); its partial sums close the F contraction
    nf = model_blocks(m.expert_d_ff)
    out = tp_out(_expert_ffn(tp_in(buf, nf), w_gate, w_up, w_down,
                             cfg.activation), nf)
    out = compat.all_to_all(out, data_axis, split_axis=1, concat_axis=0)
    y = _combine(out, dest, weights, t_loc, m.top_k)
    aux = None
    if with_aux:
        aux = compat.reduce_from(
            aux_load_balance_loss(probs, idx, m.num_experts), aux_axes) \
            / compat.axis_size(aux_axes)
    return y, aux


def apply_moe_ep(p: Params, cfg: ModelConfig, x2d: torch.Tensor,
                 ctx: DistContext, capacity_factor: float = 1.25,
                 with_aux: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Expert-parallel MoE over ctx.mesh. ``p`` holds this process's
    expert blocks (``local_params``). x2d (T, D) is this process's tokens
    (its rows of the batch). Tokens the caller holds whole (the batch
    replicated) are cut into this process's share where they divide over
    the batch axes and gathered back after; else every process sends all
    of them (capacity and drops then those of the single-shard path over
    the same tokens; no gradient: each expert would see each token once
    per process)."""
    m = cfg.moe
    e_pad = p["router"].shape[-1]
    # an enclosing manual region (the pod-manual gradient region) has
    # already split the tokens over its axes
    batch_axes = tuple(a for a in ctx.batch_axes
                       if a not in compat.manual_axes_of(ctx.mesh))
    n = compat.axis_size(batch_axes)
    split = not ctx.batch_sharded and x2d.shape[0] % n == 0
    x_in = x2d
    if split:
        t = x2d.shape[0] // n
        x_in = x2d[compat.axis_index(batch_axes) * t:][:t]
    elif not ctx.batch_sharded and n > 1 and torch.is_grad_enabled() \
            and x2d.requires_grad:
        raise ValueError("apply_moe_ep: under grad the tokens must divide "
                         "over the batch axes")
    y, aux = _moe_ep_body(x_in, p["router"], p["w_gate"], p["w_up"],
                          p["w_down"], cfg=cfg, data_axis=ctx.ep_axis,
                          model_axis=ctx.model_axis,
                          capacity_factor=capacity_factor, e_pad=e_pad,
                          with_aux=with_aux, aux_axes=batch_axes)
    if split:
        y = compat.gather_from(y, batch_axes, dim=0)
    if m.num_shared_experts > 0:
        y = y + _shared_expert(p, cfg, x2d)
    return y, aux


def ep_tiles(p: Params, ctx: DistContext) -> bool:
    """Whether the (padded) experts tile the expert-parallel axis, as the
    reference's shard_map needs (``local_params`` then keeps each
    process's block)."""
    return p["router"].shape[-1] % compat.axis_size(ctx.ep_axis) == 0


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = 1.25, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux scalar or ``None``). The
    expert-parallel path when a context with a mesh and ``use_ep`` is
    active and the experts tile the expert axis; else the local path over
    all B*S tokens of the call. Where the reference would fall back to
    its local path because the tokens do not tile the batch axes (batch-1
    decode over several data processes), the port runs its EP body with
    every process's tokens whole, which gives that path's result and
    keeps the experts split."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    ctx = get_context()
    use_ep = (ctx is not None and ctx.mesh is not None and ctx.use_ep
              and ep_tiles(p, ctx))
    if use_ep:
        y, aux = apply_moe_ep(p, cfg, x2d, ctx, capacity_factor, with_aux)
    else:
        y, aux = apply_moe_local(p, cfg, x2d, capacity_factor, with_aux)
    return y.reshape(b, s, d), aux
