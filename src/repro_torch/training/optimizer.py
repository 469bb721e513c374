"""AdamW on pytrees of tensors (port of ``repro/training/optimizer.py``).

Moments are float32 whatever the (typically bf16) parameter dtype; the
update math runs in float32 and casts back, as the reference does. Where
the reference returns new trees, ``adamw_update`` runs under
``torch.no_grad()`` and writes the new params and moments IN PLACE into
the tensors it is given (and returns those same trees), so that the card
never holds two copies of the weights. A leaf of more than ``SLICE``
elements (a rep-stacked projection of a large model: falcon-mamba-7b's
``in_proj`` at 40 layers holds 2.7 G) is updated, and its share of the
gradient norm summed, one flat slice at a time, so the float32
temporaries of the update stay near a GiB whatever the leaf's size; each
element's update is the same arithmetic either way.

Sharded state (``opt_state_pspecs``, the reference's ZeRO-1): under a mesh
the params and moments are DTensors placed by the sharding rules, and each
moment is also split over the pod axis on its first unsharded dim. Then
``adamw_update`` takes each leaf's block of the global gradient (a local
tensor shaped like the param's local block, as ``make_train_step`` gives
it): each process updates its block of each moment with the same
element-wise math (walked in ``SLICE`` pieces) and the matching block of
its param shard, and the new blocks are gathered over the pod axis into
the param's shard. The gradient norm sums each block's squares over the
mesh axes its leaf is split over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed import compat
from repro_torch.distributed.sharding import P, _map_axes

__all__ = ["AdamWConfig", "lr_schedule", "init_opt_state", "global_norm",
           "adamw_update", "opt_state_pspecs"]

Pytree = Any


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    # linear warmup then cosine decay to lr * min_lr_ratio
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor or int), f32."""
    step = torch.as_tensor(step).float()
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_opt_state(params: Pytree) -> Dict[str, Any]:
    """{"m", "v": f32 zeros in the params' structure, on their devices;
    "step": an int32 zero}."""
    flat = tree_lib.leaves(params)
    device = flat[0].device if flat else None

    def zeros_like_f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_lib.tree_map(zeros_like_f32, params),
            "v": tree_lib.tree_map(zeros_like_f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


SLICE = 1 << 26   # elements of a leaf updated together


def _slices(*ts: torch.Tensor):
    """Same-shaped tensors cut into aligned flat slices of at most SLICE
    elements (views; written in place through them), or whole where they
    are small or not all contiguous."""
    if ts[0].numel() <= SLICE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, ts[0].numel(), SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


def _sum_sq(leaf: torch.Tensor) -> torch.Tensor:
    parts = [torch.sum(torch.square(s.float())) for (s,) in _slices(leaf)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [_sum_sq(leaf) for leaf in tree_lib.leaves(tree)])))


def _is_decayable(path) -> bool:
    """No weight decay on norms / biases / 1-D params (standard practice):
    the name is the last dict key on the leaf's path."""
    name = None
    for k in path:
        if isinstance(k, str):
            name = k
    return name not in ("scale", "bias", "conv_b", "bq", "bk", "bv",
                        "dt_proj_b", "A_log", "D", "q_norm_scale",
                        "k_norm_scale")


def _update_slices(p_leaf: torch.Tensor, g_leaf: torch.Tensor,
                   m_leaf: torch.Tensor, v_leaf: torch.Tensor, decay: bool,
                   cfg: AdamWConfig, clip, lr, bc1, bc2) -> None:
    """One leaf's AdamW update, in place on p, m and v, slice by slice."""
    for p, g, m, v in _slices(p_leaf, g_leaf, m_leaf, v_leaf):
        gf = g.float() * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gf))
        del gf
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if decay:
            update = update + cfg.weight_decay * pf
        p.copy_(pf - lr * update)


def _split_axes(t) -> Tuple[str, ...]:
    """The mesh axes a DTensor is split over."""
    return tuple(a for a, pl in zip(t.device_mesh.mesh_dim_names,
                                    t.placements)
                 if isinstance(pl, compat.Shard))


def _global_norm_blocks(params: List, grads: List[torch.Tensor]
                        ) -> torch.Tensor:
    """The global gradient norm from each DTensor param's block of its
    gradient: the blocks' squares summed, then over the axes each leaf is
    split over (one sum per set of axes)."""
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for p, g in zip(params, grads):
        sq = _sum_sq(g)
        axes = _split_axes(p)
        groups[axes] = groups[axes] + sq if axes in groups else sq
    mesh = params[0].device_mesh
    total = sum(compat.psum(v, axes, mesh) for axes, v in groups.items())
    return torch.sqrt(total)


def _update_block(p_dt, g: torch.Tensor, m_dt, v_dt, decay: bool,
                  cfg: AdamWConfig, clip, lr, bc1, bc2) -> None:
    """One DTensor leaf's update from its block ``g`` of the gradient.
    Where the moments are split over more axes than the param (ZeRO-1's
    pod axis), this process updates the moments' block of its shard and
    the new blocks are gathered over those axes."""
    mesh = p_dt.device_mesh
    p_loc = p_dt.to_local()
    extra = [(a, mp) for a, pp, mp in zip(mesh.mesh_dim_names,
                                          p_dt.placements, m_dt.placements)
             if pp != mp]
    if not extra:
        _update_slices(p_loc, g, m_dt.to_local(), v_dt.to_local(), decay,
                       cfg, clip, lr, bc1, bc2)
        return
    _, p_off = compat.local_shape_and_offset(p_dt.shape, mesh,
                                             p_dt.placements)
    m_shape, m_off = compat.local_shape_and_offset(p_dt.shape, mesh,
                                                   m_dt.placements)
    block = tuple(slice(mo - po, mo - po + n)
                  for mo, po, n in zip(m_off, p_off, m_shape))
    new = p_loc[block].clone(memory_format=torch.contiguous_format)
    _update_slices(new, g[block].contiguous(), m_dt.to_local(),
                   v_dt.to_local(), decay, cfg, clip, lr, bc1, bc2)
    for axis, mp in extra:
        new = compat.all_gather(new, axis, dim=mp.dim, mesh=mesh)
    p_loc.copy_(new)


@torch.no_grad()
def adamw_update(params: Pytree, grads: Pytree, state: Dict[str, Any],
                 cfg: AdamWConfig
                 ) -> Tuple[Pytree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and ``state`` (see the
    module docstring). ``grads`` has the params' structure (or is the flat
    list of their leaves in flatten order): whole tensors, or where the
    params are DTensors each leaf's block of the global gradient. Returns
    (params, state, {"grad_norm", "lr"}), every scalar a tensor on the
    params' device."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    flat_g = grads if isinstance(grads, list) else tree_lib.leaves(grads)
    flat_p, _ = tree_lib.flatten_with_path(params)
    sharded = bool(flat_p) and isinstance(flat_p[0][1], compat.DTensor)
    gnorm = (_global_norm_blocks([p for _, p in flat_p], flat_g) if sharded
             else global_norm(flat_g))
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    flat_m = tree_lib.leaves(state["m"])
    flat_v = tree_lib.leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: params, grads and moments differ "
                         "in structure")
    for (path, p_leaf), g_leaf, m_leaf, v_leaf in zip(flat_p, flat_g,
                                                      flat_m, flat_v):
        decay = _is_decayable(path)
        if sharded:
            _update_block(p_leaf, g_leaf, m_leaf, v_leaf, decay, cfg, clip,
                          lr, bc1, bc2)
        else:
            _update_slices(p_leaf, g_leaf, m_leaf, v_leaf, decay, cfg, clip,
                           lr, bc1, bc2)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_state_pspecs(param_pspecs: Pytree, zero1_axis: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Moment specs mirror the param specs; with ``zero1_axis`` the first
    unsharded dim of each moment is additionally sharded over that axis
    (ZeRO-1; see the module docstring)."""
    def moment_spec(spec: P) -> P:
        if zero1_axis is None:
            return spec
        parts = list(spec) if len(spec) else []
        for i, axis in enumerate(parts):
            if axis is None:
                parts[i] = zero1_axis
                return P(*parts)
        return spec  # every dim already sharded

    specs = _map_axes(moment_spec, param_pspecs)
    return {"m": specs, "v": specs, "step": P()}
