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
element's update is the same arithmetic either way. The reference's
``opt_state_pspecs`` (ZeRO-1 sharding over the pod axis) waits for the
distributed port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib

__all__ = ["AdamWConfig", "lr_schedule", "init_opt_state", "global_norm",
           "adamw_update"]

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


def global_norm(tree: Pytree) -> torch.Tensor:
    leaves = []
    for leaf in tree_lib.leaves(tree):
        parts = [torch.sum(torch.square(s.float())) for (s,) in _slices(leaf)]
        leaves.append(parts[0] if len(parts) == 1
                      else torch.sum(torch.stack(parts)))
    return torch.sqrt(torch.sum(torch.stack(leaves)))


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


@torch.no_grad()
def adamw_update(params: Pytree, grads: Pytree, state: Dict[str, Any],
                 cfg: AdamWConfig) -> Tuple[Pytree, Dict[str, Any],
                                            Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and ``state`` (see the
    module docstring). ``grads`` has the params' structure (or is the flat
    list of their leaves in flatten order). Returns (params, state,
    {"grad_norm", "lr"}), every scalar a tensor on the params' device."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    flat_g = grads if isinstance(grads, list) else tree_lib.leaves(grads)
    gnorm = global_norm(flat_g)
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    flat_p, _ = tree_lib.flatten_with_path(params)
    flat_m = tree_lib.leaves(state["m"])
    flat_v = tree_lib.leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: params, grads and moments differ "
                         "in structure")
    for (path, p_leaf), g_leaf, m_leaf, v_leaf in zip(flat_p, flat_g,
                                                      flat_m, flat_v):
        decay = _is_decayable(path)
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
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
