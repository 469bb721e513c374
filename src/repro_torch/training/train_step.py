"""Train-step factory: loss, gradients and AdamW (port of
``repro/training/train_step.py``), with

* activation recomputation (``model.train_loss(remat=...)``: each block
  under ``torch.utils.checkpoint``; policy "full" or "dots"),
* gradient accumulation over microbatches, in float32, averaged,
* under a mesh, data-parallel gradients over the batch axes and the
  int8-compressed gradient exchange across the 'pod' axis
  (``compress_pod_grads``): in-pod reduction stays f32, only the
  inter-pod exchange is quantised (per-tensor symmetric int8).

Where the reference takes ``jax.value_and_grad`` of a pure function, the
port marks every param leaf ``requires_grad`` and runs ``backward()``;
each leaf's ``.grad`` is read, then dropped, and ``adamw_update`` writes
the new params and moments in place.

Under a mesh (the ambient ``DistContext``) the step takes the global
batch, the same on every process, and each process computes on its rows
of it. The params are DTensors placed by the sharding rules, and the model
computes on their blocks (``distributed.sharding.local_params``); the loss
is the global mean, and each process's backward leaves in every leaf's
``.grad`` its block of the global gradient (summed over the batch axes;
reduce-scattered where the leaf is split over one). With
``compress_pod_grads`` and a 'pod' axis, the gradient region is manual
over the pod: each pod computes the mean loss of its own slice of the
batch on its (data, model) sub-mesh, so the blocks are summed over 'data'
only, exchanged across pods as int8 (``compressed_pod_allreduce``, the
mean of the dequantised blocks, each leaf's scale taken over its whole
gradient), and the loss is the mean over pods. ``adamw_update`` then
updates each process's blocks, ZeRO-1 over the pod.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compat
from repro_torch.distributed.context import get_context, use_context
from repro_torch.distributed.sharding import local_rows
from repro_torch.models import model as model_lib
from repro_torch.training.optimizer import (AdamWConfig, _split_axes,
                                            adamw_update)

__all__ = ["TrainStepConfig", "make_train_step", "as_batch",
           "quantize_int8", "dequantize_mean", "compressed_pod_allreduce"]

Pytree = Any


@dataclass(frozen=True)
class TrainStepConfig:
    remat: bool = True
    remat_policy: str = "full"  # "full" | "dots" (save matmul outputs)
    num_microbatches: int = 1
    # int8-quantised gradient exchange over the pod axis (multi-pod only)
    compress_pod_grads: bool = False
    aux_loss_coef: float = 0.01


# ---------------------------------------------------------------------------
# int8 pod-axis gradient exchange
# ---------------------------------------------------------------------------

def quantize_int8(g: torch.Tensor, axes: Tuple[str, ...] = ()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 block, f32 scale) of one gradient leaf, as the reference
    quantises it: scale = max|g| / 127 + 1e-12, q = clip(round(g / scale),
    -127, 127), rounding half to even. ``axes``: the mesh axes ``g`` is one
    block of the leaf over, whose max|g| is taken over them."""
    gf = g.float()
    top = gf.abs().max()
    if axes:
        top = compat.pmax(top, axes)
    scale = top / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_mean(q_all: torch.Tensor, s_all: torch.Tensor
                    ) -> torch.Tensor:
    """The mean over the pods' blocks: q_all (npods, ...) int8, s_all
    (npods,) f32 -> f32, the sum of the dequantised blocks over npods."""
    npods = q_all.shape[0]
    deq = q_all.float() * s_all.reshape((npods,) + (1,) * (q_all.dim() - 1))
    return torch.sum(deq, dim=0) / npods


def _compressed_pod_allreduce_leaf(g: torch.Tensor, axis: str,
                                   axes: Tuple[str, ...] = ()
                                   ) -> torch.Tensor:
    """Mean over the pod axis with int8 on the wire (``axes`` as
    ``quantize_int8``'s)."""
    q, scale = quantize_int8(g, axes)
    q_all = compat.all_gather(q[None], axis, dim=0)      # int8 across pods
    s_all = compat.all_gather(scale.reshape(1), axis, dim=0)
    return dequantize_mean(q_all, s_all).to(g.dtype)


def compressed_pod_allreduce(grads: List[torch.Tensor],
                             pod_axis: str = "pod",
                             axes: Optional[List[Tuple[str, ...]]] = None
                             ) -> List[torch.Tensor]:
    """The exchange leaf by leaf: each process's gradients are its pod's
    (loss averaged over the pod's batch) and leave as the cross-pod
    mean. ``axes``: per leaf, the mesh axes its block is split over."""
    axes = axes or [()] * len(grads)
    return [_compressed_pod_allreduce_leaf(g, pod_axis, a)
            for g, a in zip(grads, axes)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, compat.DTensor) else t


def _microbatch(batch: Dict[str, Any], n: int, i: int) -> Dict[str, Any]:
    """Rows [i B/n, (i + 1) B/n) of every input of ``batch``."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} % microbatches {n} != 0")
        out[k] = x[i * (b // n):(i + 1) * (b // n)]
    return out


def _grads(leaves: List[torch.Tensor], loss: torch.Tensor
           ) -> List[torch.Tensor]:
    """d loss / d leaf for every leaf, by ``backward()``; the leaves'
    ``.grad`` is taken and cleared."""
    for p in leaves:
        p.grad = None
    loss.backward()
    grads = [_local(p.grad) if p.grad is not None
             else torch.zeros_like(_local(p)) for p in leaves]
    for p in leaves:
        p.grad = None
    return grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    ts_cfg: TrainStepConfig = TrainStepConfig()):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics): params and opt are the trees given, updated in place; the
    metrics ("loss", "ce", "aux_loss", "grad_norm", "lr") are detached
    scalar tensors on the params' device. ``batch`` holds numpy arrays
    or tensors (``tokens``, ``labels`` and the arch's extra input)."""
    def loss_fn(params, batch):
        return model_lib.train_loss(
            params, cfg, batch, remat=ts_cfg.remat,
            aux_coef=ts_cfg.aux_loss_coef, remat_policy=ts_cfg.remat_policy)

    def grads_of(params, batch, leaves):
        if ts_cfg.num_microbatches <= 1:
            loss, metrics = loss_fn(params, batch)
            grads = _grads(leaves, loss)
            return (loss.detach(), {k: v.detach() for k, v in
                                    metrics.items()}, grads)
        n = ts_cfg.num_microbatches
        grads = [torch.zeros(_local(p).shape, dtype=torch.float32,
                             device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(n):
            loss, _ = loss_fn(params, _microbatch(batch, n, i))
            for acc, g in zip(grads, _grads(leaves, loss)):
                acc.add_(g.float())
            loss_sum = loss_sum + loss.detach()
        loss = loss_sum / n
        grads = [g / n for g in grads]
        return loss, {"ce": loss, "aux_loss": torch.zeros_like(loss)}, grads

    def sharded_grads(params, batch, ctx):
        """This process's rows; each leaf's block of the gradient."""
        leaves = tree_lib.leaves(params)
        if not all(isinstance(p, compat.DTensor) for p in leaves):
            raise ValueError("train_step: under a mesh the params must be "
                             "DTensors placed by the sharding rules "
                             "(param_shardings, launch/train.py)")
        n = compat.axis_size(ctx.batch_axes, ctx.mesh)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"train_step: batch {rows} does not divide "
                             f"over {n} processes of {ctx.batch_axes}")
        for p in leaves:
            p.requires_grad_(True)
        rows = {k: local_rows(x, ctx) for k, x in batch.items()}
        if ts_cfg.compress_pod_grads and "pod" in ctx.mesh.mesh_dim_names:
            inner = dataclasses.replace(
                ctx, batch_axes=tuple(a for a in ctx.batch_axes
                                      if a != "pod"))
            with use_context(inner), compat.manual(("pod",)):
                loss, metrics, grads = grads_of(params, rows, leaves)
            with use_context(ctx):
                grads = compressed_pod_allreduce(grads, axes=[
                    tuple(a for a in _split_axes(p) if a != "pod")
                    for p in leaves])
                loss = compat.pmean(loss, "pod")
                metrics = {k: compat.pmean(v, "pod")
                           for k, v in metrics.items()}
        else:
            with use_context(ctx):
                loss, metrics, grads = grads_of(params, rows, leaves)
        return loss, metrics, grads

    def train_step(params, opt_state, batch
                   ) -> Tuple[Pytree, Pytree, Dict[str, torch.Tensor]]:
        ctx = get_context()
        if ctx is not None and ctx.mesh is not None:
            loss, metrics, grads = sharded_grads(params, batch, ctx)
        else:
            leaves = tree_lib.leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics, grads = grads_of(params, batch, leaves)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def as_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A numpy batch's inputs as tensors on ``device`` (token ids int64,
    frames and prefix embeddings float32), so a step reads no host
    memory."""
    out = {}
    for k, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        out[k] = t.long() if k in ("tokens", "labels") else t
    return out
