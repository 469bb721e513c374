"""Train-step factory: loss, gradients and AdamW (port of
``repro/training/train_step.py``), with

* activation recomputation (``model.train_loss(remat=...)``: each block
  under ``torch.utils.checkpoint``; policy "full" or "dots"),
* gradient accumulation over microbatches, in float32, averaged.

Where the reference takes ``jax.value_and_grad`` of a pure function, the
port marks every param leaf ``requires_grad`` and runs ``backward()``;
each leaf's ``.grad`` is read, then dropped, and ``adamw_update`` writes
the new params and moments in place. The reference's int8-compressed
gradient exchange over the pod axis (``compress_pod_grads``) waits for
the distributed port: asking for it raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.training.optimizer import AdamWConfig, adamw_update

__all__ = ["TrainStepConfig", "make_train_step", "as_batch"]

Pytree = Any


@dataclass(frozen=True)
class TrainStepConfig:
    remat: bool = True
    remat_policy: str = "full"  # "full" | "dots" (save matmul outputs)
    num_microbatches: int = 1
    # int8-quantised gradient exchange over the pod axis (multi-pod only)
    compress_pod_grads: bool = False
    aux_loss_coef: float = 0.01


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
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
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
    if ts_cfg.compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads: the int8 pod-axis gradient exchange needs "
            "the distributed port (ROADMAP, queue 1, item 3)")

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
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
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

    def train_step(params, opt_state, batch
                   ) -> Tuple[Pytree, Pytree, Dict[str, torch.Tensor]]:
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
