"""Step builders shared by the launchers (port of ``repro/launch/steps.py``).

``serve_prefill`` / ``serve_decode`` fuse the paper's certainty estimation
(Eq. 5 top-2 gap) into the step, so the cascade gate costs one reduction
after the LM head: pred and certainty come from ``kernels.top2gap``
``argmax_gap``, which launches the top2gap kernel on the card.

Under a mesh (the ambient ``DistContext``) a step takes the global batch,
the same on every process, and runs on this process's rows of it when the
batch divides over the batch axes (else on the whole batch, replicated).
The model returns its logits gathered over the vocab; pred and certainty
come back for the global batch. The cache a step returns and takes is
this process's: its rows; its kv heads where the head counts tile the
model axis; with
``flash_decode``, its sequence chunk of each attention layer's cache over
every head (the reference's ``P(batch, 'model')`` cache layout), which
needs the cache length to divide over the model axis; and its channels
of each Mamba layer's states.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compat
from repro_torch.distributed.context import (DistContext, get_context,
                                             use_context)
from repro_torch.distributed.sharding import local_rows
from repro_torch.kernels.top2gap import argmax_gap
from repro_torch.models import attention as attn
from repro_torch.models import model as model_lib
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, make_train_step

__all__ = ["make_train", "make_serve_prefill", "make_serve_decode",
           "local_context", "seq_chunks"]


def make_train(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
               ts_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    return make_train_step(cfg, opt_cfg, ts_cfg)


def local_context(batch_size: int) -> Optional[DistContext]:
    """The ambient context, with ``batch_sharded`` saying whether a global
    batch of ``batch_size`` rows divides over its batch axes."""
    ctx = get_context()
    if ctx is None or ctx.mesh is None:
        return ctx
    n = compat.axis_size(ctx.batch_axes, ctx.mesh)
    return dataclasses.replace(ctx, batch_sharded=batch_size % n == 0)


def _global_rows(x: torch.Tensor, ctx: Optional[DistContext]
                 ) -> torch.Tensor:
    if ctx is None or ctx.mesh is None or not ctx.batch_sharded:
        return x
    return compat.all_gather(x, ctx.batch_axes, dim=0, mesh=ctx.mesh)


def seq_chunks(cache: Dict[str, Any], ctx: DistContext) -> Dict[str, Any]:
    """This process's sequence chunk of every attention layer's cache
    (``k``, ``v``: (reps, B, C, KV, hd) -> (reps, B, C / n, KV, hd)), the
    flash-decode layout; other leaves as they are."""
    axis = ctx.model_axis
    n, r = compat.axis_size(axis, ctx.mesh), compat.axis_index(axis, ctx.mesh)
    blocks = []
    for blk in cache["blocks"]:
        out = dict(blk)
        for name in ("k", "v"):
            if name in blk:
                c = blk[name].shape[2]
                if c % n:
                    raise ValueError(f"flash_decode: cache length {c} does "
                                     f"not divide over {n} model processes")
                out[name] = blk[name][:, :, r * (c // n):(r + 1) * (c // n)
                                      ].contiguous()
        blocks.append(out)
    return {**cache, "blocks": blocks}


def _pred_cert(logits, ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.no_grad():
        pred, cert = argmax_gap(logits)
    return _global_rows(pred, ctx), _global_rows(cert, ctx)


def make_serve_prefill(cfg: ModelConfig,
                       cache_len: Optional[int] = None) -> Callable:
    """prefill_step(params, batch) -> (pred (B,) i32, certainty (B,) f32,
    this process's cache)."""
    def prefill_step(params, batch: Dict[str, Any]
                     ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        ctx = local_context(np.shape(batch["tokens"])[0])
        local = {k: local_rows(v, ctx) for k, v in batch.items()}
        with use_context(ctx), torch.no_grad():
            logits, cache = model_lib.prefill(params, cfg, local, cache_len)
            if attn.flash_decode_on(cfg):
                cache = seq_chunks(cache, ctx)
            pred, cert = _pred_cert(logits, ctx)
        return pred, cert, cache

    return prefill_step


def make_serve_decode(cfg: ModelConfig) -> Callable:
    """decode_step(params, cache, tokens (B, 1), cache_index) -> (pred,
    certainty, cache): this process's cache, updated in place."""
    def decode_step(params, cache, tokens, cache_index
                    ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        ctx = local_context(np.shape(tokens)[0])
        with use_context(ctx), torch.no_grad():
            ci = cache_index
            if isinstance(ci, torch.Tensor) and ci.dim() == 1:
                ci = local_rows(ci, ctx)
            logits, cache = model_lib.decode_step(
                params, cfg, local_rows(tokens, ctx), cache, ci)
            pred, cert = _pred_cert(logits, ctx)
        return pred, cert, cache

    return decode_step
