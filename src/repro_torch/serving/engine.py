"""Inference engine: bucketed-batch execution of one model
(port of ``repro/serving/engine.py``).

The reference compiles one XLA executable per power-of-two batch bucket and
pads incoming batches up to the bucket (DESIGN.md §3.2). PyTorch runs
eagerly, so there is nothing to compile; the engine keeps the same buckets,
the same zero padding and the same split of a batch larger than the last
bucket, so a profiled batch size costs what the served one does, and
``warmup`` runs each bucket once. ``infer`` returns the scores as a tensor
on the params' device only once they exist there (the counterpart of the
reference's ``block_until_ready``): ``EngineBackend.profile`` times it, and
that time becomes the planner's ``batch_runtimes``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.convert import tensor_leaves
from repro_torch.core.execution import EngineBackend, profile_backend
from repro_torch.core.profiles import ModelProfile, ValidationRecord

__all__ = ["InferenceEngine", "profile_engine"]


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class InferenceEngine:
    """Wraps ``apply_fn(params, tokens) -> scores`` with bucketed batches.

    Runs on the device its params lie on; params without a tensor (a stub
    model) run on ``"cuda"``, which raises without a card."""

    def __init__(self, name: str, apply_fn: Callable, params,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128)):
        self.name = name
        self.params = params
        self.buckets = tuple(sorted(buckets))
        self._fn = apply_fn
        leaves = tensor_leaves(params)
        self.device = leaves[0].device if leaves else resolve_device("cuda")

    def _run(self, tokens: np.ndarray) -> torch.Tensor:
        tok = torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device)
        with torch.no_grad():
            scores = self._fn(self.params, tok)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return scores

    def warmup(self, seq_len: int) -> None:
        for b in self.buckets:
            self._run(np.zeros((b, seq_len), np.int32))

    def infer(self, tokens: np.ndarray) -> torch.Tensor:
        """tokens (n, L) -> scores (n, C) on the engine's device, complete
        when returned; pads to the bucket internally."""
        n = tokens.shape[0]
        b = _bucket(n, self.buckets)
        if n > self.buckets[-1]:
            # split oversized batches
            out = [self.infer(tokens[i:i + self.buckets[-1]])
                   for i in range(0, n, self.buckets[-1])]
            return torch.cat(out)
        if b != n:
            pad = np.zeros((b - n,) + tokens.shape[1:], tokens.dtype)
            tokens = np.concatenate([tokens, pad])
        return self._run(tokens)[:n]


def profile_engine(engine: InferenceEngine, seq_len: int,
                   batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                   repeats: int = 5, mem_bytes: Optional[float] = None,
                   validation: Optional[ValidationRecord] = None
                   ) -> ModelProfile:
    """Measure wall-clock batch runtimes (median of ``repeats``).

    Thin wrapper over ``profile_backend(EngineBackend(...))`` — the single
    measurement implementation — kept for call-site convenience."""
    backend = EngineBackend({engine.name: engine})
    return profile_backend(backend, engine.name, batch_sizes=batch_sizes,
                           seq_len=seq_len, repeats=repeats,
                           mem_bytes=mem_bytes, validation=validation)
