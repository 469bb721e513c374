"""Inference engine: bucketed-batch execution of one model
(port of ``repro/serving/engine.py``).

The reference compiles one XLA executable per power-of-two batch bucket and
pads incoming batches up to the bucket (DESIGN.md §3.2). The port captures
one CUDA graph per bucket (``serving/graphs.py``: at the bucket's first
call, ``warmup`` or the first batch of its size, all of the engine's graphs
in one memory pool) and replays it; on the CPU the same buckets run
eagerly. It keeps the reference's buckets, zero padding and split of a
batch larger than the last bucket, so a profiled batch size costs what the
served one does. ``infer`` returns the scores as a tensor on the params'
device only once they exist there (the counterpart of the reference's
``block_until_ready``): ``EngineBackend.profile`` times it, and that time
becomes the planner's ``batch_runtimes``.

Two logical devices can host replicas of one model, and then the threaded
server's consumer threads call the same engine at once: a lock holds each
call's copy in, replay and copy of the scores out of the graph's static
output together, so that no replay overwrites another caller's scores.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.convert import tensor_leaves
from repro_torch.core.execution import EngineBackend, profile_backend
from repro_torch.core.profiles import ModelProfile, ValidationRecord
from repro_torch.serving.graphs import GraphCache

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
        self.graphs = GraphCache(self.device)
        self._lock = threading.Lock()

    def _run(self, tokens: np.ndarray) -> torch.Tensor:
        tok = np.ascontiguousarray(tokens)
        with self._lock, torch.no_grad():
            (scores,) = self.graphs.run(
                ("bucket",) + tok.shape + (str(tok.dtype),),
                lambda t: (self._fn(self.params, t),), tok)
            if self.device.type == "cuda":
                scores = scores.clone()
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
