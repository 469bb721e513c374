"""Verbatim copy of ``repro/training/data.py``,
imports rewritten to ``repro_torch``.

Synthetic data pipeline: deterministic, seeded numpy token streams with a
Zipf-like unigram distribution and a copy structure a model can learn
(each sequence repeats a random n-gram pattern with noise), in whatever
input dict the architecture needs (tokens/labels, vision prefix
embeddings, encoder source frames); a background thread prefetches
batches ahead of the step. The same seed gives the JAX package's batches
bit for bit.
"""
from __future__ import annotations

import threading
import queue as queue_mod
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeCell, source_len, text_len


class SyntheticDataset:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, zipf_a: float = 1.2,
                 pattern_len: int = 16, noise: float = 0.05):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        self.pattern_len = pattern_len
        self.noise = noise
        # truncated-zipf unigram over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-zipf_a)
        self._probs = probs / probs.sum()

    def _sample_tokens(self, n: int) -> np.ndarray:
        return self.rng.choice(self.cfg.vocab_size, size=n, p=self._probs
                               ).astype(np.int32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = self.batch, self.seq_len
        s_text = s
        if cfg.frontend.kind == "vision":
            s_text = s - cfg.frontend.num_prefix_embeddings
        # periodic pattern + noise -> learnable structure
        pat = self._sample_tokens(b * self.pattern_len).reshape(
            b, self.pattern_len)
        reps = -(-(s_text + 1) // self.pattern_len)
        seq = np.tile(pat, (1, reps))[:, :s_text + 1]
        flip = self.rng.random(seq.shape) < self.noise
        seq = np.where(flip, self._sample_tokens(seq.size).reshape(seq.shape),
                       seq)
        batch: Dict[str, np.ndarray] = {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }
        if cfg.frontend.kind == "vision":
            batch["prefix_embeddings"] = self.rng.standard_normal(
                (b, cfg.frontend.num_prefix_embeddings,
                 cfg.frontend.frontend_dim)).astype(np.float32)
        if cfg.is_encoder_decoder:
            src = min(cfg.encdec.max_source_len, s)
            batch["source_frames"] = self.rng.standard_normal(
                (b, src, cfg.frontend.frontend_dim or cfg.d_model)
            ).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class PrefetchingLoader:
    """Background-thread double buffering (overlap host datagen with step)."""

    def __init__(self, dataset: SyntheticDataset, depth: int = 2):
        self.dataset = dataset
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            try:
                self._q.put(self.dataset.next_batch(), timeout=0.5)
            except queue_mod.Full:
                continue

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()


def dataset_for_cell(cfg: ModelConfig, shape: ShapeCell, seed: int = 0,
                     batch_override: Optional[int] = None
                     ) -> SyntheticDataset:
    return SyntheticDataset(cfg, batch_override or shape.global_batch,
                            shape.seq_len, seed=seed)
