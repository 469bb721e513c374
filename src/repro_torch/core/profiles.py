"""Verbatim copy of ``repro/core/profiles.py``,
imports rewritten to ``repro_torch``.

Model profiles: everything the gear planner knows about one model.

A profile is measured (tiny real models on CPU; paper §C.1 "profiles all
models with different batch sizes") or derived from the analytical TPU-v5e
cost model (`repro.profiling.cost_model`) for the assigned big
architectures. It carries:

* ``batch_runtimes`` — wall seconds for a forward pass at each profiled batch
  size (per replica, on its slice); interpolated in between.
* ``mem_bytes`` — HBM footprint of one replica (weights + workspace).
* per-validation-sample ``certs`` / ``correct`` / ``preds`` arrays — the
  simulator replays these to decide cascading and score accuracy (App. C).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class ValidationRecord:
    """Per-sample behaviour of one model on the registered validation set."""
    certs: np.ndarray          # (N,) float
    correct: np.ndarray        # (N,) bool
    preds: Optional[np.ndarray] = None  # (N,) int (optional)

    @property
    def accuracy(self) -> float:
        return float(self.correct.mean())

    def __post_init__(self):
        self.certs = np.asarray(self.certs, np.float64)
        self.correct = np.asarray(self.correct, bool)
        if self.preds is not None:
            self.preds = np.asarray(self.preds)
        # explicit ValueError, not assert: validation must survive python -O
        if self.certs.shape != self.correct.shape:
            raise ValueError(
                f"certs/correct shape mismatch: {self.certs.shape} vs "
                f"{self.correct.shape}")
        if self.certs.size == 0:
            raise ValueError("a validation record needs >= 1 sample")
        if self.preds is not None and \
                self.preds.shape[:1] != self.certs.shape[:1]:
            raise ValueError(
                f"preds length {self.preds.shape} does not match "
                f"{self.certs.shape} validation samples")


@dataclass
class ModelProfile:
    name: str
    mem_bytes: float
    batch_sizes: np.ndarray            # (K,) profiled batch sizes, ascending
    batch_runtimes: np.ndarray         # (K,) seconds per *batch*
    validation: ValidationRecord
    # number of accelerator devices one replica occupies (TP slice size);
    # the paper's unit is 1 GPU — on TPU a replica may span a slice.
    devices_per_replica: int = 1

    def __post_init__(self):
        self.batch_sizes = np.asarray(self.batch_sizes, np.float64)
        self.batch_runtimes = np.asarray(self.batch_runtimes, np.float64)
        # explicit ValueError, not assert: validation must survive python -O
        if self.batch_sizes.shape != self.batch_runtimes.shape:
            raise ValueError(
                f"{self.name}: batch_sizes/batch_runtimes shape mismatch: "
                f"{self.batch_sizes.shape} vs {self.batch_runtimes.shape}")
        if self.batch_sizes.size == 0:
            raise ValueError(f"{self.name}: needs >= 1 profiled batch size")
        if np.any(self.batch_sizes <= 0):
            raise ValueError(f"{self.name}: batch sizes must be positive")
        if np.any(~np.isfinite(self.batch_runtimes)) or \
                np.any(self.batch_runtimes < 0):
            raise ValueError(
                f"{self.name}: batch runtimes must be finite and "
                f">= 0, got {self.batch_runtimes.tolist()}")
        order = np.argsort(self.batch_sizes)
        self.batch_sizes = self.batch_sizes[order]
        self.batch_runtimes = self.batch_runtimes[order]

    # -- runtime model ------------------------------------------------------
    def runtime(self, batch: float) -> float:
        """Seconds to run one batch of the given size (linear interp,
        linear extrapolation beyond the profiled range)."""
        bs, rt = self.batch_sizes, self.batch_runtimes
        if batch <= bs[0]:
            return float(rt[0] * batch / bs[0]) if bs[0] > 0 else float(rt[0])
        if batch >= bs[-1]:
            # extrapolate with the marginal cost of the last segment
            if len(bs) >= 2:
                slope = (rt[-1] - rt[-2]) / max(bs[-1] - bs[-2], 1e-9)
            else:
                slope = rt[-1] / bs[-1]
            return float(rt[-1] + slope * (batch - bs[-1]))
        return float(np.interp(batch, bs, rt))

    def runtime_per_sample(self, batch: float = 1.0) -> float:
        return self.runtime(batch) / max(batch, 1.0)

    def max_throughput(self) -> float:
        """Samples/sec at the largest profiled batch."""
        b = self.batch_sizes[-1]
        return float(b / self.runtime(b))

    @property
    def accuracy(self) -> float:
        return self.validation.accuracy

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "mem_bytes": self.mem_bytes,
            "batch_sizes": self.batch_sizes.tolist(),
            "batch_runtimes": self.batch_runtimes.tolist(),
            "devices_per_replica": self.devices_per_replica,
            "validation": {
                "certs": self.validation.certs.tolist(),
                "correct": self.validation.correct.tolist(),
            },
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ModelProfile":
        return cls(
            name=d["name"], mem_bytes=d["mem_bytes"],
            batch_sizes=np.asarray(d["batch_sizes"]),
            batch_runtimes=np.asarray(d["batch_runtimes"]),
            devices_per_replica=d.get("devices_per_replica", 1),
            validation=ValidationRecord(
                certs=np.asarray(d["validation"]["certs"]),
                correct=np.asarray(d["validation"]["correct"], bool)))


ProfileSet = Dict[str, ModelProfile]


def profile_digest(profiles: ProfileSet) -> str:
    """Stable hash of everything the planner consumed from the profiles
    (runtimes, memory, validation behaviour). Recorded in a plan's
    ``PlanProvenance`` so the online monitor can tell "this plan was built
    from different profiles" apart from workload drift."""
    import hashlib
    h = hashlib.sha256()
    for name in sorted(profiles):
        p = profiles[name]
        h.update(name.encode())
        h.update(np.float64(p.mem_bytes).tobytes())
        h.update(np.asarray(p.batch_sizes, np.float64).tobytes())
        h.update(np.asarray(p.batch_runtimes, np.float64).tobytes())
        h.update(np.asarray(p.validation.certs, np.float64).tobytes())
        h.update(np.asarray(p.validation.correct, bool).tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Token-level profiles (generation workloads, DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclass
class TokenProfile:
    """Everything the token-level serving stack knows about one model.

    The one-shot ``ModelProfile`` prices a request as a single batched
    forward; generation splits it into a prompt-length-proportional prefill
    and a sequence of per-token decode steps whose cost depends on how many
    requests share the step. The per-sample validation record becomes a
    per-TOKEN record: each validation sample carries a generation length and
    a stream of per-token certainty gaps, which ``StreamingCertainty`` folds
    exactly as the real engine folds live logit gaps.

    ``kv_bytes_per_slot`` is the HBM cost of keeping ONE request resident
    in the decode batch (its KV-cache slot) — the placement constraint the
    planner charges next to weights.
    """
    name: str
    prefill_per_token: float           # seconds per prompt token
    decode_batch_sizes: np.ndarray     # (K,) profiled decode batch sizes
    decode_step_runtimes: np.ndarray   # (K,) seconds per decode STEP
    kv_bytes_per_slot: float           # bytes of KV cache per resident slot
    gen_len: np.ndarray                # (N,) tokens generated per val sample
    gaps: np.ndarray                   # (N, L) per-token certainty gaps
    correct: np.ndarray                # (N,) correctness if resolved here

    def __post_init__(self):
        self.decode_batch_sizes = np.asarray(self.decode_batch_sizes,
                                             np.float64)
        self.decode_step_runtimes = np.asarray(self.decode_step_runtimes,
                                               np.float64)
        self.gen_len = np.asarray(self.gen_len, np.int64)
        self.gaps = np.asarray(self.gaps, np.float64)
        self.correct = np.asarray(self.correct, bool)
        # explicit ValueError, not assert: validation must survive python -O
        if self.decode_batch_sizes.shape != self.decode_step_runtimes.shape \
                or self.decode_batch_sizes.size == 0:
            raise ValueError(
                f"{self.name}: decode batch grid mismatch "
                f"{self.decode_batch_sizes.shape} vs "
                f"{self.decode_step_runtimes.shape}")
        if self.prefill_per_token < 0 or self.kv_bytes_per_slot < 0:
            raise ValueError(
                f"{self.name}: prefill_per_token and kv_bytes_per_slot "
                f"must be >= 0")
        n = self.gen_len.shape[0]
        if self.gaps.shape[0] != n or self.correct.shape[0] != n:
            raise ValueError(
                f"{self.name}: gen_len/gaps/correct must align "
                f"({n} vs {self.gaps.shape[0]} vs {self.correct.shape[0]})")
        if n == 0:
            raise ValueError(f"{self.name}: needs >= 1 validation sample")
        if int(self.gen_len.max()) > self.gaps.shape[1]:
            raise ValueError(
                f"{self.name}: gap stream shorter than max gen_len "
                f"({self.gaps.shape[1]} < {int(self.gen_len.max())})")
        order = np.argsort(self.decode_batch_sizes)
        self.decode_batch_sizes = self.decode_batch_sizes[order]
        self.decode_step_runtimes = self.decode_step_runtimes[order]

    @property
    def validation_n(self) -> int:
        return int(self.gen_len.shape[0])

    def prefill_runtime(self, prompt_tokens: int) -> float:
        return self.prefill_per_token * max(int(prompt_tokens), 1)

    def decode_step_runtime(self, batch: float) -> float:
        """Seconds for one decode step over ``batch`` resident requests
        (same interp/extrapolation scheme as ``ModelProfile.runtime``)."""
        bs, rt = self.decode_batch_sizes, self.decode_step_runtimes
        if batch <= bs[0]:
            return float(rt[0])
        if batch >= bs[-1]:
            if len(bs) >= 2:
                slope = (rt[-1] - rt[-2]) / max(bs[-1] - bs[-2], 1e-9)
            else:
                slope = rt[-1] / bs[-1]
            return float(rt[-1] + slope * (batch - bs[-1]))
        return float(np.interp(batch, bs, rt))


TokenProfileSet = Dict[str, TokenProfile]


def synthetic_token_family(names: Sequence[str], base_step: float = 2e-4,
                           step_ratio: float = 2.5, base_acc: float = 0.74,
                           acc_gain: float = 0.06, n_val: int = 2048,
                           max_gen: int = 64, mean_gen: int = 24,
                           kv_base: float = 2e7, seed: int = 0,
                           batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
                           batch_efficiency: float = 0.3,
                           ) -> TokenProfileSet:
    """Token-level analogue of ``synthetic_family``: same cascade-friendly
    difficulty structure, but each validation sample carries a generation
    length and a per-token gap stream instead of one scalar certainty.

    Easy samples (difficulty below the model's strength) produce gap
    streams that settle HIGH; hard samples settle LOW with extra per-token
    noise — so a streaming fold over a few tokens separates them, which is
    what makes MID-stream escalation profitable. Generation lengths grow
    with difficulty (hard questions get long answers), clipped to
    ``max_gen``. Decode-step cost scales sub-linearly in the resident batch
    (memory-bound decode); kv bytes scale with the model like weights do.
    """
    rng = np.random.default_rng(seed)
    difficulty = rng.beta(1.6, 3.2, size=n_val)
    gen = np.clip((mean_gen * (0.5 + 1.5 * difficulty))
                  .astype(np.int64), 4, max_gen)
    out: TokenProfileSet = {}
    for i, name in enumerate(names):
        strength = base_acc + acc_gain * i
        k = 9.0
        p_correct = 1.0 / (1.0 + np.exp(-k * (strength - difficulty)))
        correct = rng.random(n_val) < p_correct
        margin = np.abs(strength - difficulty)
        # per-token stream: settles at the sample's margin, with early
        # tokens noisier (the stream "finds its level" within ~4 tokens)
        t = np.arange(max_gen)[None, :]
        settle = 1.0 - np.exp(-(t + 1) / 3.0)
        noise = rng.normal(0, 0.08, (n_val, max_gen)) * (1.2 - settle)
        gaps = np.clip(margin[:, None] * settle + noise, 0.0, None)
        step1 = base_step * (step_ratio ** i)
        bs = np.asarray(batch_sizes, np.float64)
        out[name] = TokenProfile(
            name=name,
            prefill_per_token=step1 / 8.0,
            decode_batch_sizes=bs,
            decode_step_runtimes=step1 * bs ** batch_efficiency,
            kv_bytes_per_slot=kv_base * (step_ratio ** i),
            gen_len=gen, gaps=gaps, correct=correct)
    return out


# ---------------------------------------------------------------------------
# Synthetic-but-calibrated model families (planner benchmarks for the big
# archs, where per-sample validation behaviour cannot be measured on CPU)
# ---------------------------------------------------------------------------

def synthetic_family(names: Sequence[str], base_runtime: float = 1e-3,
                     runtime_ratio: float = 3.0, base_acc: float = 0.78,
                     acc_gain: float = 0.045, n_val: int = 4096,
                     mem_base: float = 1e9, seed: int = 0,
                     batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                     batch_efficiency: float = 0.65,
                     devices_per_replica: Optional[Sequence[int]] = None,
                     ) -> ProfileSet:
    """Family of models with the latency/accuracy structure of Fig. 1.

    The validation behaviour has the *cascade-friendly* joint structure: a
    per-sample difficulty d; model m of strength s_m is correct w.p.
    sigmoid(k (s_m - d)) and its certainty is the (noisy) margin — so easy
    samples are confidently handled by small models and the accuracy gain of
    big models concentrates on hard samples (paper §2.1).
    """
    rng = np.random.default_rng(seed)
    difficulty = rng.beta(1.6, 3.2, size=n_val)      # most samples easy
    profiles: ProfileSet = {}
    for i, name in enumerate(names):
        strength = base_acc + acc_gain * i
        k = 9.0
        p_correct = 1.0 / (1.0 + np.exp(-k * (strength - difficulty)))
        correct = rng.random(n_val) < p_correct
        margin = np.abs(strength - difficulty)
        certs = margin + rng.normal(0, 0.05, n_val) * (1 - margin)
        certs = np.clip(certs, 0, None)
        rt1 = base_runtime * (runtime_ratio ** i)
        bs = np.asarray(batch_sizes, np.float64)
        # sub-linear batch scaling: runtime(b) = rt1 * b**efficiency-ish
        rts = rt1 * bs ** batch_efficiency
        profiles[name] = ModelProfile(
            name=name, mem_bytes=mem_base * (runtime_ratio ** i),
            batch_sizes=bs, batch_runtimes=rts,
            devices_per_replica=(devices_per_replica[i]
                                 if devices_per_replica else 1),
            validation=ValidationRecord(certs=certs, correct=correct))
    return profiles
