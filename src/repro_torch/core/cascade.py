"""Verbatim copy of ``repro/core/cascade.py``,
imports rewritten to ``repro_torch``.

Cascade semantics (paper §2.1): ordered models + certainty thresholds.

A sample is fed to model i; if its certainty >= threshold[i] the prediction
is final, otherwise it forwards to model i+1. The last model always answers.
Evaluation replays the models' recorded per-sample validation behaviour
(``ModelProfile.validation``) — this is exactly how the paper's simulator
scores accuracy (App. C.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import ModelProfile, ProfileSet


@dataclass(frozen=True)
class Cascade:
    models: Tuple[str, ...]            # ordered cheap -> expensive
    thresholds: Tuple[float, ...]      # len = len(models) - 1

    def __post_init__(self):
        # explicit ValueError, not assert: validation must survive python -O
        if len(self.models) == 0:
            raise ValueError("a cascade needs at least one model")
        if len(self.thresholds) != len(self.models) - 1:
            raise ValueError(
                f"{len(self.models)} models need {len(self.models) - 1} "
                f"thresholds, got {len(self.thresholds)}")

    def __str__(self) -> str:
        parts = []
        for i, m in enumerate(self.models):
            parts.append(m)
            if i < len(self.thresholds):
                parts.append(f"-[{self.thresholds[i]:.3f}]->")
        return " ".join(parts)

    @property
    def is_single(self) -> bool:
        return len(self.models) == 1


@dataclass(frozen=True)
class CascadeEval:
    """Validation-set evaluation of a cascade."""
    accuracy: float
    # fraction of all samples that reach model i (fractions[0] == 1.0)
    fractions: Tuple[float, ...]
    # average per-sample work in seconds at batch size 1
    avg_cost: float

    def qps_per_model(self, qps: float) -> Tuple[float, ...]:
        """QPS_m (paper footnote 2): forwarded fraction x total QPS."""
        return tuple(f * qps for f in self.fractions)


def evaluate_cascade(cascade: Cascade, profiles: ProfileSet) -> CascadeEval:
    """Replay recorded (certainty, correct) per model over the validation
    set. Sample resolved by the first model whose certainty clears its
    threshold; the last model always resolves."""
    n = len(profiles[cascade.models[0]].validation.certs)
    resolved = np.zeros(n, bool)
    correct = np.zeros(n, bool)
    fractions: List[float] = []
    for i, name in enumerate(cascade.models):
        rec = profiles[name].validation
        if len(rec.certs) != n:
            raise ValueError(
                f"validation sets must align across the family: "
                f"{name} has {len(rec.certs)} samples, expected {n}")
        active = ~resolved
        fractions.append(float(active.mean()))
        if i < len(cascade.thresholds):
            final_here = active & (rec.certs >= cascade.thresholds[i])
        else:
            final_here = active
        correct[final_here] = rec.correct[final_here]
        resolved |= final_here
    avg_cost = sum(
        frac * profiles[m].runtime_per_sample(1.0)
        for frac, m in zip(fractions, cascade.models))
    acc = float(correct.mean())
    return CascadeEval(accuracy=acc, fractions=tuple(fractions),
                       avg_cost=avg_cost)


def run_cascade_on_scores(cascade: Cascade,
                          model_scores: Dict[str, np.ndarray],
                          estimator: str = "top2_gap"
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Online cascade execution on raw score matrices (N, V): returns
    (predictions, which-model-resolved, certainties). Used by tests and the
    real serving path for tiny models."""
    from repro_torch.core.execution import resolve_estimator
    est = resolve_estimator(estimator)
    first = model_scores[cascade.models[0]]
    n = first.shape[0]
    preds = np.zeros(n, np.int64)
    resolver = np.full(n, len(cascade.models) - 1, np.int64)
    certs_out = np.zeros(n, np.float64)
    resolved = np.zeros(n, bool)
    for i, name in enumerate(cascade.models):
        scores = np.asarray(model_scores[name])
        cert = np.asarray(est(scores))
        pred = scores.argmax(-1)
        active = ~resolved
        if i < len(cascade.thresholds):
            final_here = active & (cert >= cascade.thresholds[i])
        else:
            final_here = active
        preds[final_here] = pred[final_here]
        certs_out[final_here] = cert[final_here]
        resolver[final_here] = i
        resolved |= final_here
    return preds, resolver, certs_out


def enumerate_model_orderings(profiles: ProfileSet) -> List[str]:
    """Model names ordered by batch-1 runtime (cheap -> expensive)."""
    return sorted(profiles, key=lambda m: profiles[m].runtime_per_sample(1.0))
