"""Cascade semantics (port of ``repro/core/cascade.py:19-43``).

A sample is fed to model i; if its certainty >= threshold[i] the prediction
is final, otherwise it forwards to model i+1. The last model always answers.
Only the ``Cascade`` dataclass is copied: the validation-replay helpers
belong to the planner, which the port does not carry yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
