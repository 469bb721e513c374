"""Replica placement record (port of ``repro/core/lp.py:122-127``).

Only the ``Replica`` dataclass is copied; the load-balancing LP stays in
the JAX package until the planner is ported.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Replica:
    model: str
    device: int          # inference-server / slice id
    runtime_per_sample: float  # runtime(r) at batch 1 (paper's definition)

