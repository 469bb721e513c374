"""Gears (port of ``repro/core/gears.py:21-118``).

A *gear* tells the online system, for one QPS range: which cascade to run,
the min-queue-length (batch trigger) per model, and how each model's load is
split across its replicas. Only ``SLO`` and ``Gear`` are copied; the gear
plan and its serialisation stay in the JAX package until the planner is
ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.cascade import Cascade


@dataclass(frozen=True)
class SLO:
    """Service-level objective: constrain one metric, optimise the other."""
    kind: str                      # "latency" | "accuracy"
    latency_p95: Optional[float] = None   # seconds (kind == "latency")
    min_accuracy: Optional[float] = None  # fraction (kind == "accuracy")

    def __post_init__(self):
        # explicit ValueError, not assert: validation must survive python -O
        if self.kind not in ("latency", "accuracy"):
            raise ValueError(
                f"SLO kind must be 'latency' or 'accuracy', got "
                f"{self.kind!r}")
        if self.kind == "latency":
            if self.latency_p95 is None:
                raise ValueError("a latency SLO needs latency_p95 (seconds)")
            if self.latency_p95 <= 0:
                raise ValueError(
                    f"latency_p95 must be positive, got {self.latency_p95}")
        else:
            if self.min_accuracy is None:
                raise ValueError(
                    "an accuracy SLO needs min_accuracy (fraction)")
            if not 0.0 < self.min_accuracy <= 1.0:
                raise ValueError(
                    f"min_accuracy must be in (0, 1], got "
                    f"{self.min_accuracy}")


@dataclass
class Gear:
    cascade: Cascade
    # batch trigger: inference fires when queue length >= this (paper §4.5)
    min_queue_lens: Dict[str, int]
    # per model: fraction of that model's QPS routed to each replica
    # (aligned with GearPlan.replicas indices)
    load_fractions: Dict[str, Dict[int, float]]
    expected_accuracy: float = 0.0
    expected_p95: float = 0.0
    # token-level serving (DESIGN.md §13): per-model decode-slot count a
    # replica keeps resident (continuous-batching capacity) and the HBM
    # bytes ONE resident slot's KV cache costs — the placement constraint
    # the planner charges next to weights. Empty for one-shot gears.
    decode_slots: Dict[str, int] = field(default_factory=dict)
    kv_bytes_per_slot: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        for m, trig in self.min_queue_lens.items():
            if trig < 1:
                raise ValueError(
                    f"min queue length for {m} must be >= 1, got {trig}")
        for m, fracs in self.load_fractions.items():
            for ridx, f in fracs.items():
                if f < 0.0:
                    raise ValueError(
                        f"load fraction for {m} on replica {ridx} must be "
                        f">= 0, got {f}")
        for m, s in self.decode_slots.items():
            if s < 1:
                raise ValueError(
                    f"decode_slots for {m} must be >= 1, got {s}")
        for m, b in self.kv_bytes_per_slot.items():
            if b < 0:
                raise ValueError(
                    f"kv_bytes_per_slot for {m} must be >= 0, got {b}")

    def kv_reserve(self, model: str) -> float:
        """HBM bytes one replica of ``model`` reserves for its resident
        decode slots under this gear (0 for one-shot gears)."""
        return self.kv_bytes_per_slot.get(model, 0.0) \
            * self.decode_slots.get(model, 0)

    def to_dict(self) -> Dict:
        return {
            "models": list(self.cascade.models),
            "thresholds": list(self.cascade.thresholds),
            "min_queue_lens": dict(self.min_queue_lens),
            "load_fractions": {m: {str(k): v for k, v in d.items()}
                               for m, d in self.load_fractions.items()},
            "expected_accuracy": self.expected_accuracy,
            "expected_p95": self.expected_p95,
            "decode_slots": dict(self.decode_slots),
            "kv_bytes_per_slot": dict(self.kv_bytes_per_slot),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Gear":
        return cls(
            cascade=Cascade(tuple(d["models"]), tuple(d["thresholds"])),
            min_queue_lens={k: int(v) for k, v in d["min_queue_lens"].items()},
            load_fractions={m: {int(k): float(v) for k, v in sub.items()}
                            for m, sub in d["load_fractions"].items()},
            expected_accuracy=d.get("expected_accuracy", 0.0),
            expected_p95=d.get("expected_p95", 0.0),
            decode_slots={m: int(v) for m, v in
                          d.get("decode_slots", {}).items()},
            kv_bytes_per_slot={m: float(v) for m, v in
                               d.get("kv_bytes_per_slot", {}).items()})
