"""Verbatim copy of ``repro/core/gears.py``,
imports rewritten to ``repro_torch``.

Gear plan: the paper's core abstraction (§3, §4).

A *gear* tells the online system, for one QPS range: which cascade to run,
the min-queue-length (batch trigger) per model, and how each model's load is
split across its replicas. The *gear plan* is the full table over
``n_ranges`` equal QPS ranges in [0, qps_max], plus the fixed model placement
(replicas never move at runtime — no model loading on the critical path).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cascade import Cascade
from repro_torch.core.lp import Replica


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


@dataclass(frozen=True)
class PlanProvenance:
    """What the planner assumed when it produced a plan.

    The online ``PlanMonitor`` (core/adaption.py) compares live
    observations against exactly these assumptions to decide when the plan
    has left its validity regime and a background re-plan is due. Baseline
    policies mark their plans ``frozen``: they must never hot-swap, so the
    re-planning ablation stays honest (the baselines get no capability the
    original systems lacked).
    """
    qps_max: float
    n_ranges: int
    qps_prior: Tuple[float, ...]           # assumed time-in-range weights
    num_devices: int
    mem_per_device: float
    profile_digest: str = ""               # hash of the ModelProfiles used
    # per-model mean validation certainty (drift reference for the monitor)
    cert_means: Tuple[Tuple[str, float], ...] = ()
    # Monte-Carlo certification (core/vecsim.py): per-range (mean, CI
    # half-width) of the DES p95 across ``mc_seeds`` arrival realizations.
    # Empty when the plan was certified on the single-seed point estimate.
    mc_p95: Tuple[Tuple[float, float], ...] = ()
    mc_seeds: int = 1
    # scalar certified per-range p95 (the single-seed DES point estimate
    # behind each gear's latency verdict). The PlanMonitor's latency-drift
    # check falls back to this + MonitorConfig.p95_abs_margin when the
    # plan carries no Monte-Carlo band (mc_p95 empty).
    range_p95: Tuple[float, ...] = ()
    frozen: bool = False                   # baselines: never hot-swap

    def to_dict(self) -> Dict:
        return {"qps_max": self.qps_max, "n_ranges": self.n_ranges,
                "qps_prior": list(self.qps_prior),
                "num_devices": self.num_devices,
                "mem_per_device": self.mem_per_device,
                "profile_digest": self.profile_digest,
                "cert_means": [[m, c] for m, c in self.cert_means],
                "mc_p95": [[m, c] for m, c in self.mc_p95],
                "mc_seeds": self.mc_seeds,
                "range_p95": list(self.range_p95),
                "frozen": self.frozen}

    @classmethod
    def from_dict(cls, d: Dict) -> "PlanProvenance":
        return cls(qps_max=float(d["qps_max"]), n_ranges=int(d["n_ranges"]),
                   qps_prior=tuple(float(x) for x in d["qps_prior"]),
                   num_devices=int(d["num_devices"]),
                   mem_per_device=float(d["mem_per_device"]),
                   profile_digest=d.get("profile_digest", ""),
                   cert_means=tuple((m, float(c))
                                    for m, c in d.get("cert_means", [])),
                   mc_p95=tuple((float(m), float(c))
                                for m, c in d.get("mc_p95", [])),
                   mc_seeds=int(d.get("mc_seeds", 1)),
                   range_p95=tuple(float(p)
                                   for p in d.get("range_p95", [])),
                   frozen=bool(d.get("frozen", False)))


@dataclass
class GearPlan:
    qps_max: float
    gears: List[Gear]              # one per equal-width QPS range
    replicas: List[Replica]        # fixed placement (model, device, runtime)
    num_devices: int
    slo: SLO
    provenance: Optional[PlanProvenance] = None

    def __post_init__(self):
        if self.qps_max <= 0:
            raise ValueError(f"qps_max must be positive, got {self.qps_max}")
        if not self.gears:
            raise ValueError("a gear plan needs at least one gear")

    @property
    def n_ranges(self) -> int:
        return len(self.gears)

    @property
    def range_width(self) -> float:
        return self.qps_max / max(self.n_ranges, 1)

    def gear_index_for_qps(self, qps: float) -> int:
        idx = int(qps / self.range_width)
        return int(np.clip(idx, 0, self.n_ranges - 1))

    def gear_for_qps(self, qps: float) -> Gear:
        return self.gears[self.gear_index_for_qps(qps)]

    def replicas_of(self, model: str) -> List[int]:
        return [i for i, r in enumerate(self.replicas) if r.model == model]

    def models_used(self) -> List[str]:
        out = []
        for g in self.gears:
            for m in g.cascade.models:
                if m not in out:
                    out.append(m)
        return out

    # ---- (de)serialisation (checkpointing / ops handoff) -------------------
    def to_dict(self) -> Dict:
        return {
            "qps_max": self.qps_max,
            "num_devices": self.num_devices,
            "slo": {"kind": self.slo.kind,
                    "latency_p95": self.slo.latency_p95,
                    "min_accuracy": self.slo.min_accuracy},
            "replicas": [{"model": r.model, "device": r.device,
                          "runtime_per_sample": r.runtime_per_sample}
                         for r in self.replicas],
            "gears": [g.to_dict() for g in self.gears],
            "provenance": self.provenance.to_dict()
            if self.provenance is not None else None,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_dict(cls, d: Dict) -> "GearPlan":
        return cls(
            qps_max=d["qps_max"], num_devices=d["num_devices"],
            slo=SLO(kind=d["slo"]["kind"],
                    latency_p95=d["slo"]["latency_p95"],
                    min_accuracy=d["slo"]["min_accuracy"]),
            replicas=[Replica(r["model"], int(r["device"]),
                              float(r["runtime_per_sample"]))
                      for r in d["replicas"]],
            gears=[Gear.from_dict(g) for g in d["gears"]],
            provenance=PlanProvenance.from_dict(d["provenance"])
            if d.get("provenance") else None)

    @classmethod
    def from_json(cls, s: str) -> "GearPlan":
        return cls.from_dict(json.loads(s))


def uniform_load_fractions(plan_replicas: Sequence[Replica],
                           models: Sequence[str]
                           ) -> Dict[str, Dict[int, float]]:
    """Equal split of each model's load over its replicas (LP-free default)."""
    out: Dict[str, Dict[int, float]] = {}
    for m in models:
        idxs = [i for i, r in enumerate(plan_replicas) if r.model == m]
        if idxs:
            out[m] = {i: 1.0 / len(idxs) for i in idxs}
    return out


def fractions_from_lp(q: np.ndarray, replicas: Sequence[Replica],
                      models: Sequence[str]) -> Dict[str, Dict[int, float]]:
    """Convert LP rates q_r into per-model routing fractions."""
    out: Dict[str, Dict[int, float]] = {}
    for m in models:
        idxs = [i for i, r in enumerate(replicas) if r.model == m]
        total = sum(q[i] for i in idxs)
        if not idxs:
            continue
        if total <= 1e-12:
            out[m] = {i: 1.0 / len(idxs) for i in idxs}
        else:
            out[m] = {i: float(q[i] / total) for i in idxs}
    return out
