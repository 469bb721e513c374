"""Verbatim copy of ``repro/core/plan_state.py``,
imports rewritten to ``repro_torch``.

Shared planner state threaded through the four submodules (Alg. 1).

Every submodule mutates only its own section of the state and reads the
others; the planner driver cycles them until convergence.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.cascade import Cascade, CascadeEval
from repro_torch.core.fastsim import CountingMemo, SimMemo
from repro_torch.core.gears import SLO
from repro_torch.core.lp import Replica
from repro_torch.core.profiles import ProfileSet
from repro_torch.core.simulator import SimConfig


@dataclass(frozen=True)
class HardwareSpec:
    """Abstract placement units. On the TPU target a 'device' is one
    inference-server slice (a model-parallel group of chips); mem is the
    slice's aggregate HBM. The paper's unit is one 32-GB V100."""
    num_devices: int
    mem_per_device: float  # bytes
    chips_per_device: int = 1  # for cost reporting (chips = paper's #GPUs)


@dataclass(frozen=True)
class PlanError:
    code: str  # ok | throughput | latency | accuracy | placement | infeasible
    qps_range: Optional[int] = None
    model: Optional[str] = None
    detail: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == "ok"


OK = PlanError("ok")


class InfeasiblePlanError(RuntimeError):
    """Raised to the user when the SLO is unattainable on the hardware."""


@dataclass
class PlannerState:
    profiles: ProfileSet
    hardware: HardwareSpec
    slo: SLO
    qps_max: float
    n_ranges: int
    qps_prior: np.ndarray                      # weight per range
    sim_cfg: SimConfig = field(default_factory=SimConfig)
    sim_horizon: float = 2.0
    rng_seed: int = 0
    # Online re-planning (core/adaption.py): keep the serving placement
    # fixed — replicas never move at runtime, so a hot-swappable plan must
    # re-optimise cascades/gears/batching OVER this placement. SP3 skips
    # prune/add and only re-solves the per-range load-balancing LPs.
    pinned_replicas: Optional[List[Replica]] = None
    # Multi-tenant planning (core/tenancy.py): expected steady-state
    # per-model QPS from the OTHER tenants sharing the placement. Added to
    # every range's demand vector in SP3, so the load-balancing LPs spread
    # this tenant's load knowing the contention it will meet. The per-range
    # DES feasibility check remains tenant-solo (the joint placement is
    # provisioned for the sum of worst cases — DESIGN.md §11).
    background_qps: Optional[Dict[str, float]] = None

    # Token-level serving (DESIGN.md §13): per-model HBM bytes one replica
    # reserves for its resident KV-cache decode slots (kv_bytes_per_slot
    # * decode_slots) — charged next to weights by SP3's placement — and
    # the per-model expected seconds one request occupies a decode slot,
    # driving SP4's Little's-law slot-stability verdict. Empty → one-shot
    # planning, bit-identical.
    kv_reserve: Dict[str, float] = field(default_factory=dict)
    decode_slots: Dict[str, int] = field(default_factory=dict)
    token_residency: Dict[str, float] = field(default_factory=dict)

    # Fast evaluation layer (core/fastsim.py, DESIGN.md §10): when enabled
    # the submodule search runs on the vectorized steady-state evaluator
    # and the converged plan is certified range-by-range by the exact DES.
    # ``fast_path=False`` restores the pre-fast-path search verbatim (the
    # honest baseline arm of benchmarks/bench_planner.py).
    fast_path: bool = True
    # exact-DES outcome cache (profile-digest guarded; carried across
    # warm-started re-plans) and LP/pruning result memos. Keys include the
    # FULL SimConfig / LP inputs so calibration changes never serve stale
    # results (tests/test_fastsim.py pins this).
    sim_memo: SimMemo = field(default_factory=SimMemo)
    lp_memo: Dict[Tuple, Tuple] = field(default_factory=CountingMemo)
    place_memo: Dict[Tuple, Optional[List[Replica]]] = field(
        default_factory=CountingMemo)

    # SP1: candidate cascades (Pareto set) and their validation evals
    cascades: List[Cascade] = field(default_factory=list)
    cascade_evals: List[CascadeEval] = field(default_factory=list)
    # analytic throughput estimate per cascade (samples/s on full hardware)
    cascade_tput: List[float] = field(default_factory=list)

    # SP2: cascade index assigned to each QPS range; per-range blacklists
    assignment: List[int] = field(default_factory=list)
    blacklist: Dict[int, Set[int]] = field(default_factory=dict)

    # SP3: placement + per-range LP results
    replicas: List[Replica] = field(default_factory=list)
    load_fracs: List[Dict[str, Dict[int, float]]] = field(default_factory=list)
    util: List[float] = field(default_factory=list)
    min_replicas: Dict[str, int] = field(default_factory=dict)  # SP4 errors

    # SP4: batching decisions + per-range sim outcomes
    min_qlens: List[Dict[str, int]] = field(default_factory=list)
    range_p95: List[float] = field(default_factory=list)
    range_stable: List[bool] = field(default_factory=list)

    # Monte-Carlo certification (core/vecsim.py, DESIGN.md §12): when
    # ``mc_seeds > 1`` a certified plan gets a per-range (mean, CI
    # half-width) p95 across that many arrival seeds, run as one
    # lane-batched vecsim call per range. ``mc_seeds == 1`` keeps the
    # legacy single-seed point-estimate certifier byte-for-byte.
    mc_seeds: int = 1
    mc_p95: List[Tuple[float, float]] = field(default_factory=list)
    mc_memo: Dict[Tuple, Tuple[float, float]] = field(default_factory=dict)

    # ---- helpers -----------------------------------------------------------
    def range_hi(self, r: int) -> float:
        return self.qps_max * (r + 1) / self.n_ranges

    def range_mid(self, r: int) -> float:
        return self.qps_max * (r + 0.5) / self.n_ranges

    def cascade_of_range(self, r: int) -> Cascade:
        return self.cascades[self.assignment[r]]

    def eval_of_range(self, r: int) -> CascadeEval:
        return self.cascade_evals[self.assignment[r]]

    def weighted_accuracy(self) -> float:
        accs = np.array([self.cascade_evals[c].accuracy
                         for c in self.assignment])
        return float((accs * self.qps_prior).sum())

    def weighted_p95(self) -> float:
        if not self.range_p95:
            return float("inf")
        return float((np.asarray(self.range_p95) * self.qps_prior).sum())

    def models_used(self) -> List[str]:
        out: List[str] = []
        for ci in self.assignment:
            for m in self.cascades[ci].models:
                if m not in out:
                    out.append(m)
        return out

    def signature(self) -> Tuple:
        """Convergence check: the decisions of all four submodules."""
        return (
            tuple(self.assignment),
            tuple(sorted((r.model, r.device) for r in self.replicas)),
            tuple(tuple(sorted(d.items())) for d in self.min_qlens),
        )
