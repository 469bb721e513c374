"""Verbatim copy of ``repro/core/planner.py``,
imports rewritten to ``repro_torch``.

Gear-plan optimisation — the paper's Algorithm 1.

EM-style error-driven co-optimisation: cycle through the four submodules
(SP1 cascade search, SP2 workload adaption, SP3 hardware mapping, SP4
batching), each optimising its subproblem against the others' fixed
solutions. A submodule that cannot produce a feasible plan returns an error
code, which the PREVIOUS submodule catches and resolves (backtracking
recursively; an error surfacing before SP1 is reported to the user as
"SLO unattainable"). Convergence: one full all-OK cycle that leaves the plan
signature unchanged (Appendix A proves termination).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cascade import evaluate_cascade
from repro_torch.core.fastsim import SimMemo, trim_memo
from repro_torch.core.gears import Gear, GearPlan, PlanProvenance, SLO
from repro_torch.core.plan_state import (HardwareSpec, InfeasiblePlanError, OK,
                                   PlanError, PlannerState)
from repro_torch.core.profiles import ProfileSet, profile_digest
from repro_torch.core.simulator import SimConfig
from repro_torch.core.submodules import SUBMODULES
from repro_torch.core.submodules.batching import certify_ranges
from repro_torch.core.traces import zipf_prior


@dataclass
class PlannerReport:
    plan: GearPlan
    iterations: int
    submodule_calls: int
    errors_resolved: int
    wall_seconds: float
    # (submodule name, result code, wall seconds) per call, in call order
    call_log: List[Tuple[str, str, float]] = field(default_factory=list)
    # final planner state, so an online re-plan can warm-start from it
    state: Optional[PlannerState] = None
    # wall seconds of the final exact-DES certification pass(es) and how
    # many certification rounds the fast path needed (0 on the legacy path)
    certify_seconds: float = 0.0
    certify_rounds: int = 0

    @property
    def submodule_seconds(self) -> Dict[str, float]:
        """Per-submodule wall-time breakdown, aggregated from the call log
        (plus the certification pass) — what `launch/dryrun.py --plan-check`
        and `launch/serve.py` print so planner perf work stays measurable."""
        out: Dict[str, float] = {}
        for name, _code, secs in self.call_log:
            out[name] = out.get(name, 0.0) + secs
        if self.certify_seconds:
            out["certify:DES"] = self.certify_seconds
        return out

    @property
    def memo_stats(self) -> Dict[str, Tuple[int, int]]:
        """(hits, misses) per planner cache — sim_memo (DES outcomes),
        lp_memo (load-balancing LPs), place_memo (placements). Printed by
        `launch/dryrun.py --plan-check` so cold-vs-warm planner cost
        regressions are diagnosable without a profiler."""
        out: Dict[str, Tuple[int, int]] = {}
        if self.state is None:
            return out
        for name in ("sim_memo", "lp_memo", "place_memo"):
            memo = getattr(self.state, name, None)
            hits = getattr(memo, "hits", None)
            if hits is not None:
                out[name] = (int(hits), int(memo.misses))
        return out


def make_state(profiles: ProfileSet, hardware: HardwareSpec, slo: SLO,
               qps_max: float, n_ranges: int = 8,
               qps_prior: Optional[np.ndarray] = None,
               sim_cfg: SimConfig = SimConfig(), seed: int = 0,
               pinned_replicas=None, warm_state: Optional[PlannerState] = None,
               fast_path: bool = True,
               background_qps: Optional[Dict[str, float]] = None,
               num_seeds: int = 1) -> PlannerState:
    if num_seeds < 1:
        raise ValueError(f"num_seeds must be >= 1, got {num_seeds}")
    prior = qps_prior if qps_prior is not None else zipf_prior(n_ranges)
    if pinned_replicas is not None:
        # immutable serving placement: only models already placed can
        # appear in cascades, so restrict the search space up front
        placed = {r.model for r in pinned_replicas}
        profiles = {m: p for m, p in profiles.items() if m in placed}
        if not profiles:
            raise InfeasiblePlanError("pinned placement holds no profiled "
                                      "model")
    state = PlannerState(profiles=profiles, hardware=hardware, slo=slo,
                         qps_max=qps_max, n_ranges=n_ranges,
                         qps_prior=np.asarray(prior, np.float64),
                         sim_cfg=sim_cfg, rng_seed=seed,
                         pinned_replicas=list(pinned_replicas)
                         if pinned_replicas is not None else None,
                         fast_path=fast_path,
                         background_qps=dict(background_qps)
                         if background_qps else None,
                         mc_seeds=num_seeds)
    if fast_path:
        # stamp the memo with its profile provenance up front, so a later
        # warm start can tell whether this run's DES outcomes apply to it
        state.sim_memo.set_profiles(profiles)
    if warm_state is not None:
        # warm start (online re-plan): reuse SP1's Pareto candidate set —
        # validation evals are workload-independent and throughput
        # estimates depend only on profiles+hardware, so the expensive
        # cascade search resumes instead of restarting. Candidates over
        # models absent from a pinned placement are dropped.
        avail = set(profiles)
        keep = [i for i, c in enumerate(warm_state.cascades)
                if all(m in avail for m in c.models)]
        state.cascades = [warm_state.cascades[i] for i in keep]
        state.cascade_evals = [warm_state.cascade_evals[i] for i in keep]
        state.cascade_tput = [warm_state.cascade_tput[i] for i in keep]
        if fast_path:
            # fast path: adopt the previous run's exact-DES outcomes (the
            # memo carry is per-model-digest guarded — changed profiles or
            # calibration never serve stale results). LP memo keys carry
            # their full input (replica runtimes + demand), so they are
            # profile-independent; placement memos depend on model memory
            # footprints and transfer only under identical profiles.
            state.sim_memo.carry_from(warm_state.sim_memo, profiles)
            state.lp_memo.update(warm_state.lp_memo)
            if warm_state.sim_memo.model_digests == \
                    state.sim_memo.model_digests:
                state.place_memo.update(warm_state.place_memo)
                # MC verdicts are (seed-set × DES-key)-pure, so they carry
                # under the same unchanged-profiles guard as placements
                state.mc_memo.update(warm_state.mc_memo)
                trim_memo(state.mc_memo, SimMemo.MAX_ENTRIES // 8)
            # chained warm states must not leak cache without bound
            trim_memo(state.lp_memo, SimMemo.MAX_ENTRIES)
            trim_memo(state.place_memo, SimMemo.MAX_ENTRIES // 8)
    return state


def optimize_gear_plan(profiles: ProfileSet, hardware: HardwareSpec,
                       slo: SLO, qps_max: float, n_ranges: int = 8,
                       qps_prior: Optional[np.ndarray] = None,
                       sim_cfg: SimConfig = SimConfig(), seed: int = 0,
                       max_calls: int = 200, pinned_replicas=None,
                       warm_state: Optional[PlannerState] = None,
                       fast_path: bool = True,
                       background_qps: Optional[Dict[str, float]] = None,
                       num_seeds: int = 1) -> PlannerReport:
    """Algorithm 1. Raises InfeasiblePlanError when no plan can satisfy the
    SLO on the given hardware.

    ``pinned_replicas`` freezes the model placement (online re-planning:
    replicas never move at runtime, DESIGN.md §Plan lifecycle) and
    ``warm_state`` seeds SP1 with an earlier run's candidate cascades (plus,
    on the fast path, its exact-DES memo). ``fast_path`` switches the inner
    search onto the vectorized steady-state evaluator with final exact-DES
    certification (DESIGN.md §10); ``False`` restores the pre-fast-path
    search verbatim. ``background_qps`` is the multi-tenant contention term
    (core/tenancy.py): other tenants' expected per-model load on a shared
    pinned placement, added to every range's LP demand. ``num_seeds > 1``
    turns on Monte-Carlo certification (DESIGN.md §12): the certified plan
    is unchanged, but each range's p95 verdict is additionally scored
    across that many arrival seeds (one lane-batched vecsim call) and the
    (mean, CI) lands in the plan's provenance for the drift monitor.
    """
    t0 = time.time()
    state = make_state(profiles, hardware, slo, qps_max, n_ranges, qps_prior,
                       sim_cfg, seed, pinned_replicas=pinned_replicas,
                       warm_state=warm_state, fast_path=fast_path,
                       background_qps=background_qps, num_seeds=num_seeds)
    modules = SUBMODULES
    names = ["SP1:search_cascades", "SP2:assign_cascades",
             "SP3:place_models", "SP4:tune_batch_sizes"]

    error: PlanError = OK
    cur = 0
    calls = 0
    errors_resolved = 0
    call_log: List[Tuple[str, str, float]] = []
    last_signature = None
    ok_streak = 0         # consecutive OK submodule calls
    certify_rounds = 0
    certify_seconds = 0.0

    while True:
        if cur == -1:
            raise InfeasiblePlanError(
                f"infeasible: {error.detail or error.code}")
        if calls >= max_calls:
            raise InfeasiblePlanError(
                f"planner did not converge within {max_calls} submodule "
                f"calls (last error: {error.code})")
        module = modules[cur]
        t_call = time.time()
        error, state = module(error, state)
        calls += 1
        call_log.append((names[cur], error.code, time.time() - t_call))
        if error.is_ok:
            ok_streak += 1
            cur = (cur + 1) % 4
            # convergence: a full OK cycle with an unchanged plan signature
            if ok_streak >= 4 and cur == 0 and state.min_qlens:
                sig = state.signature()
                if sig == last_signature:
                    if not state.fast_path:
                        break
                    # fast path: the loop ran on steady-state estimates —
                    # certify the converged plan with the exact DES. A
                    # failed round leaves its DES facts in the memo and
                    # resumes the loop at SP4, which now reproduces the
                    # legacy verdicts from those facts (DESIGN.md §10).
                    t_cert = time.time()
                    certified = certify_ranges(state)
                    certify_seconds += time.time() - t_cert
                    if certified:
                        break
                    certify_rounds += 1
                    last_signature = None
                    ok_streak = 0
                    cur = 3
                    continue
                last_signature = sig
        else:
            ok_streak = 0
            errors_resolved += 1
            cur = cur - 1

    plan = build_plan(state)
    return PlannerReport(plan=plan, iterations=calls // 4,
                         submodule_calls=calls,
                         errors_resolved=errors_resolved,
                         wall_seconds=time.time() - t0, call_log=call_log,
                         state=state, certify_seconds=certify_seconds,
                         certify_rounds=certify_rounds)


def check_qps_distribution(plan_prior: np.ndarray, trace: np.ndarray,
                           qps_max: float,
                           threshold: float = 0.25) -> Tuple[bool, float]:
    """App. C.2: compare the measured QPS distribution against the plan's
    prior; returns (deviates_strongly, total_variation_distance). The
    producer measures QPS anyway as an artifact of gear switching — when
    the deviation is large the user is notified and may trigger
    ``replan_with_measured``."""
    from repro_torch.core.traces import measured_qps_distribution
    measured = measured_qps_distribution(trace, len(plan_prior), qps_max)
    tv = 0.5 * float(np.abs(measured - plan_prior).sum())
    return tv > threshold, tv


def replan_with_measured(profiles: ProfileSet, hardware: HardwareSpec,
                         slo: SLO, qps_max: float, trace: np.ndarray,
                         n_ranges: int = 8, **kw) -> PlannerReport:
    """Re-run Algorithm 1 with the measured (not Zipf-assumed) QPS
    distribution as the prior (App. C.2)."""
    from repro_torch.core.traces import measured_qps_distribution
    prior = measured_qps_distribution(trace, n_ranges, qps_max)
    prior = np.maximum(prior, 1e-6)
    prior = prior / prior.sum()
    return optimize_gear_plan(profiles, hardware, slo, qps_max,
                              n_ranges=n_ranges, qps_prior=prior, **kw)


def build_plan(state: PlannerState) -> GearPlan:
    gears: List[Gear] = []
    for r in range(state.n_ranges):
        ev = state.eval_of_range(r)
        gears.append(Gear(
            cascade=state.cascade_of_range(r),
            min_queue_lens=state.min_qlens[r] if state.min_qlens else
            {m: 1 for m in state.cascade_of_range(r).models},
            load_fractions=state.load_fracs[r] if state.load_fracs else {},
            expected_accuracy=ev.accuracy,
            expected_p95=state.range_p95[r] if state.range_p95 else 0.0))
    return GearPlan(qps_max=state.qps_max, gears=gears,
                    replicas=state.replicas,
                    num_devices=state.hardware.num_devices, slo=state.slo,
                    provenance=provenance_from_state(state))


def provenance_from_state(state: PlannerState) -> PlanProvenance:
    """Record what the planner assumed, for the online PlanMonitor."""
    return PlanProvenance(
        qps_max=state.qps_max, n_ranges=state.n_ranges,
        qps_prior=tuple(float(w) for w in state.qps_prior),
        num_devices=state.hardware.num_devices,
        mem_per_device=state.hardware.mem_per_device,
        profile_digest=profile_digest(state.profiles),
        cert_means=tuple(
            (m, float(state.profiles[m].validation.certs.mean()))
            for m in sorted(state.profiles)),
        mc_p95=tuple((float(m), float(c)) for m, c in state.mc_p95),
        mc_seeds=state.mc_seeds,
        range_p95=tuple(float(p) for p in state.range_p95)
        if state.range_p95 else ())
