"""Verbatim copy of ``repro/core/submodules/hardware_mapping.py``,
imports rewritten to ``repro_torch``.

SP3 — hardware mapping (paper §4.4): model placement + load balancing.

Start from maximum replication (every used model on every device), then
greedily prune replicas until every device's memory fits. Pruning utility
combines the over-allocated memory a prune frees with the replica's
importance for load balancing (LP min-utilisation without the replica):

    util(r) = freed_overallocated_memory(r) / u_max(r)

NOTE: the paper prints Eq. 4's numerator as max(0, m_over - m_freed), which
is degenerate (pruning that frees MORE memory would score LOWER, and the
"no utility > 0" infeasibility test would fire exactly when one prune fixes
everything). We implement the stated intent — "how much overallocated memory
is freed by pruning it" — see DESIGN.md §Deviations.

Implementation notes (performance + robustness, semantics preserved):
* During pruning, u_max(r) is evaluated with ONE LP on the worst-case
  per-model QPS over all ranges (instead of one LP per range); the exact
  per-range LPs still produce the final load balance.
* Greedy pruning can dead-end (every replica on an over-full device is the
  last of its model). The paper errors out here; we first attempt an
  additive repair — first-fit-decreasing seed of one replica per model, then
  greedy replica additions that lower worst-case utilisation — and only
  error if even one-replica-each cannot be packed.

util(r) = -inf when r is the last replica of a model any gear needs (or the
load balancer becomes infeasible without it). An incoming SP4 error names a
bottleneck model m -> force an extra replica of m (min-replica constraint)
and rebuild. If the constraint cannot be met, the error propagates to SP2.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.fastsim import bottleneck_model, model_capacities
from repro_torch.core.gears import fractions_from_lp
from repro_torch.core.lp import Replica, min_utilization_lp
from repro_torch.core.plan_state import OK, PlanError, PlannerState


def _lp(state: PlannerState, replicas: List[Replica],
        qps_per_model: Dict[str, float]
        ) -> Tuple[Optional[float], Optional[np.ndarray]]:
    """``min_utilization_lp`` with a planner-state memo (fast path only).

    The EM loop re-solves identical load-balancing LPs on every
    SP2<->SP3 bounce and every post-convergence cycle; the key carries the
    FULL LP input (replica set incl. runtimes, demand vector, device
    count), so a memo hit is exactly the deterministic solver output. The
    legacy arm solves every LP afresh, as the pre-fast-path planner did.
    """
    n_dev = state.hardware.num_devices
    if not state.fast_path:
        return min_utilization_lp(replicas, qps_per_model, n_dev)
    key = (tuple((r.model, r.device, r.runtime_per_sample)
                 for r in replicas),
           tuple(sorted(qps_per_model.items())), n_dev)
    hit = state.lp_memo.get(key)
    if hit is not None:
        u, q = hit
        return u, (None if q is None else np.asarray(q))
    u, q = min_utilization_lp(replicas, qps_per_model, n_dev)
    state.lp_memo[key] = (u, None if q is None else tuple(q))
    return u, q


def _qps_per_model(state: PlannerState, r: int) -> Dict[str, float]:
    ev = state.eval_of_range(r)
    casc = state.cascade_of_range(r)
    qps = state.range_hi(r)
    out = {m: f * qps for m, f in zip(casc.models, ev.fractions)}
    if state.background_qps:
        # multi-tenant contention: other tenants' expected steady-state
        # load on the shared placement enters every range's LP demand
        for m, q in state.background_qps.items():
            out[m] = out.get(m, 0.0) + q
    return out


def _worst_case_qps(state: PlannerState) -> Dict[str, float]:
    """Per-model max QPS over all ranges (collapses the pruning LPs)."""
    out: Dict[str, float] = {}
    for r in range(state.n_ranges):
        for m, q in _qps_per_model(state, r).items():
            out[m] = max(out.get(m, 0.0), q)
    return out


def _replica_obj(state: PlannerState, model: str, device: int) -> Replica:
    # Eq. 3's runtime(r) at the *efficient* batch size, not batch 1: the LP
    # must make the optimistic decision (paper §4.1 — a cascade that is
    # infeasible at batch 1 may become feasible after SP4 raises batch
    # sizes; rejecting it here would "miss out on an effective cascade").
    # SP4's simulation is the binding throughput check.
    prof = state.profiles[model]
    b = prof.batch_sizes[-1]
    return Replica(model, device, prof.runtime(b) / b)


def _replica_mem(state: PlannerState, model: str) -> float:
    """HBM bytes one replica of ``model`` occupies: weights + the KV-cache
    reservation for its resident decode slots (token-level serving,
    DESIGN.md §13 — zero for one-shot plans)."""
    return state.profiles[model].mem_bytes \
        + state.kv_reserve.get(model, 0.0)


def _mem_per_device(state: PlannerState, replicas: List[Replica]
                    ) -> np.ndarray:
    mem = np.zeros(state.hardware.num_devices)
    for rep in replicas:
        mem[rep.device] += _replica_mem(state, rep.model)
    return mem


def _counts(replicas: List[Replica]) -> Dict[str, int]:
    c: Dict[str, int] = {}
    for rep in replicas:
        c[rep.model] = c.get(rep.model, 0) + 1
    return c


def _placement_key(state: PlannerState, kind: str, used: List[str],
                   wc_qps: Dict[str, float]) -> Tuple:
    return (kind, tuple(used), tuple(sorted(wc_qps.items())),
            tuple(sorted(state.min_replicas.items())),
            tuple(sorted(state.kv_reserve.items())),
            state.hardware.num_devices, state.hardware.mem_per_device)


def _prune_placement(state: PlannerState, replicas: List[Replica],
                     wc_qps: Dict[str, float]) -> Optional[List[Replica]]:
    """Greedy Eq.-4 pruning; None on dead-end. Fast path: the whole prune
    result is memoized per (worst-case demand, min-replica constraints) —
    the EM loop re-prunes from the identical full-replication start on
    every SP3 call whose demand did not change."""
    hw = state.hardware
    key = None
    if state.fast_path:
        key = _placement_key(state, "prune",
                             [r.model for r in replicas], wc_qps)
        if key in state.place_memo:
            hit = state.place_memo[key]
            return None if hit is None else list(hit)
    replicas = list(replicas)
    while True:
        mem = _mem_per_device(state, replicas)
        over = np.maximum(mem - hw.mem_per_device, 0.0)
        if not over.any():
            break
        cnt = _counts(replicas)
        best_util, best_idx = -math.inf, -1
        for i, rep in enumerate(replicas):
            if over[rep.device] <= 0:
                continue
            if cnt[rep.model] <= state.min_replicas.get(rep.model, 1):
                continue  # util = -inf: last / protected replica
            freed = min(over[rep.device],
                        _replica_mem(state, rep.model))
            cand = replicas[:i] + replicas[i + 1:]
            u_max, _ = _lp(state, cand, wc_qps)
            if u_max is None:
                continue  # util = -inf: LP infeasible without it
            util = freed / max(u_max, 1e-6)
            if util > best_util:
                best_util, best_idx = util, i
        if best_idx < 0:
            replicas = None
            break
        replicas.pop(best_idx)
    if key is not None:
        state.place_memo[key] = None if replicas is None else list(replicas)
    return replicas


def _additive_repair(state: PlannerState, used: List[str],
                     wc_qps: Dict[str, float]) -> Optional[List[Replica]]:
    """FFD seed (one replica per model, honouring min_replicas) + greedy
    additions that reduce worst-case utilisation. Memoized like
    ``_prune_placement`` on the fast path (same determinism argument)."""
    hw = state.hardware
    key = None
    if state.fast_path:
        key = _placement_key(state, "repair", list(used), wc_qps)
        if key in state.place_memo:
            hit = state.place_memo[key]
            return None if hit is None else list(hit)
    result = _additive_repair_inner(state, used, wc_qps)
    if key is not None:
        state.place_memo[key] = None if result is None else list(result)
    return result


def _additive_repair_inner(state: PlannerState, used: List[str],
                           wc_qps: Dict[str, float]
                           ) -> Optional[List[Replica]]:
    hw = state.hardware
    free = np.full(hw.num_devices, hw.mem_per_device)
    replicas: List[Replica] = []
    need = []
    for m in used:
        need += [m] * state.min_replicas.get(m, 1)
    for m in sorted(need, key=lambda m: -_replica_mem(state, m)):
        d = int(np.argmax(free))
        if free[d] < _replica_mem(state, m):
            return None  # not even one replica per model fits
        free[d] -= _replica_mem(state, m)
        replicas.append(_replica_obj(state, m, d))

    u_cur, _ = _lp(state, replicas, wc_qps)
    if u_cur is None:
        u_cur = math.inf
    while True:
        best = None
        for m in used:
            mem = _replica_mem(state, m)
            for d in range(hw.num_devices):
                if free[d] < mem:
                    continue
                if any(r.model == m and r.device == d for r in replicas):
                    continue
                cand = replicas + [_replica_obj(state, m, d)]
                u, _ = _lp(state, cand, wc_qps)
                if u is not None and u < u_cur - 1e-4:
                    if best is None or u < best[0]:
                        best = (u, m, d)
        if best is None:
            return replicas
        u_cur, m, d = best
        free[d] -= _replica_mem(state, m)
        replicas.append(_replica_obj(state, m, d))


def solve_joint_placement(profiles, hardware, wc_qps: Dict[str, float],
                          used: Optional[List[str]] = None,
                          min_replicas: Optional[Dict[str, int]] = None,
                          kv_reserve: Optional[Dict[str, float]] = None,
                          fast_path: bool = True) -> List[Replica]:
    """One shared placement for an aggregate demand (multi-tenant planning,
    core/tenancy.py): run the Eq.-4 prune (with additive repair as usual)
    against the SUM of the tenants' worst-case per-model QPS, outside the
    per-tenant EM loops. The result is then PINNED for every tenant's own
    SP2/SP4 run, exactly like an online re-plan pins the serving placement.

    ``kv_reserve`` maps model -> HBM bytes one replica reserves for its
    resident KV-cache decode slots (token-level serving, DESIGN.md §13):
    charged next to weights, so a gear plan whose slot memory exceeds
    device HBM is rejected HERE, at placement time.

    Raises ``InfeasiblePlanError`` when not even one replica per model fits.
    """
    from repro_torch.core.gears import SLO
    from repro_torch.core.plan_state import InfeasiblePlanError

    used = used if used is not None else sorted(wc_qps)
    missing = [m for m in used if m not in profiles]
    if missing:
        raise InfeasiblePlanError(
            f"joint placement: no profile for {missing[0]}")
    state = PlannerState(
        profiles=profiles, hardware=hardware,
        slo=SLO(kind="latency", latency_p95=1.0),
        qps_max=max(sum(wc_qps.values()), 1.0), n_ranges=1,
        qps_prior=np.ones(1), fast_path=fast_path)
    if min_replicas:
        state.min_replicas = dict(min_replicas)
    if kv_reserve:
        state.kv_reserve = dict(kv_reserve)
    replicas = _prune_placement(
        state,
        [_replica_obj(state, m, d)
         for m in used for d in range(hardware.num_devices)],
        wc_qps)
    if replicas is None:
        replicas = _additive_repair(state, used, wc_qps)
    if replicas is None:
        raise InfeasiblePlanError(
            f"joint placement: cannot pack one replica per model "
            f"({used}) on {hardware.num_devices} devices")
    return replicas


def mean_qps_per_model(state: PlannerState) -> Dict[str, float]:
    """Prior-weighted steady-state per-model QPS of one tenant's plan —
    what the OTHER tenants see as background contention (DESIGN.md §11).
    Excludes any background already folded into the state's own demand."""
    bg = state.background_qps or {}
    out: Dict[str, float] = {}
    for r in range(state.n_ranges):
        w = float(state.qps_prior[r])
        for m, q in _qps_per_model(state, r).items():
            own = q - bg.get(m, 0.0)
            if own > 0:
                out[m] = out.get(m, 0.0) + w * own
    return out


def place_models(error: PlanError, state: PlannerState
                 ) -> Tuple[PlanError, PlannerState]:
    hw = state.hardware
    used = state.models_used()

    if state.pinned_replicas is not None:
        # Online re-planning: the serving placement is immutable (no model
        # loading on the critical path), so SP3 degenerates to re-solving
        # the per-range load-balancing LPs over the pinned replicas. An SP4
        # bottleneck error cannot be fixed by adding replicas — propagate
        # it to SP2 so the offending cascade is blacklisted instead.
        if not error.is_ok:
            return PlanError("throughput", qps_range=error.qps_range,
                             model=error.model,
                             detail="placement pinned: cannot add replicas "
                                    f"of {error.model}"), state
        missing = [m for m in used
                   if not any(r.model == m for r in state.pinned_replicas)]
        if missing:
            ranges = [r for r in range(state.n_ranges)
                      if missing[0] in state.cascade_of_range(r).models]
            return PlanError(
                "placement",
                qps_range=ranges[0] if ranges else state.n_ranges - 1,
                model=missing[0],
                detail=f"{missing[0]} not in the pinned placement"), state
        return _balance_ranges(state, list(state.pinned_replicas))

    if not error.is_ok:
        # SP4 bottleneck: demand one more replica of the named model
        m = error.model
        if m is None or state.min_replicas.get(m, 1) >= hw.num_devices:
            return PlanError("throughput", qps_range=error.qps_range,
                             model=m,
                             detail=f"cannot add further replicas of {m} "
                                    f"({hw.num_devices} devices)"), state
        state.min_replicas[m] = state.min_replicas.get(m, 1) + 1

    wc_qps = _worst_case_qps(state)
    replicas = _prune_placement(
        state,
        [_replica_obj(state, m, d)
         for m in used for d in range(hw.num_devices)],
        wc_qps)
    if replicas is None:
        replicas = _additive_repair(state, used, wc_qps)
    if replicas is None:
        # not even one replica per used model fits -> blame the range using
        # the biggest model where accuracy loss costs least (prior weight)
        big = max(used, key=lambda m: state.profiles[m].mem_bytes)
        ranges = [r for r in range(state.n_ranges)
                  if big in state.cascade_of_range(r).models]
        r_blame = min(ranges, key=lambda r: state.qps_prior[r]) \
            if ranges else state.n_ranges - 1
        return PlanError(
            "placement", qps_range=r_blame, model=big,
            detail=f"cannot pack one replica per model "
                   f"({[m for m in used]})"), state

    return _balance_ranges(state, replicas)


def _balance_ranges(state: PlannerState, replicas: List[Replica]
                    ) -> Tuple[PlanError, PlannerState]:
    """Per-range load balancing over a fixed replica list."""
    load_fracs, utils = [], []
    for r in range(state.n_ranges):
        u, q = _lp(state, replicas, _qps_per_model(state, r))
        if u is None:
            return PlanError(
                "throughput", qps_range=r,
                model=_bottleneck_model(state, r, replicas),
                detail=f"load balancer infeasible at range {r} "
                       f"(qps {state.range_hi(r):.0f})"), state
        load_fracs.append(fractions_from_lp(
            q, replicas, state.cascade_of_range(r).models))
        utils.append(u)

    state.replicas = replicas
    state.load_fracs = load_fracs
    state.util = utils
    return OK, state


def _bottleneck_model(state: PlannerState, r: int,
                      replicas: List[Replica]) -> str:
    """Model whose replica set has the least headroom for this range
    (capacity aggregation shared with the fast evaluation layer)."""
    need = _qps_per_model(state, r)
    worst = bottleneck_model(need, model_capacities(replicas))
    return worst or next(iter(need))
