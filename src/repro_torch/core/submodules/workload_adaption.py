"""Verbatim copy of ``repro/core/submodules/workload_adaption.py``,
imports rewritten to ``repro_torch``.

SP2 — workload adaption (paper §4.3): assign a cascade to each QPS range.

Latency SLO (optimise accuracy): start every range at the most ACCURATE
cascade; on a downstream error for range r, downgrade r to the
next-most-accurate non-blacklisted cascade (more throughput, less accuracy).

Accuracy SLO (optimise latency): start every range at the CHEAPEST cascade;
the constraint is on the time-weighted average accuracy under the QPS prior
(App. C.2), so upgrade the ranges with the best accuracy-per-cost ratio until
the weighted accuracy clears the SLO. On a downstream throughput error for
range r, blacklist its cascade at r and re-run the satisfaction loop.

On an OK call, attempt improvement swaps: a new cascade replaces the current
one only if it is >= in BOTH accuracy and throughput estimate (paper §4.3).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.plan_state import OK, PlanError, PlannerState


def _ordered_by_accuracy(state: PlannerState) -> List[int]:
    return sorted(range(len(state.cascades)),
                  key=lambda i: state.cascade_evals[i].accuracy)


def _allowed(state: PlannerState, r: int) -> List[int]:
    bl = state.blacklist.get(r, set())
    return [i for i in range(len(state.cascades)) if i not in bl]


def _init_assignment(state: PlannerState) -> None:
    n = state.n_ranges
    if state.slo.kind == "latency":
        # most performant in the non-SLO metric = most accurate
        best = max(range(len(state.cascades)),
                   key=lambda i: state.cascade_evals[i].accuracy)
        state.assignment = [best] * n
    else:
        cheapest = max(range(len(state.cascades)),
                       key=lambda i: state.cascade_tput[i])
        state.assignment = [cheapest] * n
        _satisfy_accuracy_slo(state)


def _satisfy_accuracy_slo(state: PlannerState) -> bool:
    """Greedy upgrades until weighted accuracy >= SLO. True on success.

    Fast path: each greedy step scores every (range, candidate) pair in one
    vectorized pass (same expression ``prior * dacc / dcost`` elementwise,
    row-major argmax = the legacy scan's first-strict-max tie-break, so the
    chosen upgrades are identical)."""
    if state.fast_path:
        return _satisfy_accuracy_slo_vec(state)
    target = state.slo.min_accuracy
    accs = [e.accuracy for e in state.cascade_evals]
    costs = [e.avg_cost for e in state.cascade_evals]
    while state.weighted_accuracy() < target - 1e-12:
        best_gain, best_r, best_c = 0.0, -1, -1
        for r in range(state.n_ranges):
            cur = state.assignment[r]
            for c in _allowed(state, r):
                dacc = accs[c] - accs[cur]
                if dacc <= 0:
                    continue
                dcost = max(costs[c] - costs[cur], 1e-12)
                gain = state.qps_prior[r] * dacc / dcost
                if gain > best_gain:
                    best_gain, best_r, best_c = gain, r, c
        if best_r < 0:
            return False
        state.assignment[best_r] = best_c
    return True


def _satisfy_accuracy_slo_vec(state: PlannerState) -> bool:
    target = state.slo.min_accuracy
    accs = np.asarray([e.accuracy for e in state.cascade_evals])
    costs = np.asarray([e.avg_cost for e in state.cascade_evals])
    n_r, n_c = state.n_ranges, len(accs)
    blocked = np.zeros((n_r, n_c), bool)
    for r, bl in state.blacklist.items():
        for c in bl:
            blocked[r, c] = True
    while state.weighted_accuracy() < target - 1e-12:
        cur = np.asarray(state.assignment)
        dacc = accs[None, :] - accs[cur][:, None]
        dcost = np.maximum(costs[None, :] - costs[cur][:, None], 1e-12)
        gain = (state.qps_prior[:, None] * dacc) / dcost
        gain[(dacc <= 0) | blocked] = -np.inf
        flat = int(np.argmax(gain))
        best_r, best_c = divmod(flat, n_c)
        if not gain[best_r, best_c] > 0.0:
            return False
        state.assignment[best_r] = best_c
    return True


def _downgrade(state: PlannerState, r: int, error: PlanError) -> bool:
    """Blacklist the current cascade at range r and pick the next one per
    the SLO direction. Returns False when no candidate remains.

    Accelerations over the paper's strict one-step downgrade (the
    error-driven loop remains the correctness mechanism; these only skip
    provably-doomed intermediate steps):
      * placement errors blacklist every cascade containing the unplaceable
        model at this range;
      * throughput errors jump to cascades whose SP1 throughput estimate
        clears the range's upper-bound QPS.
    """
    cur = state.assignment[r]
    bl = state.blacklist.setdefault(r, set())
    bl.add(cur)
    if error.code == "placement" and error.model is not None:
        for i, c in enumerate(state.cascades):
            if error.model in c.models:
                bl.add(i)
    allowed = _allowed(state, r)
    if not allowed:
        return False
    if state.slo.kind == "latency":
        # next cheaper (higher-throughput) cascade, max accuracy among those
        cur_t = state.cascade_tput[cur]
        faster = [i for i in allowed if state.cascade_tput[i] > cur_t]
        if not faster:
            return False
        if error.code in ("throughput", "latency"):
            strong = [i for i in faster
                      if state.cascade_tput[i] >= state.range_hi(r)]
            if strong:
                faster = strong
        state.assignment[r] = max(
            faster, key=lambda i: state.cascade_evals[i].accuracy)
        return True
    # accuracy SLO: pick max-throughput allowed, then restore weighted SLO
    state.assignment[r] = max(allowed, key=lambda i: state.cascade_tput[i])
    return _satisfy_accuracy_slo(state)


def _improve(state: PlannerState) -> None:
    """Swap in cascades better-or-equal in both metrics (paper §4.3)."""
    for r in range(state.n_ranges):
        cur = state.assignment[r]
        for c in _allowed(state, r):
            if c == cur:
                continue
            better_acc = state.cascade_evals[c].accuracy >= \
                state.cascade_evals[cur].accuracy
            better_tput = state.cascade_tput[c] >= state.cascade_tput[cur]
            strictly = (state.cascade_evals[c].accuracy >
                        state.cascade_evals[cur].accuracy or
                        state.cascade_tput[c] > state.cascade_tput[cur])
            if better_acc and better_tput and strictly:
                cur = c
        state.assignment[r] = cur


def assign_cascades(error: PlanError, state: PlannerState
                    ) -> Tuple[PlanError, PlannerState]:
    if not state.assignment:
        _init_assignment(state)
        if state.slo.kind == "accuracy" and \
                state.weighted_accuracy() < state.slo.min_accuracy - 1e-12:
            return PlanError(
                "accuracy",
                detail=f"even the most accurate assignment reaches "
                       f"{state.weighted_accuracy():.4f} < "
                       f"{state.slo.min_accuracy}"), state
        return OK, state

    if error.is_ok:
        _improve(state)
        return OK, state

    # downstream failure at a specific range: downgrade there
    r = error.qps_range if error.qps_range is not None else state.n_ranges - 1
    if _downgrade(state, r, error):
        return OK, state
    return PlanError(error.code, qps_range=r, model=error.model,
                     detail=f"range {r}: no remaining cascade can resolve "
                            f"'{error.code}' ({error.detail})"), state
