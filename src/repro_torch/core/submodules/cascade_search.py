"""Verbatim copy of ``repro/core/submodules/cascade_search.py``,
imports rewritten to ``repro_torch``.

SP1 — cascade search (paper §4.2).

Randomly samples cascades (ordered model subsets + discretised certainty
thresholds), evaluates accuracy on the registered validation set and
throughput with the analytic capacity model, and retains the Pareto-optimal
set. Always includes the cheapest single-model cascade and the most accurate
cascade (the paper's error-handling anchor points).

An incoming error means the downstream submodules failed even at the extreme
cascade -> the SLO is unattainable on this hardware; raise to the user.
"""
from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np

from repro_torch.core.cascade import (Cascade, CascadeEval,
                                enumerate_model_orderings, evaluate_cascade)
from repro_torch.core.certainty import threshold_grid
from repro_torch.core.fastsim import cascade_throughputs
from repro_torch.core.pareto import pareto_front
from repro_torch.core.plan_state import (OK, InfeasiblePlanError, PlanError,
                                   PlannerState)

MAX_CASCADE_LEN = 4
SAMPLE_BUDGET = 256
# Sampling rounds before SP1 becomes a fixed point (convergence needs the
# candidate set to stabilise; App. A's argument assumes this).
MAX_SAMPLE_ROUNDS = 3


def estimate_throughput(state: PlannerState, ev: CascadeEval,
                        cascade: Cascade) -> float:
    """Analytic sustainable-QPS upper bound on the full hardware: total
    device-seconds per arriving sample at efficient batch sizes."""
    cost = 0.0
    for frac, m in zip(ev.fractions, cascade.models):
        prof = state.profiles[m]
        b = prof.batch_sizes[-1]
        cost += frac * prof.runtime(b) / b
    if cost <= 0:
        return float("inf")
    return state.hardware.num_devices / cost


def _sample_cascades(state: PlannerState, rng: np.random.Generator
                     ) -> List[Cascade]:
    order = enumerate_model_orderings(state.profiles)
    grids = {m: threshold_grid(state.profiles[m].validation.certs)
             for m in order}
    out: List[Cascade] = []
    seen = set()

    def add(c: Cascade):
        if c not in seen:
            seen.add(c)
            out.append(c)

    # all single models
    for m in order:
        add(Cascade((m,), ()))
    # all ordered pairs/triples with sampled thresholds
    budget = SAMPLE_BUDGET if len(order) >= 2 else 0
    while budget > 0:
        k = int(rng.integers(2, min(MAX_CASCADE_LEN, len(order)) + 1))
        idxs = np.sort(rng.choice(len(order), size=k, replace=False))
        models = tuple(order[i] for i in idxs)
        thr = tuple(float(rng.choice(grids[m])) for m in models[:-1])
        add(Cascade(models, thr))
        budget -= 1
    return out


def search_cascades(error: PlanError, state: PlannerState
                    ) -> Tuple[PlanError, PlannerState]:
    if not error.is_ok:
        # downstream failed even on the extreme cascades (paper §4.2)
        raise InfeasiblePlanError(
            f"SLO {state.slo} unattainable on "
            f"{state.hardware.num_devices} devices: {error.detail or error.code}")

    round_no = getattr(state, "_sp1_rounds", 0)
    if round_no >= MAX_SAMPLE_ROUNDS and state.cascades:
        return OK, state  # candidate set frozen -> SP1 is a fixed point
    rng = np.random.default_rng(state.rng_seed + 7919 * round_no)
    state._sp1_rounds = round_no + 1  # type: ignore[attr-defined]

    candidates = _sample_cascades(state, rng)
    if state.fast_path:
        # evaluation is deterministic per cascade: candidates already in
        # the Pareto set (later sampling rounds and warm-started re-plans
        # re-draw mostly known ones) reuse their recorded evals, and the
        # throughput estimate runs as ONE vectorized pass over all new
        # candidates (bit-identical floats to the per-cascade loop below —
        # SP2's improvement swaps and the downgrade jumps consume exactly
        # these estimates)
        known = {c: (e, t) for c, e, t in
                 zip(state.cascades, state.cascade_evals,
                     state.cascade_tput)}
        fresh = [c for c in candidates if c not in known]
        fresh_evals = [evaluate_cascade(c, state.profiles) for c in fresh]
        fresh_tputs = cascade_throughputs(state.profiles,
                                          state.hardware.num_devices,
                                          fresh, fresh_evals)
        new = {c: (e, t) for c, e, t in zip(fresh, fresh_evals,
                                            fresh_tputs)}
        evals, tputs = [], []
        for c in candidates:
            e, t = known.get(c) or new[c]
            evals.append(e)
            tputs.append(t)
    else:
        evals = [evaluate_cascade(c, state.profiles) for c in candidates]
        tputs = [estimate_throughput(state, e, c)
                 for c, e in zip(candidates, evals)]

    items = list(zip(candidates, evals, tputs))
    front = pareto_front(items, cost=lambda it: -it[2],
                         quality=lambda it: it[1].accuracy)

    # anchors: cheapest (max-throughput) cascade & most accurate cascade
    cheapest = max(items, key=lambda it: it[2])
    most_acc = max(items, key=lambda it: it[1].accuracy)
    for anchor in (cheapest, most_acc):
        if anchor not in front:
            front.append(anchor)

    if not state.cascades:
        front.sort(key=lambda it: it[1].accuracy)
        state.cascades = [it[0] for it in front]
        state.cascade_evals = [it[1] for it in front]
        state.cascade_tput = [it[2] for it in front]
    else:
        # later rounds only APPEND new candidates: existing indices (and
        # with them SP2's assignment + blacklists) stay valid; SP2's
        # improvement pass decides whether to swap them in (paper §4.3).
        known = set(state.cascades)
        for c, e, t in front:
            if c not in known:
                state.cascades.append(c)
                state.cascade_evals.append(e)
                state.cascade_tput.append(t)
    return OK, state
