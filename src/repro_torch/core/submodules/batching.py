"""Verbatim copy of ``repro/core/submodules/batching.py``,
imports rewritten to ``repro_torch``.

SP4 — dynamic batching (paper §4.5): tune min-queue-lengths per QPS range.

For each range: start with min queue length 1 on the FIRST model of the
cascade (cascaded samples arrive at later models in batch-sized chunks, so
the first model's trigger size drives the whole cascade's batching), find the
smallest trigger that serves the range's upper-bound QPS stably, and error
(to SP3) when no trigger helps, latency blows the SLO, or the trigger
exceeds the cap — naming the bottleneck model.

Two search engines share those semantics (DESIGN.md §10):

* legacy (``state.fast_path=False``) — the pre-fast-path loop: simulate the
  trigger ladder step by step with the exact DES until the first stable
  entry. This is the honest baseline arm of ``benchmarks/bench_planner``.
* fast (default) — score the WHOLE ladder in one vectorized
  ``FastEvaluator.evaluate_ladder`` call and pick the first entry the
  steady-state model (or a recorded exact-DES fact, which always wins)
  calls stable. No simulation runs inside the planner loop; instead the
  converged plan is certified range-by-range by the exact DES
  (``certify_ranges``, driven by ``core.planner``): the chosen trigger must
  be DES-stable, DES-minimal (the previous ladder entry DES-unstable), and
  DES-p95-compliant. Disagreements are recorded in the ``SimMemo`` and the
  planner loop resumes, so the *fixed point* satisfies exactly the
  invariants the legacy search enforced per call — while warm re-plans
  reuse certified outcomes verbatim.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.fastsim import (MAX_MIN_QUEUE, UTIL_GUESS, FastEvaluator,
                                SimOutcome, sim_memo_key, trigger_ladder)
from repro_torch.core.gears import Gear
from repro_torch.core.plan_state import OK, PlanError, PlannerState
from repro_torch.core.simulator import ServingSimulator
from repro_torch.core.submodules.hardware_mapping import _bottleneck_model, _counts


# ---------------------------------------------------------------------------
# Shared plumbing: per-range sim parameters, cached simulator/evaluator,
# memoized exact-DES outcomes
# ---------------------------------------------------------------------------

def _range_sim_params(state: PlannerState, r: int) -> Tuple[float, float, int]:
    """(qps, horizon, warm backlog) for one range's feasibility sim.

    Multi-tenant planning (core/tenancy.py): the DES simulates only this
    tenant's cascade, but the shared placement also serves the other
    tenants. Their expected load (``state.background_qps``) is folded in
    as WORK-EQUIVALENT demand inflation — the tenant's QPS is scaled so
    the solo sim consumes the device-time of tenant + background — making
    SP4's stability/latency verdicts superposition-aware. Single-tenant
    states (``background_qps`` unset) are untouched, bit-identically.
    """
    qps = state.range_hi(r) * _background_inflation(state, r)
    horizon = state.sim_horizon
    if qps * horizon < 64:  # low ranges: simulate enough samples
        horizon = min(30.0, 64.0 / max(qps, 1.0))
    # warm backlog: the gear inherits queued work when the producer
    # upshifts mid-spike; a feasible gear must digest it within the SLO
    backlog = int(0.25 * qps)
    return qps, horizon, backlog


def _background_inflation(state: PlannerState, r: int) -> float:
    """1 + (background work / own work) at range r, in per-sample seconds
    at the efficient batch size (the same optimistic rate the LPs price
    capacity with, so the two contention views stay consistent)."""
    bg = state.background_qps
    if not bg:
        return 1.0

    def work(m: str) -> float:
        prof = state.profiles[m]
        b = prof.batch_sizes[-1]
        return prof.runtime(b) / b

    casc = state.cascade_of_range(r)
    ev = state.eval_of_range(r)
    own = sum(f * state.range_hi(r) * work(m)
              for m, f in zip(casc.models, ev.fractions))
    if own <= 0:
        return 1.0
    other = sum(q * work(m) for m, q in bg.items() if m in state.profiles)
    return 1.0 + other / own


def _range_gear(state: PlannerState, r: int,
                min_qlens: Dict[str, int]) -> Gear:
    return Gear(cascade=state.cascade_of_range(r), min_queue_lens=min_qlens,
                load_fractions=state.load_fracs[r])


def _sim_for(state: PlannerState) -> ServingSimulator:
    """One simulator per (profiles, placement): the ReplayBackend (and its
    interpolation memo) is shared across every planner sim."""
    backend = getattr(state, "_replay_backend", None)
    if backend is None or backend.profiles is not state.profiles:
        from repro_torch.core.execution import ReplayBackend
        backend = ReplayBackend(state.profiles)
        state._replay_backend = backend  # type: ignore[attr-defined]
    sim = getattr(state, "_range_sim", None)
    if sim is None or sim.replicas != state.replicas or \
            sim.cfg is not state.sim_cfg or \
            sim.num_devices != state.hardware.num_devices:
        sim = ServingSimulator(state.profiles, state.replicas,
                               state.hardware.num_devices, state.sim_cfg,
                               backend=backend)
        state._range_sim = sim  # type: ignore[attr-defined]
    return sim


def _vecsim_for(state: PlannerState):
    """Lane-batched engine for Monte-Carlo certification, cached like
    ``_sim_for`` and sharing the same ReplayBackend (so the interpolation
    memo is warm from the certification walk that just ran)."""
    from repro_torch.core.vecsim import VecSim
    _sim_for(state)              # ensures state._replay_backend exists
    vec = getattr(state, "_range_vecsim", None)
    if vec is None or vec.replicas != state.replicas or \
            vec.cfg is not state.sim_cfg or \
            vec.num_devices != state.hardware.num_devices:
        vec = VecSim(state.profiles, state.replicas,
                     state.hardware.num_devices, state.sim_cfg,
                     backend=state._replay_backend)
        state._range_vecsim = vec  # type: ignore[attr-defined]
    return vec


def _evaluator_for(state: PlannerState) -> FastEvaluator:
    ev = getattr(state, "_fast_eval", None)
    if ev is None or ev.profiles is not state.profiles:
        ev = FastEvaluator(state.profiles)
        state._fast_eval = ev  # type: ignore[attr-defined]
    return ev


def _simulate_range(state: PlannerState, sim: ServingSimulator, r: int,
                    min_qlens: Dict[str, int]):
    """Exact DES feasibility run for one range (the legacy probe)."""
    qps, horizon, backlog = _range_sim_params(state, r)
    return sim.run_fixed(_range_gear(state, r, min_qlens), qps=qps,
                         horizon=horizon, warm_start_backlog=backlog)


def _des_outcome(state: PlannerState, r: int,
                 min_qlens: Dict[str, int]) -> SimOutcome:
    """Memoized exact-DES verdict for one (range, trigger) config."""
    qps, horizon, backlog = _range_sim_params(state, r)
    gear = _range_gear(state, r, min_qlens)
    key = sim_memo_key(gear, qps, horizon, backlog, state.sim_cfg,
                       state.replicas, state.hardware.num_devices)
    out = state.sim_memo.get(key)
    if out is None:
        res = _sim_for(state).run_fixed(gear, qps=qps, horizon=horizon,
                                        warm_start_backlog=backlog)
        out = SimOutcome(stable=bool(res.stable), p95=float(res.p95),
                         throughput=float(res.throughput),
                         completed=int(res.completed))
        state.sim_memo.put(key, out)
    return out


def _memo_peek(state: PlannerState, r: int,
               min_qlens: Dict[str, int]) -> Optional[SimOutcome]:
    """A recorded DES fact for this config, or None (no simulation runs)."""
    qps, horizon, backlog = _range_sim_params(state, r)
    key = sim_memo_key(_range_gear(state, r, min_qlens), qps, horizon,
                       backlog, state.sim_cfg, state.replicas,
                       state.hardware.num_devices)
    return state.sim_memo.peek(key)


def _ladder_mq(state: PlannerState, r: int, trig: int) -> Dict[str, int]:
    casc = state.cascade_of_range(r)
    mq = {m: 1 for m in casc.models}
    mq[casc.models[0]] = trig
    return mq


# ---------------------------------------------------------------------------
# The submodule
# ---------------------------------------------------------------------------

def tune_batch_sizes(error: PlanError, state: PlannerState
                     ) -> Tuple[PlanError, PlannerState]:
    lat_cap = state.slo.latency_p95 if state.slo.kind == "latency" else None

    min_qlens_all, p95_all, stable_all = [], [], []
    for r in range(state.n_ranges):
        if state.fast_path:
            err, mq, p95 = _search_fast(state, r, lat_cap)
        else:
            err, mq, p95 = _search_legacy(state, r, lat_cap)
        if err is not None:
            return err, state
        err = _slot_stability_error(state, r)
        if err is not None:
            return err, state
        min_qlens_all.append(mq)
        p95_all.append(p95)
        stable_all.append(True)

    state.min_qlens = min_qlens_all
    state.range_p95 = p95_all
    state.range_stable = stable_all
    return OK, state


def _slot_stability_error(state: PlannerState, r: int
                          ) -> Optional[PlanError]:
    """Token-level serving (DESIGN.md §13): Little's-law slot stability.

    A request generating tokens holds a KV-cache decode slot for its whole
    residency, so the expected number of RESIDENT requests at model m under
    range r's demand is  frac_m * qps_hi(r) * residency_m  (Little's law).
    If that exceeds the slots the placement provisions
    (decode_slots[m] * replica_count(m)), the decode batch saturates and
    waiting queues grow without bound no matter what the one-shot DES says
    — so the verdict is a throughput error naming m, which SP3 answers by
    forcing an extra replica. One-shot states (``decode_slots`` /
    ``token_residency`` empty) skip the check, bit-identically.
    """
    if not state.decode_slots or not state.token_residency:
        return None
    casc = state.cascade_of_range(r)
    ev = state.eval_of_range(r)
    counts = _counts(state.replicas)
    for m, frac in zip(casc.models, ev.fractions):
        res_t = state.token_residency.get(m)
        slots = state.decode_slots.get(m)
        if res_t is None or slots is None:
            continue
        need = frac * state.range_hi(r) * res_t
        have = slots * counts.get(m, 0)
        if need > have:
            return PlanError(
                "throughput", qps_range=r, model=m,
                detail=f"range {r}: KV decode slots saturated at {m} "
                       f"(need {need:.1f} resident, have {have})")
    return None


def _search_legacy(state: PlannerState, r: int, lat_cap: Optional[float]
                   ) -> Tuple[Optional[PlanError], Dict[str, int], float]:
    """Pre-fast-path search: exact DES at every trigger-growth step."""
    sim = _sim_for(state)
    casc = state.cascade_of_range(r)
    mq = {m: 1 for m in casc.models}
    first = casc.models[0]
    best = None
    while True:
        res = _simulate_range(state, sim, r, dict(mq))
        if res.stable:
            best = (dict(mq), res)
            break
        if mq[first] >= MAX_MIN_QUEUE:
            break
        # larger trigger on the first model -> larger batches everywhere
        mq[first] = min(MAX_MIN_QUEUE,
                        max(mq[first] + 1, int(mq[first] * 1.5)))
    if best is None:
        return PlanError(
            "throughput", qps_range=r,
            model=_bottleneck_model(state, r, state.replicas),
            detail=f"range {r} unstable even at min queue "
                   f"{MAX_MIN_QUEUE}"), {}, 0.0
    mq, res = best
    if lat_cap is not None and res.p95 > lat_cap:
        return PlanError(
            "latency", qps_range=r,
            model=_slowest_model(state, r),
            detail=f"range {r}: p95 {res.p95 * 1e3:.0f}ms > SLO "
                   f"{lat_cap * 1e3:.0f}ms"), {}, 0.0
    return None, mq, res.p95


def _search_fast(state: PlannerState, r: int, lat_cap: Optional[float]
                 ) -> Tuple[Optional[PlanError], Dict[str, int], float]:
    """Fast trigger search with exact-DES verdicts (DESIGN.md §10).

    The vectorized evaluator scores the WHOLE ladder in one batched call,
    but only to place the starting guess: every verdict the submodule
    returns — stability, the chosen trigger, the p95 error — comes from the
    exact (memoized) DES, so the planner trajectory matches the legacy
    search decision for decision. The guess + bisection needs O(log ladder)
    simulations for a new config where the legacy scan pays one per ladder
    step, and re-visited configs are memo hits.
    """
    ladder = trigger_ladder(MAX_MIN_QUEUE)
    # exact shortcut: when DES facts are recorded contiguously from the
    # ladder bottom (a prior walk-down leaves them there), the first
    # stable fact IS the legacy answer — no estimate, no simulation. Runs
    # BEFORE the vectorized estimate so fully-memoized warm re-plans (the
    # recurring BackgroundReplanner cost) skip the fixed-point iteration
    # entirely.
    first_known = None
    for j in range(len(ladder)):
        fact = _memo_peek(state, r, _ladder_mq(state, r, ladder[j]))
        if fact is None:
            break
        if fact.stable:
            first_known = (j, fact)
            break
    if first_known is not None:
        g, out = first_known
        if lat_cap is not None and out.p95 > lat_cap:
            return PlanError(
                "latency", qps_range=r,
                model=_slowest_model(state, r),
                detail=f"range {r}: p95 {out.p95 * 1e3:.0f}ms > SLO "
                       f"{lat_cap * 1e3:.0f}ms"), {}, 0.0
        return None, _ladder_mq(state, r, ladder[g]), out.p95

    casc = state.cascade_of_range(r)
    qps, horizon, backlog = _range_sim_params(state, r)
    fe = _evaluator_for(state).evaluate_ladder(
        casc, state.eval_of_range(r), state.load_fracs[r], state.replicas,
        state.hardware.num_devices, qps, state.sim_cfg, ladder,
        offered=qps * horizon + backlog)
    guess_ok = np.flatnonzero(fe.util <= UTIL_GUESS)
    g = int(guess_ok[0]) if len(guess_ok) else int(np.argmin(fe.util))

    out = _des_outcome(state, r, _ladder_mq(state, r, ladder[g]))
    while not out.stable:
        # guess was optimistic: fall back to the next candidate whose
        # ESTIMATED utilisation improves on the one the DES just rejected
        # (skipping equivalent-looking entries), each fallback DES-verified
        thr = fe.util[g] - max(0.005, 0.01 * fe.util[g])
        better = np.flatnonzero(fe.util < thr)
        better = better[better > g]
        nxt = int(better[0]) if len(better) else g + 1
        if nxt >= len(ladder):
            # before declaring the range infeasible, re-scan the WHOLE
            # ladder exactly as the legacy search does (memoized, so only
            # entries the jumps skipped are simulated): DES stability can
            # be non-monotone — a stable island between two jump probes
            # must not become a spurious "SLO unattainable"
            g, out = -1, None
            for i in range(len(ladder)):
                out = _des_outcome(state, r, _ladder_mq(state, r,
                                                        ladder[i]))
                if out.stable:
                    g = i
                    break
            if g < 0:
                return PlanError(
                    "throughput", qps_range=r,
                    model=_bottleneck_model(state, r, state.replicas),
                    detail=f"range {r} unstable even at min queue "
                           f"{MAX_MIN_QUEUE}"), {}, 0.0
            break
        g = nxt
        out = _des_outcome(state, r, _ladder_mq(state, r, ladder[g]))

    # settle down the ladder: any RECORDED stable fact below wins first
    # (stability islands discovered by earlier probes — certification and
    # this search must agree on them or they would restart forever), then
    # refine to the first-DES-stable entry by bisection: the p95 the
    # latency verdict (and the plan) is built on must belong to exactly
    # the trigger the legacy scan would have chosen, or one masked/
    # spurious latency error re-routes SP2's whole downgrade chain
    for j in range(g):
        fact = _memo_peek(state, r, _ladder_mq(state, r, ladder[j]))
        if fact is not None and fact.stable:
            g, out = j, fact
            break
    g, out = _descend_to_minimal(state, r, ladder, g, out)

    if lat_cap is not None and out.p95 > lat_cap:
        return PlanError(
            "latency", qps_range=r,
            model=_slowest_model(state, r),
            detail=f"range {r}: p95 {out.p95 * 1e3:.0f}ms > SLO "
                   f"{lat_cap * 1e3:.0f}ms"), {}, 0.0
    return None, _ladder_mq(state, r, ladder[g]), out.p95


def _descend_to_minimal(state: PlannerState, r: int, ladder, g: int,
                        out: SimOutcome) -> Tuple[int, SimOutcome]:
    """Bisect down to the first-DES-stable ladder entry (stability is
    monotone in the trigger for the steady-state regimes the planner
    visits; the legacy search scans the same boundary linearly)."""
    if g == 0:
        return g, out
    below = _memo_peek(state, r, _ladder_mq(state, r, ladder[g - 1]))
    if below is not None and not below.stable:
        return g, out            # boundary already established
    lo_out = _des_outcome(state, r, _ladder_mq(state, r, ladder[0]))
    if lo_out.stable:
        return 0, lo_out
    lo, hi = 0, g
    while hi - lo > 1:
        mid = (lo + hi) // 2
        mid_out = _des_outcome(state, r, _ladder_mq(state, r, ladder[mid]))
        if mid_out.stable:
            hi, out = mid, mid_out
        else:
            lo = mid
    return hi, out


# ---------------------------------------------------------------------------
# Certification: the exact DES has the last word
# ---------------------------------------------------------------------------

def certify_ranges(state: PlannerState,
                   num_seeds: Optional[int] = None) -> bool:
    """DES-certify the converged plan range-by-range (DESIGN.md §10).

    For every range the chosen trigger must be (a) stable under the exact
    simulator, (b) minimal — the previous ladder entry DES-unstable — and
    (c) within the latency SLO per the DES p95. On a stability disagreement
    the ladder is walked (up while DES-unstable / down while DES-stable,
    the "fall back to the next candidate" of the fast-path contract) so ONE
    certification round records every DES fact the resumed planner loop
    needs to reproduce the legacy first-DES-stable choice. Returns True
    when the plan stands, after installing the exact per-range p95s into
    the state. Each failing round adds DES facts for configs the estimate
    had judged differently, so certification terminates.

    Monte-Carlo mode (DESIGN.md §12): with ``num_seeds`` (default
    ``state.mc_seeds``) above 1, a plan that passes the point-estimate walk
    additionally gets each range scored across that many arrival seeds in
    ONE lane-batched vecsim call, and ``state.mc_p95`` records the
    per-range (mean, 95% CI half-width) of the p95 distribution. The walk
    itself — and therefore the certified plan — is byte-identical to the
    single-seed certifier; the extra lanes only widen the *verdict* the
    provenance (and the drift monitor) carries.
    """
    ladder = trigger_ladder(MAX_MIN_QUEUE)
    lat_cap = state.slo.latency_p95 if state.slo.kind == "latency" else None
    ok = True
    p95s = list(state.range_p95)
    for r in range(state.n_ranges):
        mq = state.min_qlens[r]
        first = state.cascade_of_range(r).models[0]
        chosen = ladder.index(mq[first])
        i = chosen
        out = _des_outcome(state, r, dict(mq))
        while not out.stable and i + 1 < len(ladder):
            i += 1           # estimate was optimistic: walk up to the
            out = _des_outcome(state, r,          # first DES-stable trigger
                               _ladder_mq(state, r, ladder[i]))
        # minimality: walk down while the DES accepts smaller triggers,
        # and honour any RECORDED stable fact further below (a stability
        # island discovered by an earlier probe must win, as it would have
        # in the legacy bottom-up scan). Exhaustively re-proving every
        # lower rung unstable would cost exactly the legacy scan; under
        # non-monotone islands never probed, the certified plan can sit
        # one boundary higher than legacy's — still DES-stable and
        # DES-p95-compliant (see DESIGN.md §10; the parity tests and the
        # bench pin full equality on the tested scenarios).
        while out.stable and i > 0:
            below = _des_outcome(state, r,
                                 _ladder_mq(state, r, ladder[i - 1]))
            if not below.stable:
                break
            i, out = i - 1, below
        for j in range(i - 1):
            fact = _memo_peek(state, r, _ladder_mq(state, r, ladder[j]))
            if fact is not None and fact.stable:
                i, out = j, fact
                break
        if i != chosen or not out.stable:
            ok = False       # the resumed loop re-picks from the DES facts
            continue
        if lat_cap is not None and out.p95 > lat_cap:
            ok = False
            continue
        p95s[r] = out.p95
    if ok:
        state.range_p95 = p95s
        state.range_stable = [True] * state.n_ranges
        n = state.mc_seeds if num_seeds is None else num_seeds
        state.mc_p95 = _mc_certify(state, n) if n > 1 else []
    return ok


def _mc_certify(state: PlannerState, n: int) -> list:
    """Per-range (mean, CI) of the DES p95 across ``n`` arrival seeds,
    via one lane-batched vecsim call per range (memoized on the state so
    warm re-plans over unchanged ranges pay nothing). Lane 0 runs seed
    ``cfg.seed`` — the exact configuration the point-estimate walk just
    certified — so the distribution always brackets the recorded p95."""
    from repro_torch.core.vecsim import mc_summary
    vec = _vecsim_for(state)
    out = []
    for r in range(state.n_ranges):
        qps, horizon, backlog = _range_sim_params(state, r)
        gear = _range_gear(state, r, state.min_qlens[r])
        key = (sim_memo_key(gear, qps, horizon, backlog, state.sim_cfg,
                            state.replicas, state.hardware.num_devices), n)
        mc = state.mc_memo.get(key)
        if mc is None:
            seeds = [state.sim_cfg.seed + i for i in range(n)]
            lanes = vec.run_fixed_lanes(gear, qps=qps, horizon=horizon,
                                        warm_start_backlog=backlog,
                                        seeds=seeds)
            mc = mc_summary([res.p95 for res in lanes])
            state.mc_memo[key] = mc
        out.append(mc)
    return out


def _slowest_model(state: PlannerState, r: int) -> str:
    casc = state.cascade_of_range(r)
    return max(casc.models,
               key=lambda m: state.profiles[m].runtime_per_sample(1.0))
