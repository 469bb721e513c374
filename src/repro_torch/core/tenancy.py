"""Verbatim copy of ``repro/core/tenancy.py``,
imports rewritten to ``repro_torch``.

Multi-tenant serving: per-tenant gear plans over one shared fleet.

CascadeServe's gear plan (§3-§4) adapts ONE workload to one fleet. A real
deployment serves several workloads with distinct SLOs concurrently
(INFaaS's many-tenants-one-interface premise), and real arrival processes
exceed the planned range (SuperServe's unpredictable-load premise). This
module adds the tenancy layer that composes both with cascades
(DESIGN.md §11):

* ``TenantSpec``       — one workload: name, SLO, planned QPS range and
                         prior, and a weight for fair sharing under
                         overload.
* ``MultiTenantPlan``  — one gear ladder PER TENANT over a single shared
                         placement, plus the per-gear demand coefficients
                         the admission controller prices capacity with.
* ``plan_multi_tenant``— the planner extension: per-tenant solo passes
                         (SP1 candidates + exact-DES memos), ONE joint
                         placement for the summed worst-case demand
                         (``solve_joint_placement``), then per-tenant
                         SP2/SP4 re-runs PINNED to that placement and
                         warm-started from the solo states — the same
                         pinning machinery online re-planning uses, so
                         per-tenant ladders stay hot-swappable.
* ``run_multi_tenant_sim`` — the discrete-event driver for multi-tenant
                         arrival traces: tenant-tagged shared replica
                         queues, per-tenant ``SchedulerCore``s with KEYED
                         route-RNG streams (inserting a tenant cannot
                         perturb another tenant's draws), per-tenant gear
                         selection and plan lifecycles, and the
                         ``AdmissionController`` hooks (downgrade /
                         weighted-fair / shed). ``ServingSimulator
                         .run_multi_tenant`` and ``repro.serving.runtime
                         .MultiTenantServer`` drive the same decision
                         sequence (parity-tested).
* ``make_tenant_lifecycles`` — per-tenant drift monitoring + background
                         re-planning: only the drifted tenant's ladder is
                         re-solved; the shared placement stays pinned.

Batching is tenant-blind by design: a replica queue holds samples of every
tenant whose cascade routes through that (model, device), and one fired
batch may mix tenants — execution is per-model, and each sample resolves or
cascades under its own admitting gear, so nothing in the hot path needs a
tenant check. The batch trigger for a shared queue is the MINIMUM of the
queued tenants' current-gear triggers (the most latency-eager waiting
tenant sets the pace).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.gears import Gear, GearPlan, SLO
from repro_torch.core.lp import Replica
from repro_torch.core.scheduling import (CascadeHop, DecisionTrace, RoutePool,
                                   SchedulerCore, head_of_line_wait,
                                   is_ensemble, plan_target,
                                   with_hysteresis)
from repro_torch.core.simulator import SimResult, _ArrayQueue, trace_to_arrivals

__all__ = ["TenantSpec", "MultiTenantPlan", "MultiTenantReport",
           "TenantResult", "plan_multi_tenant", "make_tenant_lifecycles",
           "merge_tenant_arrivals", "effective_trigger",
           "run_multi_tenant_sim", "gear_demand_from_state",
           "single_tenant_plan"]


# ---------------------------------------------------------------------------
# Specs and the multi-tenant plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantSpec:
    """One tenant's workload contract."""
    name: str
    slo: SLO
    qps_max: float                         # planned offered-load ceiling
    weight: float = 1.0                    # fair-share weight (0 = best
    #                                        effort: first to shed)
    n_ranges: int = 8
    qps_prior: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("a tenant needs a non-empty name")
        if self.qps_max <= 0:
            raise ValueError(
                f"tenant {self.name}: qps_max must be positive, got "
                f"{self.qps_max}")
        if self.weight < 0:
            raise ValueError(
                f"tenant {self.name}: weight must be >= 0, got "
                f"{self.weight}")
        if self.n_ranges < 1:
            raise ValueError(
                f"tenant {self.name}: n_ranges must be >= 1, got "
                f"{self.n_ranges}")
        if self.qps_prior is not None and \
                len(self.qps_prior) != self.n_ranges:
            raise ValueError(
                f"tenant {self.name}: qps_prior has "
                f"{len(self.qps_prior)} weights for {self.n_ranges} ranges")

    def to_dict(self) -> Dict:
        return {"name": self.name,
                "slo": {"kind": self.slo.kind,
                        "latency_p95": self.slo.latency_p95,
                        "min_accuracy": self.slo.min_accuracy},
                "qps_max": self.qps_max, "weight": self.weight,
                "n_ranges": self.n_ranges,
                "qps_prior": list(self.qps_prior)
                if self.qps_prior is not None else None}

    @classmethod
    def from_dict(cls, d: Dict) -> "TenantSpec":
        return cls(name=d["name"],
                   slo=SLO(kind=d["slo"]["kind"],
                           latency_p95=d["slo"]["latency_p95"],
                           min_accuracy=d["slo"]["min_accuracy"]),
                   qps_max=float(d["qps_max"]),
                   weight=float(d.get("weight", 1.0)),
                   n_ranges=int(d.get("n_ranges", 8)),
                   qps_prior=tuple(float(x) for x in d["qps_prior"])
                   if d.get("qps_prior") is not None else None)


@dataclass
class MultiTenantPlan:
    """Per-tenant gear ladders over ONE shared placement.

    Every tenant's ``GearPlan`` carries the identical replica list (same
    models on the same devices) — that is what makes the ladders
    independently hot-swappable: a drifted tenant's re-plan changes only
    its own gear table, never where models live. ``gear_demand`` holds,
    per tenant and per gear, the fraction of that tenant's QPS expected to
    reach each model (the planner's cascade-eval fractions) — the
    coefficients the admission controller uses to price fleet capacity.
    """
    tenants: List[TenantSpec]
    plans: Dict[str, GearPlan]
    gear_demand: Dict[str, List[Dict[str, float]]] = field(
        default_factory=dict)

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("a multi-tenant plan needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        missing = [n for n in names if n not in self.plans]
        if missing:
            raise ValueError(f"no gear plan for tenant(s) {missing}")
        ref = self.plans[names[0]].replicas
        for n in names[1:]:
            reps = self.plans[n].replicas
            if len(reps) != len(ref) or any(
                    a.model != b.model or a.device != b.device
                    for a, b in zip(reps, ref)):
                raise ValueError(
                    f"tenant {n}'s plan does not share the placement of "
                    f"{names[0]} — per-tenant ladders must sit over one "
                    f"fixed replica set")

    @property
    def names(self) -> List[str]:
        return [t.name for t in self.tenants]

    @property
    def replicas(self) -> List[Replica]:
        return self.plans[self.tenants[0].name].replicas

    @property
    def num_devices(self) -> int:
        return self.plans[self.tenants[0].name].num_devices

    def spec(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    # ---- (de)serialisation ------------------------------------------------
    def to_dict(self) -> Dict:
        return {"tenants": [t.to_dict() for t in self.tenants],
                "plans": {n: p.to_dict() for n, p in self.plans.items()},
                "gear_demand": {
                    n: [dict(d) for d in demands]
                    for n, demands in self.gear_demand.items()}}

    @classmethod
    def from_dict(cls, d: Dict) -> "MultiTenantPlan":
        return cls(
            tenants=[TenantSpec.from_dict(t) for t in d["tenants"]],
            plans={n: GearPlan.from_dict(p)
                   for n, p in d["plans"].items()},
            gear_demand={n: [{m: float(v) for m, v in g.items()}
                             for g in demands]
                         for n, demands in d.get("gear_demand",
                                                 {}).items()})

    def to_json(self) -> str:
        import json
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "MultiTenantPlan":
        import json
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# The planner extension
# ---------------------------------------------------------------------------

@dataclass
class MultiTenantReport:
    plan: MultiTenantPlan
    # final (pinned) per-tenant planner reports — warm states for re-plans
    reports: Dict[str, "object"]
    # per-tenant background contention term (other tenants' mean demand)
    backgrounds: Dict[str, Dict[str, float]]
    wall_seconds: float = 0.0


def plan_multi_tenant(profiles, hardware, tenants: Sequence[TenantSpec],
                      sim_cfg=None, seed: int = 0, fast_path: bool = True,
                      max_calls: int = 200,
                      num_seeds: int = 1) -> MultiTenantReport:
    """Joint multi-tenant planning (DESIGN.md §11).

    1. **Solo pass** — Algorithm 1 per tenant on the full hardware: yields
       each tenant's Pareto cascades, per-range demand, and (fast path)
       exact-DES memos.
    2. **Joint placement** — ONE placement for the fleet, provisioned for
       the simultaneous worst case: the Eq.-4 prune/repair against the sum
       over tenants of their per-model worst-case QPS.
    3. **Pinned pass** — Algorithm 1 per tenant again, placement pinned to
       the joint result, warm-started from the solo state (SP1 candidates
       + ``SimMemo`` carry), with the OTHER tenants' prior-weighted mean
       demand as ``background_qps`` so each tenant's load-balancing LPs
       see the contention they will actually meet.

    Raises ``InfeasiblePlanError`` naming the tenant whose SLO cannot be
    met on the shared placement.
    """
    from repro_torch.core.planner import optimize_gear_plan
    from repro_torch.core.plan_state import InfeasiblePlanError
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.submodules.hardware_mapping import (
        _worst_case_qps, mean_qps_per_model, solve_joint_placement)

    t0 = time.time()
    tenants = list(tenants)
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    sim_cfg = sim_cfg if sim_cfg is not None else SimConfig()

    solo = {}
    for t in tenants:
        try:
            solo[t.name] = optimize_gear_plan(
                profiles, hardware, t.slo, t.qps_max, n_ranges=t.n_ranges,
                qps_prior=np.asarray(t.qps_prior, np.float64)
                if t.qps_prior is not None else None,
                sim_cfg=sim_cfg, seed=seed, max_calls=max_calls,
                fast_path=fast_path, num_seeds=num_seeds)
        except InfeasiblePlanError as e:
            raise InfeasiblePlanError(
                f"tenant {t.name} (solo pass): {e}") from e

    # simultaneous worst case: every tenant at its own per-range peak
    wc_total: Dict[str, float] = {}
    used: List[str] = []
    min_reps: Dict[str, int] = {}
    for t in tenants:
        st = solo[t.name].state
        for m, q in _worst_case_qps(st).items():
            wc_total[m] = wc_total.get(m, 0.0) + q
        for m in st.models_used():
            if m not in used:
                used.append(m)
        for m, k in st.min_replicas.items():
            min_reps[m] = max(min_reps.get(m, 1), k)
    joint = solve_joint_placement(profiles, hardware, wc_total, used,
                                  min_reps, fast_path=fast_path)

    means = {t.name: mean_qps_per_model(solo[t.name].state)
             for t in tenants}
    backgrounds: Dict[str, Dict[str, float]] = {}
    reports = {}
    for t in tenants:
        bg: Dict[str, float] = {}
        for other in tenants:
            if other.name == t.name:
                continue
            for m, q in means[other.name].items():
                bg[m] = bg.get(m, 0.0) + q
        backgrounds[t.name] = bg
        try:
            reports[t.name] = optimize_gear_plan(
                profiles, hardware, t.slo, t.qps_max, n_ranges=t.n_ranges,
                qps_prior=np.asarray(t.qps_prior, np.float64)
                if t.qps_prior is not None else None,
                sim_cfg=sim_cfg, seed=seed, max_calls=max_calls,
                pinned_replicas=joint, warm_state=solo[t.name].state,
                fast_path=fast_path, background_qps=bg,
                num_seeds=num_seeds)
        except InfeasiblePlanError as e:
            raise InfeasiblePlanError(
                f"tenant {t.name}: SLO unattainable on the shared "
                f"placement ({e})") from e

    gear_demand = {t.name: gear_demand_from_state(reports[t.name].state)
                   for t in tenants}

    mt = MultiTenantPlan(
        tenants=tenants,
        plans={t.name: reports[t.name].plan for t in tenants},
        gear_demand=gear_demand)
    return MultiTenantReport(plan=mt, reports=reports,
                             backgrounds=backgrounds,
                             wall_seconds=time.time() - t0)


def gear_demand_from_state(state) -> List[Dict[str, float]]:
    """Per-gear per-model demand coefficients (fraction of tenant QPS
    reaching each cascade stage) from a converged planner state — the
    capacity-pricing input of ``repro.core.admission``."""
    out = []
    for r in range(state.n_ranges):
        casc = state.cascade_of_range(r)
        ev = state.eval_of_range(r)
        out.append({m: float(f) for m, f in zip(casc.models, ev.fractions)})
    return out


def single_tenant_plan(spec: TenantSpec, report) -> MultiTenantPlan:
    """Wrap one tenant's solo ``PlannerReport`` as a single-tenant
    ``MultiTenantPlan`` — how the static-partition baseline runs each
    partition through the same multi-tenant machinery (admission included)
    as the shared fleet, so the comparison isolates SHARING itself."""
    return MultiTenantPlan(
        tenants=[spec], plans={spec.name: report.plan},
        gear_demand={spec.name: gear_demand_from_state(report.state)})


def make_tenant_lifecycles(report: MultiTenantReport, profiles, hardware,
                           monitor_cfg=None, plan_latency: float = 1.0,
                           sim_cfg=None, fast_path: bool = True,
                           qps_margin: float = 1.25) -> Dict[str, object]:
    """One ``PlanLifecycle`` per tenant: its own drift monitor (over its
    plan's provenance) and its own background re-planner, pinned to the
    shared placement and warm-started from the tenant's planner state —
    a drifted tenant re-solves ONLY its own ladder; every other tenant's
    plan, and the placement, are untouched."""
    from repro_torch.core.adaption import (BackgroundReplanner, MonitorConfig,
                                     PlanLifecycle, PlanMonitor,
                                     planner_replan_fn, provenance_for_plan)

    out: Dict[str, object] = {}
    for spec in report.plan.tenants:
        plan = report.plan.plans[spec.name]
        prov = plan.provenance or provenance_for_plan(plan)
        monitor = PlanMonitor(prov, monitor_cfg if monitor_cfg is not None
                              else MonitorConfig())
        fn = planner_replan_fn(
            profiles, hardware, spec.slo, n_ranges=spec.n_ranges,
            sim_cfg=sim_cfg, qps_margin=qps_margin, pin_placement=True,
            warm_state=report.reports[spec.name].state,
            fast_path=fast_path,
            background_qps=report.backgrounds.get(spec.name))
        out[spec.name] = PlanLifecycle(
            plan, monitor=monitor,
            replanner=BackgroundReplanner(fn, plan_latency=plan_latency))
    return out


# ---------------------------------------------------------------------------
# Shared driver helpers (simulator + server use the identical logic)
# ---------------------------------------------------------------------------

def effective_trigger(model: str, counts: Sequence[int],
                      gears: Sequence[Gear]) -> int:
    """Batch trigger for a shared replica queue: the MINIMUM of the
    current-gear triggers of the tenants with samples queued there (the
    most latency-eager waiting tenant sets the pace). ``counts[i]`` is
    tenant i's queued-sample count, ``gears[i]`` its current gear."""
    trig = None
    for i, c in enumerate(counts):
        if c > 0:
            t = gears[i].min_queue_lens.get(model, 1)
            if trig is None or t < trig:
                trig = t
    return 1 if trig is None else trig


def merge_tenant_arrivals(traces: Mapping[str, np.ndarray],
                          names: Sequence[str]
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-tenant per-second QPS traces into one global arrival
    schedule: (times, tenant index, tenant-local sample id), time-sorted
    with ties broken by tenant order (stable). Tenant-local ids are what
    execution backends see, so one tenant's replay stream never depends on
    another tenant's traffic."""
    times_l, tidx_l, lidx_l = [], [], []
    for i, n in enumerate(names):
        a = trace_to_arrivals(np.asarray(traces.get(n, ()), np.float64))
        times_l.append(a)
        tidx_l.append(np.full(len(a), i, np.int64))
        lidx_l.append(np.arange(len(a), dtype=np.int64))
    times = np.concatenate(times_l) if times_l else np.zeros(0)
    tidx = np.concatenate(tidx_l) if tidx_l else np.zeros(0, np.int64)
    lidx = np.concatenate(lidx_l) if lidx_l else np.zeros(0, np.int64)
    order = np.argsort(times, kind="stable")
    return times[order], tidx[order], lidx[order]


# ---------------------------------------------------------------------------
# Per-tenant results
# ---------------------------------------------------------------------------

@dataclass
class TenantResult:
    """One tenant's view of a multi-tenant run. ``result`` holds the
    admitted traffic's metrics (latency/accuracy/stability); shed requests
    appear only in ``offered``/``shed`` — they consumed no fleet time."""
    name: str
    result: SimResult
    offered: int          # arrivals including shed
    shed: int

    @property
    def shed_rate(self) -> float:
        return self.shed / self.offered if self.offered else 0.0

    @property
    def p95(self) -> float:
        return self.result.p95

    @property
    def accuracy(self) -> float:
        return self.result.accuracy

    def slo_attained(self, slo: SLO) -> bool:
        if self.result.completed == 0:
            return False
        if slo.kind == "latency":
            return self.result.p95 <= slo.latency_p95
        return self.result.accuracy >= slo.min_accuracy


class _TenantState:
    """Mutable per-tenant driver state for the DES loop."""
    __slots__ = ("name", "spec", "ti", "gears", "core", "pool", "cur_gear",
                 "meas_count", "shed", "switches", "plan_swaps",
                 "lifecycle", "per_model_samples")

    def __init__(self, name, spec, ti, gears, core, pool, lifecycle):
        self.name = name
        self.spec = spec
        self.ti = ti
        self.gears = gears
        self.core = core
        self.pool = pool
        self.cur_gear = 0
        self.meas_count = 0
        self.shed = 0
        self.switches: List[Tuple[float, int]] = []
        self.plan_swaps: List[Tuple[float, int, str]] = []
        self.lifecycle = lifecycle
        self.per_model_samples: Dict[str, int] = {}


# ---------------------------------------------------------------------------
# The multi-tenant discrete-event driver
# ---------------------------------------------------------------------------

def run_multi_tenant_sim(sim, mt_plan: MultiTenantPlan,
                         traces: Mapping[str, np.ndarray],
                         drain: float = 2.0, admission=None,
                         lifecycles: Optional[Mapping[str, object]] = None,
                         decision_traces: Optional[
                             Mapping[str, DecisionTrace]] = None,
                         fleet_trace: Optional[DecisionTrace] = None
                         ) -> Dict[str, TenantResult]:
    """Drive a ``ServingSimulator`` with superposed multi-tenant traffic.

    Mirrors the single-tenant DES loop (same event ordering: arrivals win
    ties, measurement ticks fire only when strictly earliest), with the
    tenant extensions: per-tenant cores/streams/gear state, shared
    tenant-tagged queues, the admission hooks, and per-tenant lifecycles.
    ``repro.serving.runtime.MultiTenantServer.run_virtual`` drives the
    identical decision sequence (tests/test_tenancy.py pins the parity).
    """
    cfg = sim.cfg
    backend = sim.backend
    replicas = sim.replicas
    names = mt_plan.names
    n_ten = len(names)

    reps = mt_plan.replicas
    if len(reps) != len(replicas) or any(
            a.model != b.model or a.device != b.device
            for a, b in zip(reps, replicas)):
        raise ValueError("simulator replicas do not match the multi-tenant "
                         "plan's shared placement")
    for n in names:
        if any(is_ensemble(g) for g in mt_plan.plans[n].gears):
            raise ValueError(f"tenant {n}: ensemble gears are not "
                             f"supported on the multi-tenant path")

    # per-tenant state: own core (per-tenant trace/monitor/hop memos), own
    # KEYED route stream, own gear ladder + selector
    arr_times, arr_tidx, arr_lidx = merge_tenant_arrivals(traces, names)
    n_arr_of = [int((arr_tidx == i).sum()) for i in range(n_ten)]
    states: List[_TenantState] = []
    for i, n in enumerate(names):
        plan = mt_plan.plans[n]
        tr = decision_traces.get(n) if decision_traces else None
        core = SchedulerCore(
            replicas, cfg,
            selector=with_hysteresis(plan_target(plan), cfg.alpha),
            trace=tr)
        lc = lifecycles.get(n) if lifecycles else None
        if lc is not None:
            lc.attach(core)
        pool = RoutePool.for_arrivals(cfg.seed, n_arr_of[i], key=n)
        states.append(_TenantState(n, mt_plan.spec(n), i,
                                   list(plan.gears), core, pool, lc))

    n_arr = len(arr_times)
    horizon = float(max((len(traces.get(n, ())) for n in names),
                        default=0)) + drain
    arrive_l = arr_times.tolist()
    complete = [math.nan] * n_arr
    correct = [False] * n_arr
    resolver = [-1] * n_arr
    shed_flag = [False] * n_arr
    gear_of: List[Optional[Gear]] = [None] * n_arr
    cur_stage = [0] * n_arr
    tenant_of = arr_tidx.tolist()
    local_of = arr_lidx.tolist()
    rt_memo: Dict[Tuple[str, int], float] = {}
    correctness_known = True

    qs: List[_ArrayQueue] = [_ArrayQueue() for _ in replicas]
    qt_counts = [[0] * n_ten for _ in replicas]
    dev_busy = np.zeros(sim.num_devices)
    dev_idle = np.ones(sim.num_devices, bool)
    per_model_batches: Dict[str, int] = {}
    core0 = states[0].core
    reps_of = core0.reps_of
    reps_on_dev = core0.reps_on_dev
    max_batch = cfg.max_batch

    import heapq
    heap: List[Tuple[float, int, str, tuple]] = []
    seq = 0

    def push_event(t, kind, payload):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    def cur_gears_list() -> List[Gear]:
        return [ts.gears[ts.cur_gear] for ts in states]

    def try_start(ridx: int, t: float):
        q = qs[ridx]
        qlen = q.n
        if not qlen:
            return
        r = replicas[ridx]
        if not dev_idle[r.device]:
            return
        trig = effective_trigger(r.model, qt_counts[ridx],
                                 cur_gears_list())
        if not core0.fire_at(
                qlen, head_of_line_wait(t, q.t[q.head], cfg.max_wait), trig):
            return
        bsz = qlen if qlen < max_batch else max_batch
        sids, stages = q.pop(bsz)
        counts = qt_counts[ridx]
        for g in sids:
            counts[tenant_of[g]] -= 1
        if fleet_trace is not None:
            fleet_trace.record_fire(ridx, sids)
        rt = rt_memo.get((r.model, bsz))
        if rt is None:
            rt = backend.batch_runtime(r.model, bsz) + cfg.dispatch_overhead
            rt_memo[(r.model, bsz)] = rt
        dev_idle[r.device] = False
        dev_busy[r.device] += rt
        per_model_batches[r.model] = per_model_batches.get(r.model, 0) + 1
        push_event(t + rt, "complete", (ridx, sids, stages))

    def enqueue(gsid: int, stage: int, model: str, t: float, gear: Gear,
                ti: int):
        ts = states[ti]
        ridx = ts.core.route(model, gear, ts.pool.next())
        qs[ridx].push(gsid, stage, t)
        qt_counts[ridx][ti] += 1
        ts.per_model_samples[model] = \
            ts.per_model_samples.get(model, 0) + 1
        try_start(ridx, t)
        if qs[ridx].n:
            push_event(t + cfg.max_wait, "timeout", (ridx,))

    def on_complete(ridx: int, sids, stages, t: float):
        nonlocal correctness_known
        r = replicas[ridx]
        ex = backend.execute(r.model, [local_of[g] for g in sids])
        certs = ex.certs
        corr = ex.correct
        if corr is None:
            correctness_known = False
            corr = [False] * len(sids)
        for k, (gsid, stage) in enumerate(zip(sids, stages)):
            if cur_stage[gsid] != stage:
                continue
            ti = tenant_of[gsid]
            g = gear_of[gsid]
            hop = states[ti].core.next_hop(stage, certs[k], g)
            if isinstance(hop, CascadeHop):
                cur_stage[gsid] = hop.next_stage
                enqueue(gsid, hop.next_stage, hop.next_model, t, g, ti)
            else:
                complete[gsid] = t
                correct[gsid] = corr[k]
                resolver[gsid] = stage
                cur_stage[gsid] = 1 << 30
        dev_idle[r.device] = True
        for rj in reps_on_dev.get(r.device, []):
            try_start(rj, t)
            if not dev_idle[r.device]:
                break

    meas_end = cfg.measure_interval
    arr_ptr = 0
    inf = math.inf
    while True:
        t_arr = arrive_l[arr_ptr] if arr_ptr < n_arr else inf
        t_evt = heap[0][0] if heap else inf
        t = min(t_arr, t_evt, meas_end)
        if t > horizon or t == inf:
            break
        if t == meas_end and t < min(t_arr, t_evt):
            # one producer tick, per tenant in spec order: measure, step
            # the tenant's lifecycle (swap application mirrors the
            # single-tenant loop step for step), then admission, then
            # gear selection
            measured: Dict[str, float] = {}
            for ts in states:
                m = ts.meas_count / cfg.measure_interval
                measured[ts.name] = m
                ts.meas_count = 0
                if ts.lifecycle is not None:
                    swap = ts.lifecycle.step(t, m, ts.cur_gear)
                    if swap is not None:
                        ts.gears = list(swap.plan.gears)
                        if swap.selector is not None:
                            ts.core.selector = swap.selector
                        ts.plan_swaps.append((t, swap.epoch, swap.reason))
                        if swap.new_gear != ts.cur_gear:
                            ts.switches.append((t, swap.new_gear))
                            ts.cur_gear = swap.new_gear
            if admission is not None:
                admission.on_tick(t, measured,
                                  {ts.name: ts.cur_gear for ts in states})
            for ts in states:
                d = admission.decision(ts.name) \
                    if admission is not None else None
                if d is not None and d.force_cheapest:
                    tgt = min(admission.cheapest[ts.name],
                              len(ts.gears) - 1)
                    if tgt != ts.cur_gear:
                        ts.switches.append((t, tgt))
                        if ts.core.trace is not None:
                            ts.core.trace.gear_switches.append(
                                (ts.cur_gear, tgt))
                        ts.cur_gear = tgt
                    continue
                m0 = ts.gears[ts.cur_gear].cascade.models[0]
                q0 = 0
                for ridx in reps_of.get(m0, []):
                    q0 += qt_counts[ridx][ts.ti]
                new = ts.core.select_gear(t, measured[ts.name],
                                          ts.cur_gear, q0, len(ts.gears))
                if new != ts.cur_gear:
                    ts.switches.append((t, new))
                    ts.cur_gear = new
            meas_end += cfg.measure_interval
            continue
        if t_arr <= t_evt:
            gsid = arr_ptr
            arr_ptr += 1
            ti = tenant_of[gsid]
            ts = states[ti]
            ts.meas_count += 1
            if admission is not None and not admission.admit(ts.name):
                shed_flag[gsid] = True
                ts.shed += 1
                cur_stage[gsid] = 1 << 30
            else:
                g = ts.gears[ts.cur_gear]
                gear_of[gsid] = g
                enqueue(gsid, 0, g.cascade.models[0], t_arr, g, ti)
        else:
            _, _, kind, payload = heapq.heappop(heap)
            if kind == "complete":
                on_complete(payload[0], payload[1], payload[2], t_evt)
            else:  # timeout
                try_start(payload[0], t_evt)

    # ---- per-tenant result assembly ---------------------------------------
    complete_a = np.asarray(complete, np.float64)
    correct_a = np.asarray(correct, bool)
    resolver_a = np.asarray(resolver, np.int32)
    shed_a = np.asarray(shed_flag, bool)
    out: Dict[str, TenantResult] = {}
    for ts in states:
        tmask = arr_tidx == ts.ti
        adm = tmask & ~shed_a
        done = adm & ~np.isnan(complete_a)
        n_adm = int(adm.sum())
        res = SimResult(
            latencies=(complete_a[done] - arr_times[done]),
            correct=correct_a[done],
            arrive_times=arr_times[done],
            complete_times=complete_a[done],
            resolver=resolver_a[done],
            completed=int(done.sum()),
            offered=n_adm,
            backlog_end=n_adm - int(done.sum()),
            device_busy=dev_busy,
            horizon=horizon,
            gear_switches=ts.switches,
            per_model_batches=dict(per_model_batches),   # fleet-level:
            # batches mix tenants by design; samples below are tenant-level
            per_model_samples=dict(ts.per_model_samples),
            plan_swaps=ts.plan_swaps,
            correctness_known=correctness_known)
        out[ts.name] = TenantResult(name=ts.name, result=res,
                                    offered=int(tmask.sum()), shed=ts.shed)
    return out
