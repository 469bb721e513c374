"""Verbatim copy of ``repro/core/admission.py``,
imports rewritten to ``repro_torch``.

Admission control: graceful serving beyond the planned QPS range.

A gear plan covers offered load in ``[0, qps_max]`` — past that the §5
producer can only clamp to the top gear and let queues grow without bound.
With several tenants sharing one placement (core/tenancy.py), uncontrolled
overload is worse: one tenant's flash crowd starves every other tenant's
latency SLO. The ``AdmissionController`` closes that gap with three
composable policies, evaluated once per producer measurement tick (the
same tick that already measures QPS for gear switching, so detection costs
nothing new):

* **downgrade-to-cheapest-gear** — a tenant whose measured QPS leaves its
  planned range is forced onto its highest-throughput gear: serve everyone
  as cheaply as possible before dropping anyone (SuperServe's principled
  degradation, applied to a cascade ladder).
* **weighted-fair sharing** — when the fleet itself is oversubscribed, each
  tenant's admitted rate is clamped to a max-min weighted-fair share of
  fleet capacity (utilization units, so tenants with different cascades
  compare on one scale). Tenants needing less than their share keep it all;
  the surplus water-fills the rest by weight. Zero-weight tenants are
  best-effort: they receive capacity only after every weighted tenant is
  satisfied.
* **deadline-aware shedding** — requests that cannot meet a latency SLO are
  dropped at admission, not after burning fleet time: everything beyond the
  fair-share rate (it would only age in queue past the deadline), and the
  whole tenant while even its cheapest gear's best-case service time
  exceeds the SLO.

All decisions are counter-based and deterministic — fed only by the
producer's measurement ticks and arrival order, never by wall clock or
randomness — so the simulator and the real server reach identical
admit/shed sequences (the same property the drift monitor relies on).
Per-request shedding uses a per-tenant credit accumulator: each arrival
adds ``admit_fraction`` credit and is admitted when a whole credit is
available, which spreads sheds evenly through the tick without drawing
randomness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

from repro_torch.core.gears import Gear, GearPlan
from repro_torch.core.lp import Replica

__all__ = ["AdmissionConfig", "AdmissionDecision", "AdmissionController",
           "fleet_capacities", "gear_capacity", "cheapest_gear_index",
           "weighted_fair_shares", "plan_capacity_qps"]


# ---------------------------------------------------------------------------
# Capacity model (shared scale for tenants running different cascades)
# ---------------------------------------------------------------------------

def fleet_capacities(replicas: Sequence[Replica]) -> Dict[str, float]:
    """Per-model fleet capacity in samples/s: each replica contributes the
    reciprocal of its per-sample runtime (the LP's optimistic Eq.-3 rate at
    the efficient batch size — consistent with how the planner provisions).
    """
    caps: Dict[str, float] = {}
    for r in replicas:
        caps[r.model] = caps.get(r.model, 0.0) + \
            1.0 / max(r.runtime_per_sample, 1e-12)
    return caps


def model_work(replicas: Sequence[Replica]) -> Dict[str, float]:
    """Per-sample device-seconds per model (fastest replica's efficient-
    batch rate) — the work coefficients of the shared-device-time capacity
    bound."""
    w: Dict[str, float] = {}
    for r in replicas:
        cur = w.get(r.model)
        if cur is None or r.runtime_per_sample < cur:
            w[r.model] = r.runtime_per_sample
    return w


def gear_capacity(demand: Mapping[str, float],
                  caps: Mapping[str, float],
                  work: Optional[Mapping[str, float]] = None,
                  num_devices: Optional[int] = None) -> float:
    """Max sustainable tenant QPS for one gear: the tighter of

    * the per-model bottleneck — the rate at which the gear's demand
      coefficients (fraction of tenant traffic reaching each cascade
      stage) first saturate one model's replica capacity, and
    * (when ``work``/``num_devices`` are given) the shared-device-time
      bound — replicas of different models COLLOCATE, so one tenant
      sample consumes ``sum(coef_m * work_m)`` device-seconds out of
      ``num_devices`` available per second. Ignoring this would price
      each model as if it had the fleet to itself.
    """
    cap = float("inf")
    for m, coef in demand.items():
        if coef <= 0:
            continue
        cap = min(cap, caps.get(m, 0.0) / coef)
    if work is not None and num_devices:
        tot = sum(coef * work.get(m, 0.0)
                  for m, coef in demand.items() if coef > 0)
        if tot > 0:
            cap = min(cap, num_devices / tot)
    return cap


def cheapest_gear_index(plan: GearPlan,
                        gear_demand: Optional[Sequence[Mapping[str, float]]]
                        = None,
                        caps: Optional[Mapping[str, float]] = None,
                        work: Optional[Mapping[str, float]] = None,
                        num_devices: Optional[int] = None) -> int:
    """Index of the plan's highest-throughput ("cheapest") gear — where the
    downgrade policy parks an over-range tenant. Ties break toward the
    higher index (the gear already tuned for the top of the range)."""
    caps = caps if caps is not None else fleet_capacities(plan.replicas)
    best, best_cap = 0, -1.0
    for i, g in enumerate(plan.gears):
        demand = gear_demand[i] if gear_demand is not None \
            else {g.cascade.models[0]: 1.0}
        c = gear_capacity(demand, caps, work, num_devices)
        if c >= best_cap:
            best, best_cap = i, c
    return best


def plan_capacity_qps(plan: GearPlan,
                      profiles: Optional[Mapping[str, object]] = None,
                      gear_index: Optional[int] = None) -> float:
    """Sustainable offered QPS of ``plan`` — the FleetController's iso-SLO
    shrink guard asks this before releasing hardware ("can the shrunken
    fleet still absorb the recent peak?").

    With ``profiles`` the per-stage demand comes from the cascade's reach
    fractions (``evaluate_cascade``): stage *i* sees ``fractions[i]`` samples
    per admitted request. Without profiles only the entry model is charged
    (optimistic). ``gear_index=None`` rates the plan at its cheapest
    (highest-throughput) gear — the configuration the producer clamps to
    under overload, hence the plan's true ceiling.
    """
    if not plan.gears:
        return 0.0
    caps = fleet_capacities(plan.replicas)
    work = model_work(plan.replicas)

    def demand_for(g: Gear) -> Dict[str, float]:
        models = list(g.cascade.models)
        if profiles is not None:
            from repro_torch.core.cascade import evaluate_cascade
            ev = evaluate_cascade(g.cascade, profiles)
            return {m: f for m, f in zip(models, ev.fractions)}
        return {models[0]: 1.0}

    if gear_index is not None:
        g = plan.gears[gear_index]
        return gear_capacity(demand_for(g), caps, work, plan.num_devices)
    return max(gear_capacity(demand_for(g), caps, work, plan.num_devices)
               for g in plan.gears)


# ---------------------------------------------------------------------------
# Weighted max-min fair allocation (utilization units)
# ---------------------------------------------------------------------------

def weighted_fair_shares(needs: Mapping[str, float],
                         weights: Mapping[str, float],
                         capacity: float = 1.0) -> Dict[str, float]:
    """Max-min weighted-fair water-fill: allocate ``capacity`` across
    tenants with demand ``needs``. A tenant never receives more than its
    need; unused share water-fills the still-unsatisfied tenants by
    weight. Zero-weight tenants are best-effort (allocated last, equally).
    When total need >= capacity the allocations sum to exactly
    ``capacity`` — overload never over- or under-commits the fleet."""
    alloc = {k: 0.0 for k in needs}
    remaining = float(capacity)
    active = [k for k in needs
              if weights.get(k, 0.0) > 0.0 and needs[k] > 0.0]
    while active and remaining > 1e-12:
        wsum = sum(weights[k] for k in active)
        share = {k: remaining * weights[k] / wsum for k in active}
        done = [k for k in active
                if needs[k] - alloc[k] <= share[k] + 1e-12]
        if not done:
            for k in active:
                alloc[k] += share[k]
            remaining = 0.0
            break
        for k in done:
            remaining -= needs[k] - alloc[k]
            alloc[k] = needs[k]
        active = [k for k in active if k not in done]
    # best-effort pool: zero-weight tenants split whatever is left, equally
    zeros = [k for k in needs
             if weights.get(k, 0.0) <= 0.0 and needs[k] > alloc[k]]
    while zeros and remaining > 1e-12:
        share = remaining / len(zeros)
        done = [k for k in zeros if needs[k] - alloc[k] <= share + 1e-12]
        if not done:
            for k in zeros:
                alloc[k] += share
            remaining = 0.0
            break
        for k in done:
            remaining -= needs[k] - alloc[k]
            alloc[k] = needs[k]
        zeros = [k for k in zeros if k not in done]
    return alloc


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdmissionConfig:
    downgrade: bool = True        # force the cheapest gear while over range
    weighted_fair: bool = True    # fair-share clamp under fleet overload
    deadline_shed: bool = True    # drop work that cannot meet a latency SLO
    # a tenant engages when measured QPS exceeds headroom * its qps_max
    # (strictly: sitting exactly ON the boundary is still in-plan)
    headroom: float = 1.0
    # consecutive in-range ticks before the downgrade is released
    # (flap damping; mirrors the spirit of the §5 α-hysteresis)
    disengage_ticks: int = 3
    # fraction of nominal fleet capacity the fair-share clamp hands out.
    # The capacity model prices replicas at the LP's optimistic
    # efficient-batch rate; a real fleet saturates earlier (batch
    # formation, dispatch, queueing) — derate to keep admitted overload
    # actually servable within deadlines
    utilization_cap: float = 1.0


@dataclass(frozen=True)
class AdmissionDecision:
    """Per-tenant verdict for one measurement tick."""
    tenant: str
    engaged: bool                 # tenant is beyond its planned range
    force_cheapest: bool          # downgrade policy active
    admit_fraction: float         # fraction of arrivals to admit this tick
    shed_all: bool                # latency SLO unattainable at any gear
    reason: str = ""


class AdmissionController:
    """Per-tick admission decisions for tenants sharing one placement.

    Built from anything shaped like a ``repro.core.tenancy
    .MultiTenantPlan`` (``tenants`` specs, per-tenant ``plans``, shared
    ``replicas``, per-gear ``gear_demand`` coefficients). Drivers call
    ``on_tick`` at every producer measurement tick, then ``admit(tenant)``
    once per arrival; both executors make the identical sequence of calls,
    so admission decisions are parity-comparable like every other
    scheduling decision.
    """

    def __init__(self, mt_plan, cfg: AdmissionConfig = AdmissionConfig(),
                 registry=None):
        self.cfg = cfg
        self.registry = registry
        self.specs = {t.name: t for t in mt_plan.tenants}
        self.plans: Dict[str, GearPlan] = dict(mt_plan.plans)
        self.caps = fleet_capacities(mt_plan.replicas)
        self.gear_demand: Dict[str, List[Dict[str, float]]] = {
            name: list(mt_plan.gear_demand.get(name) or
                       [{p.gears[i].cascade.models[0]: 1.0}
                        for i in range(p.n_ranges)])
            for name, p in self.plans.items()}
        self.work = model_work(mt_plan.replicas)
        self.num_devices = mt_plan.num_devices
        # per-tenant: cheapest gear, its capacity, per-gear capacities
        self.cheapest: Dict[str, int] = {}
        self._gear_caps: Dict[str, List[float]] = {}
        self._infeasible: Dict[str, bool] = {}
        for name, plan in self.plans.items():
            demand = self.gear_demand[name]
            self._gear_caps[name] = [
                gear_capacity(demand[i], self.caps, self.work,
                              self.num_devices)
                for i in range(len(plan.gears))]
            self.cheapest[name] = cheapest_gear_index(
                plan, demand, self.caps, self.work, self.num_devices)
            self._infeasible[name] = self._cheapest_infeasible(name)
        # mutable decision state
        self._decisions: Dict[str, AdmissionDecision] = {}
        self._credit: Dict[str, float] = {n: 0.0 for n in self.specs}
        self._in_range_ticks: Dict[str, int] = {n: 0 for n in self.specs}
        self._engaged: Dict[str, bool] = {n: False for n in self.specs}
        self.shed_counts: Dict[str, int] = {n: 0 for n in self.specs}
        self.admitted_counts: Dict[str, int] = {n: 0 for n in self.specs}
        # optional MetricsRegistry mirror of the count dicts (pure
        # observer: decisions never read these counters)
        self._ctr_admit: Dict[str, object] = {}
        self._ctr_shed: Dict[str, object] = {}
        if registry is not None:
            for n in self.specs:
                self._ctr_admit[n] = registry.counter(
                    "admitted_requests", tenant=n)
                self._ctr_shed[n] = registry.counter(
                    "shed_requests", tenant=n)

    # ------------------------------------------------------------ helpers
    def _cheapest_infeasible(self, name: str) -> bool:
        """Even the cheapest gear's best-case service time blows the
        latency SLO: a single sample on the fastest replica of the gear's
        first model (the most optimistic latency any admitted request can
        see) already exceeds the deadline."""
        spec = self.specs[name]
        if spec.slo.kind != "latency":
            return False
        gear: Gear = self.plans[name].gears[self.cheapest[name]]
        first = gear.cascade.models[0]
        rts = [r.runtime_per_sample
               for r in self.plans[name].replicas if r.model == first]
        if not rts:
            return True
        return min(rts) > spec.slo.latency_p95

    def decision(self, name: str) -> Optional[AdmissionDecision]:
        return self._decisions.get(name)

    # ------------------------------------------------------------ the tick
    def on_tick(self, t: float, measured: Mapping[str, float],
                cur_gears: Optional[Mapping[str, int]] = None
                ) -> Dict[str, AdmissionDecision]:
        """One producer measurement tick: recompute every tenant's
        admission decision from this tick's measured QPS (and, for the
        capacity scale of not-yet-downgraded tenants, their current gear).
        """
        cfg = self.cfg
        # 1) engagement: beyond planned range, with release damping
        for name, spec in self.specs.items():
            q = float(measured.get(name, 0.0))
            if q > cfg.headroom * spec.qps_max:
                self._engaged[name] = True
                self._in_range_ticks[name] = 0
            elif self._engaged[name]:
                self._in_range_ticks[name] += 1
                if self._in_range_ticks[name] >= cfg.disengage_ticks:
                    self._engaged[name] = False
        # 2) utilization needs on the shared capacity scale
        needs: Dict[str, float] = {}
        rates: Dict[str, float] = {}
        for name in self.specs:
            q = float(measured.get(name, 0.0))
            if self._engaged[name] and cfg.downgrade:
                cap = self._gear_caps[name][self.cheapest[name]]
            else:
                gi = (cur_gears or {}).get(name,
                                           self.cheapest[name])
                gi = min(max(int(gi), 0), len(self._gear_caps[name]) - 1)
                cap = self._gear_caps[name][gi]
            rates[name] = cap
            needs[name] = q / cap if cap > 0 else float("inf")
        # 3) weighted-fair clamp. Gated on some tenant actually leaving
        #    its planned range: the joint placement is provisioned for the
        #    simultaneous in-range worst case, so all-in-range traffic is
        #    servable by construction and must never be shed — admission
        #    ENGAGES only past the planned regime. In-range tenants'
        #    needs are RESERVED in full (regardless of weight — a
        #    low-weight tenant inside its contract must not lose capacity
        #    to a high-weight neighbor's flash crowd); only the residual
        #    is fair-shared among the engaged tenants.
        total_need = sum(min(n, 1e9) for n in needs.values())
        if cfg.weighted_fair and any(self._engaged.values()) and \
                total_need > cfg.utilization_cap + 1e-9:
            over = [n for n in self.specs if self._engaged[n]]
            inrange = [n for n in self.specs if not self._engaged[n]]
            reserved = sum(min(needs[n], 1e9) for n in inrange)
            residual = max(cfg.utilization_cap - reserved, 0.0)
            alloc = {n: needs[n] for n in inrange}
            alloc.update(weighted_fair_shares(
                {n: needs[n] for n in over},
                {n: self.specs[n].weight for n in over},
                capacity=residual))
        else:
            alloc = dict(needs)
        # 4) per-tenant decisions
        out: Dict[str, AdmissionDecision] = {}
        for name, spec in self.specs.items():
            q = float(measured.get(name, 0.0))
            engaged = self._engaged[name]
            shed_all = bool(cfg.deadline_shed and self._infeasible[name])
            frac = 1.0
            reason = ""
            if shed_all:
                frac = 0.0
                reason = "latency SLO below cheapest gear's service time"
            elif q > 0:
                allowed = alloc.get(name, needs[name]) * rates[name]
                if cfg.deadline_shed and engaged:
                    # work past the sustainable rate only ages in queue
                    # until it misses the deadline — drop it at the door
                    allowed = min(allowed,
                                  rates[name] * cfg.utilization_cap)
                if cfg.weighted_fair or cfg.deadline_shed:
                    frac = min(1.0, allowed / q)
                if frac < 1.0:
                    reason = (f"fair share {allowed:.0f}/{q:.0f} qps"
                              if cfg.weighted_fair else
                              f"deadline guard {allowed:.0f}/{q:.0f} qps")
            out[name] = AdmissionDecision(
                tenant=name, engaged=engaged,
                force_cheapest=bool(engaged and cfg.downgrade
                                    and not shed_all),
                admit_fraction=frac, shed_all=shed_all, reason=reason)
        self._decisions = out
        return out

    # ------------------------------------------------------- per arrival
    def admit(self, name: str) -> bool:
        """One arrival of ``name``: admit or shed, per the current tick's
        decision (credit accumulator — deterministic, evenly spread)."""
        d = self._decisions.get(name)
        if d is None or (d.admit_fraction >= 1.0 and not d.shed_all):
            self.admitted_counts[name] = self.admitted_counts.get(name,
                                                                  0) + 1
            c = self._ctr_admit.get(name)
            if c is not None:
                c.inc()
            return True
        if d.shed_all:
            self.shed_counts[name] = self.shed_counts.get(name, 0) + 1
            c = self._ctr_shed.get(name)
            if c is not None:
                c.inc()
            return False
        self._credit[name] = self._credit.get(name, 0.0) + d.admit_fraction
        if self._credit[name] >= 1.0 - 1e-9:
            self._credit[name] -= 1.0
            self.admitted_counts[name] = self.admitted_counts.get(name,
                                                                  0) + 1
            c = self._ctr_admit.get(name)
            if c is not None:
                c.inc()
            return True
        self.shed_counts[name] = self.shed_counts.get(name, 0) + 1
        c = self._ctr_shed.get(name)
        if c is not None:
            c.inc()
        return False
