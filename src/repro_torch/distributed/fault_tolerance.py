"""Verbatim copy of ``repro/distributed/fault_tolerance.py``,
imports rewritten to ``repro_torch``.

Fault tolerance and elasticity for the serving plane.

The gear plan's fixed placement makes failure handling cheap and local:

* ``rebalance_on_failure`` — an inference-server slice dies: drop its
  replicas and re-solve ONLY the SP3 load-balancing LP per QPS range (Eq.
  1-3) over the survivors. Gears whose cascade lost its last replica of some
  model are remapped to the nearest feasible gear. Milliseconds, no model
  loading — a new slice later just re-enters through the same path.

* ``elastic_replan`` — capacity changed (grow/shrink): keep SP1's cascade
  set and SP2's assignment, re-run SP3 (placement) + SP4 (batching) to
  convergence on the new hardware. Much cheaper than a cold Algorithm-1 run
  (benchmarked in bench_fault_tolerance).

* ``HedgePolicy`` — straggler mitigation: a batch is re-issued on the
  fastest sibling replica if its primary exceeds ``hedge_multiplier`` x the
  profiled runtime; first completion wins. Used by the simulator
  (device slow-down events) and the online runtime.

* ``PreemptionCoordinator`` — the spot-preemption drain window
  (DESIGN.md §15): plugged in as the drivers' ``on_failure`` callback, it
  pre-computes the survivor plan at the *drain notice* and memoizes it by
  the exact down-set, so the gear swap at revoke time is a dictionary
  lookup, not an LP solve.

* ``FleetController`` + ``run_elastic_fleet`` — autoscaling as a planner
  action: ``PlanMonitor`` scale-out/scale-in triggers become fleet-size
  changes applied between serving windows via (memoized) ``elastic_replan``
  from the offline planner state, with cool-down, an iso-SLO shrink guard
  (``plan_capacity_qps``), capacity grant/revoke mandates, and per-device-
  hour cost metering.

Training-plane fault tolerance is checkpoint/restart
(``repro.checkpoint``) + the launcher's resume path (train.py).
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.gears import Gear, GearPlan, fractions_from_lp
from repro_torch.core.lp import Replica, min_utilization_lp
from repro_torch.core.plan_state import HardwareSpec, PlannerState
from repro_torch.core.profiles import ProfileSet


@dataclass(frozen=True)
class HedgePolicy:
    enabled: bool = True
    hedge_multiplier: float = 3.0   # re-issue after this x profiled runtime
    max_hedges_per_batch: int = 1


def rebalance_on_failure(plan: GearPlan, profiles: ProfileSet,
                         failed_devices: Set[int],
                         qps_prior: Optional[np.ndarray] = None) -> GearPlan:
    """Return a new plan routing only to surviving replicas.

    Replica indices are STABLE (the online system keys queues by replica
    index): the replica list is kept as-is and only the per-gear load
    fractions are re-solved over the survivors.
    """
    survivors: List[Replica] = []
    surv_orig_idx: List[int] = []
    for i, r in enumerate(plan.replicas):
        if r.device not in failed_devices:
            surv_orig_idx.append(i)
            survivors.append(r)
    alive_models = {r.model for r in survivors}

    # gears that remain runnable, in accuracy order, for remapping
    runnable: List[Tuple[int, Gear]] = []
    for gi, g in enumerate(plan.gears):
        if all(m in alive_models for m in g.cascade.models):
            runnable.append((gi, g))
    if not runnable:
        raise RuntimeError("no gear survives the failure; full replan needed")

    new_gears: List[Gear] = []
    width = plan.range_width
    for gi, g in enumerate(plan.gears):
        if all(m in alive_models for m in g.cascade.models):
            src = g
        else:
            # nearest runnable gear (prefer higher-throughput = higher index)
            src = min(runnable, key=lambda it: abs(it[0] - gi)
                      + (0.25 if it[0] < gi else 0.0))[1]
        qps = width * (gi + 1)
        from repro_torch.core.cascade import evaluate_cascade
        ev = evaluate_cascade(src.cascade, profiles)
        qpm = {m: f * qps for m, f in zip(src.cascade.models, ev.fractions)}
        u, q = min_utilization_lp(survivors, qpm, plan.num_devices)
        if q is None:
            # over capacity after failure: keep routing, uniform over alive
            lf_local = {
                m: {i: 1.0 / len([r for r in survivors if r.model == m])
                    for i, r in enumerate(survivors) if r.model == m}
                for m in src.cascade.models}
        else:
            lf_local = fractions_from_lp(q, survivors, src.cascade.models)
        # remap survivor-local indices -> original replica indices
        lf = {m: {surv_orig_idx[i]: f for i, f in sub.items()}
              for m, sub in lf_local.items()}
        new_gears.append(Gear(
            cascade=src.cascade,
            min_queue_lens=dict(src.min_queue_lens),
            load_fractions=lf,
            expected_accuracy=src.expected_accuracy,
            expected_p95=src.expected_p95))
    return GearPlan(qps_max=plan.qps_max, gears=new_gears,
                    replicas=list(plan.replicas),
                    num_devices=plan.num_devices, slo=plan.slo)


def elastic_replan(state: PlannerState, new_num_devices: int,
                   new_qps_max: Optional[float] = None) -> PlannerState:
    """Re-run SP3+SP4 only, on changed capacity (SP1/SP2 outputs kept).

    ``new_qps_max`` rescales the planned QPS range along with the fleet: a
    shrunken fleet cannot serve the full original range at iso-SLO (the
    top ranges are simply infeasible on fewer devices), so the elastic
    controller plans each fleet size for the range it can actually carry
    and relies on scale-out to re-extend the ceiling before load reaches
    it. ``None`` keeps the original range (the grow path)."""
    from repro_torch.core.plan_state import OK
    from repro_torch.core.submodules.batching import tune_batch_sizes
    from repro_torch.core.submodules.hardware_mapping import place_models
    from repro_torch.core.submodules.workload_adaption import assign_cascades

    state = copy.deepcopy(state)
    state.hardware = HardwareSpec(
        num_devices=new_num_devices,
        mem_per_device=state.hardware.mem_per_device,
        chips_per_device=state.hardware.chips_per_device)
    if new_qps_max is not None:
        if new_qps_max <= 0:
            raise ValueError(f"new_qps_max must be > 0, got {new_qps_max}")
        state.qps_max = float(new_qps_max)
    state.min_replicas = {}
    error = OK
    for _ in range(32):
        error, state = place_models(error, state)
        if not error.is_ok:
            # shrink may demand downgrades: let SP2 resolve, then retry
            error, state = assign_cascades(error, state)
            if not error.is_ok:
                raise RuntimeError(f"elastic replan failed: {error.detail}")
            continue
        error, state = tune_batch_sizes(error, state)
        if error.is_ok:
            return state
    raise RuntimeError("elastic replan did not converge")


# ---------------------------------------------------------------------------
# Spot preemption: drain-window survivor-plan precompute
# ---------------------------------------------------------------------------

class PreemptionCoordinator:
    """Driver-side half of the preemption drain window.

    Plugged in as ``on_failure`` (simulator / VecSim call it at the
    ``drain`` notice and again at the ``revoke``/``fail``), it keeps the cumulative
    down-set and returns the survivor plan's gears for the driver to route
    on. Plans are memoized by the frozen down-set: the LP re-solve runs
    ONCE at the drain notice, and the revoke — plus every later window
    replaying carried-over failures — hits the memo (O(1) swap, no solve
    on the revoke path). A down-set no gear survives returns ``None``
    (keep routing; work on dead devices expires through timeouts).
    """

    def __init__(self, plan: GearPlan, profiles: ProfileSet,
                 qps_prior: Optional[np.ndarray] = None):
        self.plan = plan
        self.profiles = profiles
        self.qps_prior = qps_prior
        self.down: Set[int] = set()
        self._memo: Dict[frozenset, Optional[GearPlan]] = {}
        self.solves = 0
        self.hits = 0
        self.infeasible = 0

    def reset(self, plan: GearPlan, down: Optional[Set[int]] = None) -> None:
        """Rebase on a new active plan (fleet change): memo is invalid."""
        self.plan = plan
        self.down = set(down or ())
        self._memo = {}

    def survivor_plan(self, down: Set[int]) -> Optional[GearPlan]:
        key = frozenset(down)
        if not key:
            return self.plan
        if key in self._memo:
            self.hits += 1
            return self._memo[key]
        self.solves += 1
        try:
            plan = rebalance_on_failure(self.plan, self.profiles, set(key),
                                        qps_prior=self.qps_prior)
        except RuntimeError:
            self.infeasible += 1
            plan = None
        self._memo[key] = plan
        return plan

    def on_failure(self, t: float, dev: int) -> Optional[List[Gear]]:
        """Drivers' failure callback: called at drain notice AND at fail."""
        self.down.add(dev)
        plan = self.survivor_plan(self.down)
        return None if plan is None else plan.gears

    def on_recover(self, dev: int) -> Optional[List[Gear]]:
        """Re-entry: drop the device from the down-set and hand back the
        (memoized) plan for the smaller down-set — an empty down-set
        returns the ORIGINAL gears bit-identically (no re-solve)."""
        self.down.discard(dev)
        plan = self.survivor_plan(self.down)
        return None if plan is None else plan.gears


# ---------------------------------------------------------------------------
# Autoscaling as a planner action
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetConfig:
    """Fleet-size policy knobs for the ``FleetController``."""
    min_devices: int = 1
    max_devices: int = 8
    grow_step: int = 1
    shrink_step: int = 1
    # quiet period between fleet ACTIONS (monitor triggers have their own
    # cooldown; this one rate-limits the hardware churn itself)
    cooldown: float = 120.0
    # iso-SLO shrink guard: a scale-in is vetoed unless the candidate
    # smaller plan still sustains guard x the recent peak QPS
    shrink_guard: float = 1.15
    # cost model for the $/million-requests accounting
    device_hour_price: float = 1.0


@dataclass(frozen=True)
class FleetAction:
    """One applied (or vetoed) fleet-size decision, for the audit trail."""
    t: float
    reason: str          # scale-out | scale-in | grant | revoke
    old_n: int
    new_n: int
    applied: bool
    detail: str = ""


class FleetController:
    """Turns monitor scale triggers into fleet-size changes.

    ``request`` (called by ``PlanLifecycle.step`` for scale-out/scale-in
    triggers, or directly by a windowed runner) only RECORDS the desire —
    fleet changes move replicas, so they can never hot-swap mid-window.
    ``act`` at a window boundary applies the latest desire under cool-down
    + hysteresis: scale-in must additionally pass the iso-SLO shrink guard
    (the candidate plan's ``plan_capacity_qps`` vs the recent peak).
    Target plans come from ``elastic_replan`` on the OFFLINE planner state
    and are memoized per fleet size — grow/shrink/grow returns to the
    original plan bit-identically, and repeated actions cost nothing.

    The controller also meters device-seconds at the current fleet size
    (``meter``), which ``run_elastic_fleet`` converts to $/million-requests.
    """

    def __init__(self, base_state: PlannerState, cfg: FleetConfig,
                 base_plan: Optional[GearPlan] = None,
                 start_devices: Optional[int] = None):
        from repro_torch.core.planner import build_plan
        if not (cfg.min_devices <= base_state.hardware.num_devices
                <= cfg.max_devices):
            raise ValueError(
                f"base fleet {base_state.hardware.num_devices} outside "
                f"[{cfg.min_devices}, {cfg.max_devices}]")
        self.cfg = cfg
        self.base_state = base_state
        self.profiles = base_state.profiles
        self.n_devices = base_state.hardware.num_devices
        self.max_devices = cfg.max_devices
        self._plans: Dict[int, GearPlan] = {}
        if base_plan is not None:
            self._plans[self.n_devices] = base_plan
        else:
            self._plans[self.n_devices] = build_plan(base_state)
        self.pending = None                  # latest unapplied ReplanTrigger
        self.last_action_t = -math.inf
        self.actions: List[FleetAction] = []
        self.replan_walls: List[float] = []
        # cost meter: device-seconds integrated at the live fleet size
        self._meter_t = 0.0
        self.device_seconds = 0.0
        if start_devices is not None:
            # start below (or above) the planning-time fleet — e.g. mean
            # provisioning, letting scale-out climb toward the peak
            if not (cfg.min_devices <= start_devices <= cfg.max_devices):
                raise ValueError(
                    f"start fleet {start_devices} outside "
                    f"[{cfg.min_devices}, {cfg.max_devices}]")
            self.plan_for(start_devices)
            self.n_devices = start_devices

    # ------------------------------------------------------------- requests
    def request(self, trigger, t: float) -> None:
        """Record a scale desire (latest wins; applied at ``act``)."""
        self.pending = trigger

    @property
    def plan(self) -> GearPlan:
        return self._plans[self.n_devices]

    def plan_for(self, n: int) -> GearPlan:
        """(Memoized) gear plan for a fleet of ``n`` devices — SP3+SP4 only
        re-run from the offline state, so the same ``n`` always yields the
        same plan bit for bit. The planned QPS range scales with the fleet
        (capacity is ~linear in devices): a smaller fleet is planned for
        the smaller range it can actually serve at iso-SLO, and the
        scale-out trigger re-extends the ceiling before load reaches it."""
        import time as _time
        from repro_torch.core.planner import build_plan
        if n not in self._plans:
            base_n = self.base_state.hardware.num_devices
            qps_max = self.base_state.qps_max * n / base_n
            t0 = _time.time()
            self._plans[n] = build_plan(
                elastic_replan(self.base_state, n, new_qps_max=qps_max))
            self.replan_walls.append(_time.time() - t0)
        return self._plans[n]

    # ------------------------------------------------------------- metering
    def meter(self, t: float) -> None:
        """Advance the device-second meter to ``t`` at the current size."""
        if t > self._meter_t:
            self.device_seconds += (t - self._meter_t) * self.n_devices
            self._meter_t = t

    @property
    def device_hours(self) -> float:
        return self.device_seconds / 3600.0

    @property
    def cost(self) -> float:
        return self.device_hours * self.cfg.device_hour_price

    # -------------------------------------------------------------- actions
    def _apply(self, t: float, reason: str, target: int, detail: str = ""
               ) -> Optional[GearPlan]:
        plan = self.plan_for(target)
        self.meter(t)
        self.actions.append(FleetAction(t, reason, self.n_devices, target,
                                        applied=True, detail=detail))
        self.n_devices = target
        self.last_action_t = t
        return plan

    def _veto(self, t: float, reason: str, target: int, detail: str) -> None:
        self.actions.append(FleetAction(t, reason, self.n_devices, target,
                                        applied=False, detail=detail))

    def apply_fleet_event(self, t: float, kind: str, devices: int
                          ) -> Optional[GearPlan]:
        """Capacity grant/revoke mandates (scenario fleet events). A grant
        raises the allowed maximum; a revoke lowers it and — unlike a
        scale-in trigger — FORCES a shrink past cool-down and guard when
        the live fleet exceeds the new ceiling (the capacity is simply
        gone)."""
        if kind == "grant":
            self.max_devices += int(devices)
            self._veto(t, "grant", self.n_devices,
                       f"max_devices -> {self.max_devices}")
            return None
        if kind != "revoke":
            raise ValueError(f"unknown fleet event kind {kind!r}")
        self.max_devices = max(self.cfg.min_devices,
                               self.max_devices - int(devices))
        if self.n_devices <= self.max_devices:
            self._veto(t, "revoke", self.n_devices,
                       f"max_devices -> {self.max_devices}")
            return None
        return self._apply(t, "revoke", self.max_devices,
                           detail=f"forced to ceiling {self.max_devices}")

    def act(self, t: float, recent_peak_qps: float) -> Optional[GearPlan]:
        """Window boundary: apply the pending desire, if any survives
        cool-down, bounds, and (for shrink) the iso-SLO guard. Returns the
        new active plan, or ``None`` when the fleet is unchanged."""
        trig, self.pending = self.pending, None
        if trig is None:
            return None
        reason = trig.reason
        if t - self.last_action_t < self.cfg.cooldown:
            self._veto(t, reason, self.n_devices, "cooldown")
            return None
        if reason == "scale-out":
            target = min(self.n_devices + self.cfg.grow_step,
                         self.max_devices)
            if target == self.n_devices:
                self._veto(t, reason, target, "at max_devices")
                return None
            return self._apply(t, reason, target,
                               detail=f"qps {trig.measured_qps:.0f}")
        if reason == "scale-in":
            target = max(self.n_devices - self.cfg.shrink_step,
                         self.cfg.min_devices)
            if target == self.n_devices:
                self._veto(t, reason, target, "at min_devices")
                return None
            cap = self._capacity(self.plan_for(target))
            need = self.cfg.shrink_guard * recent_peak_qps
            if cap < need:
                self._veto(t, reason, target,
                           f"iso-SLO guard: capacity {cap:.0f} < "
                           f"{self.cfg.shrink_guard:.2f} x peak "
                           f"{recent_peak_qps:.0f}")
                return None
            return self._apply(t, reason, target,
                               detail=f"capacity {cap:.0f} >= {need:.0f}")
        self._veto(t, reason, self.n_devices, "not a fleet trigger")
        return None

    def _capacity(self, plan: GearPlan) -> float:
        from repro_torch.core.admission import plan_capacity_qps
        return plan_capacity_qps(plan, self.profiles)


# ---------------------------------------------------------------------------
# Windowed elastic-fleet driver
# ---------------------------------------------------------------------------

@dataclass
class FleetRunResult:
    """Aggregate accounting of one scenario run over a (possibly elastic)
    fleet. ``slo_attainment`` charges shed requests as violations — the
    honest denominator for cross-arm comparisons."""
    offered: int
    completed: int
    shed: int
    slo_hits: int
    slo_attainment: float
    p95: float                        # seconds, over all completions
    device_hours: float
    cost: float
    cost_per_million: float           # $ per million OFFERED requests
    fleet_sizes: List[Tuple[float, int]]       # (t, n) step function
    actions: List[FleetAction]
    skipped_events: int               # events aimed past the fleet size
    windows: int


def run_elastic_fleet(profiles: ProfileSet, scenario,
                      plan: Optional[GearPlan] = None,
                      controller: Optional[FleetController] = None,
                      monitor_cfg=None, slo_latency: float = 0.4,
                      window: float = 60.0, sim_cfg=None,
                      peak_window: int = 300) -> FleetRunResult:
    """Replay a ``Scenario`` in fixed windows over a fleet that may change
    size between windows.

    Static arms pass ``plan`` (fleet never moves; cost = num_devices x
    horizon). The elastic arm passes a ``FleetController`` (+
    ``monitor_cfg`` with scale triggers enabled): a ``PlanMonitor`` over
    the active plan's provenance is fed one tick per trace second, its
    scale-out/scale-in triggers land in the controller, and the controller
    acts at window boundaries — exactly the contract ``PlanLifecycle``
    routes through ``fleet.request`` in a live driver.

    Window hand-off: queued-but-unserved requests re-enter the next
    window's first second with a reset arrival clock (their queueing
    history is not preserved — slightly flattering to latency, but the
    same hand-off applies to every arm, so comparisons hold). Device
    state (dead / slow / draining, network degradation) is carried as
    t=0 prefix events; the ``PreemptionCoordinator`` memo makes replays
    O(1). Events aimed at devices past the live fleet size are skipped
    and counted (a scenario is authored for the maximum fleet).
    """
    import dataclasses

    from repro_torch.core.adaption import PlanMonitor, provenance_for_plan
    from repro_torch.core.admission import plan_capacity_qps
    from repro_torch.core.simulator import ServingSimulator, SimConfig

    if (plan is None) == (controller is None):
        raise ValueError("pass exactly one of plan= (static) or "
                         "controller= (elastic)")
    if window < 1.0:
        raise ValueError(f"window must be >= 1 s, got {window}")
    qps = scenario.qps()
    events = scenario.device_events()
    fleet_events = list(scenario.fleet_events())
    sim_cfg = sim_cfg or SimConfig()

    active = controller.plan if controller is not None else plan

    def watch_prov(p):
        # the scale triggers must track the LIVE fleet's ceiling, not the
        # planning-time qps_max (identical across fleet sizes): clamp the
        # watched qps_max to the plan's sustainable capacity, so a small
        # fleet asks for help long before the nominal range tops out
        prov = p.provenance or provenance_for_plan(p)
        cap = plan_capacity_qps(p, profiles)
        if 0.0 < cap < prov.qps_max:
            prov = dataclasses.replace(prov, qps_max=cap)
        return prov

    monitor = None
    if controller is not None and monitor_cfg is not None:
        monitor = PlanMonitor(watch_prov(active), monitor_cfg)
    coord = PreemptionCoordinator(active, profiles)

    # carried world state between windows
    dev_state: Dict[int, Tuple[str, float]] = {}   # dev -> (kind, factor)
    net = 1.0
    carried = 0                                    # backlog folded forward
    total_offered = 0
    total_carried = 0
    completed = 0
    slo_hits = 0
    lat_chunks: List[np.ndarray] = []
    skipped = 0
    fleet_sizes: List[Tuple[float, int]] = [(0.0, active.num_devices)]
    n_windows = 0
    ev_i = 0

    t0 = 0
    horizon = len(qps)
    while t0 < horizon:
        t1 = min(t0 + int(window), horizon)
        n_dev = active.num_devices

        # window-local event stream: carried state first, then this
        # window's events shifted to local time
        evw: List[Tuple[float, int, str, float]] = []
        if net != 1.0:
            evw.append((0.0, -1, "netdeg", net))
        for dev in sorted(dev_state):
            kind, factor = dev_state[dev]
            if dev < n_dev:
                evw.append((0.0, dev, kind, factor))
        while ev_i < len(events) and events[ev_i][0] < t1:
            t, dev, kind, factor = events[ev_i]
            ev_i += 1
            # fold into carried world state
            if kind == "netdeg":
                net = factor
            elif kind in ("fail", "revoke"):
                # once the window containing the revoke has shed the
                # resident work, later windows only need the device down:
                # carry it as a plain t=0 fail prefix
                dev_state[dev] = ("fail", 0.0)
            elif kind == "drain":
                dev_state[dev] = ("drain", factor)
            elif kind == "slow":
                dev_state[dev] = ("slow", factor)
            elif kind == "recover":
                dev_state.pop(dev, None)
                coord.down.discard(dev)
            if kind != "netdeg" and dev >= n_dev:
                skipped += 1
                continue
            evw.append((max(t - t0, 0.0), dev, kind, factor))
        evw.sort(key=lambda e: e[0])

        trace_w = qps[t0:t1].astype(np.float64).copy()
        trace_w[0] += carried
        total_carried += carried

        sim = ServingSimulator(profiles, active.replicas, n_dev, sim_cfg)
        # the final window drains with the scenario's drain; interior
        # windows hand their backlog forward instead of draining it
        drain = scenario.drain if t1 >= horizon else 0.0
        res = sim.run_trace(active, trace_w, drain=drain,
                            device_events=evw or None,
                            on_failure=coord.on_failure)
        n_windows += 1
        total_offered += res.offered
        completed += res.completed
        carried = res.backlog_end
        if res.completed:
            lat_chunks.append(res.latencies)
            slo_hits += int((res.latencies <= slo_latency).sum())

        if monitor is not None:
            for i in range(t1 - t0):
                trig = monitor.on_tick(float(t0 + i), float(qps[t0 + i]))
                if trig is not None and trig.reason in ("scale-out",
                                                        "scale-in"):
                    controller.request(trig, float(t0 + i))

        # ------------------------------------------------ window boundary
        new_plan = None
        if controller is not None:
            controller.meter(float(t1))
            while fleet_events and fleet_events[0][0] < t1:
                ft, fkind, fdev = fleet_events.pop(0)
                forced = controller.apply_fleet_event(float(t1), fkind,
                                                      fdev)
                if forced is not None:
                    new_plan = forced
            peak = float(qps[max(0, t1 - peak_window):t1].max())
            acted = controller.act(float(t1), peak)
            if acted is not None:
                new_plan = acted
        if new_plan is not None:
            active = new_plan
            fleet_sizes.append((float(t1), active.num_devices))
            # dead devices past the new fleet size are gone with their ids
            down = {d for d, (k, _) in dev_state.items()
                    if k in ("fail", "drain") and d < active.num_devices}
            coord.reset(active, down)
            if monitor is not None:
                monitor.rebase(watch_prov(active), float(t1))
        t0 = t1

    offered_net = total_offered - total_carried
    shed = max(0, offered_net - completed)
    if controller is not None:
        controller.meter(float(horizon))
        device_hours = controller.device_hours
        price = controller.cfg.device_hour_price
        actions = list(controller.actions)
    else:
        device_hours = active.num_devices * horizon / 3600.0
        price = 1.0
        actions = []
    cost = device_hours * price
    lats = np.concatenate(lat_chunks) if lat_chunks else np.empty(0)
    return FleetRunResult(
        offered=offered_net, completed=completed, shed=shed,
        slo_hits=slo_hits,
        slo_attainment=slo_hits / max(offered_net, 1),
        p95=float(np.quantile(lats, 0.95)) if len(lats) else math.inf,
        device_hours=device_hours, cost=cost,
        cost_per_million=cost / max(offered_net / 1e6, 1e-12),
        fleet_sizes=fleet_sizes, actions=actions,
        skipped_events=skipped, windows=n_windows)
