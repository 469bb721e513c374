"""Verbatim copy of ``repro/core/adaption.py``,
imports rewritten to ``repro_torch``.

Plan lifecycle: drift detection, background re-planning, atomic hot-swap.

The gear plan is precomputed offline for a QPS range ``[0, qps_max]``, a
QPS prior, a certainty profile, and a hardware spec — all recorded in its
``PlanProvenance``. The paper's own motivation ("frequent, high, and sudden
variations" in arrival rates) means real deployments leave that regime:
offered load exceeds ``qps_max`` and the producer can only clamp to the top
gear, certainty profiles drift, devices are lost for good. This module adds
the missing lifecycle (DESIGN.md §Plan lifecycle):

* ``PlanMonitor``    — compares live observations (measured QPS, observed
                       certainty means, alive devices) against the active
                       plan's provenance and emits ``ReplanTrigger``s.
* ``BackgroundReplanner`` — runs the gear-plan optimiser OFF the critical
                       path (inline for deterministic/virtual drivers with
                       a modelled planning latency; a daemon thread for the
                       wall-clock runtime) and publishes versioned plans.
* ``PlanLifecycle``  — owns the active ``PlanVersion`` and performs the
                       atomic hot-swap: plans are epoch-tagged, in-flight
                       cascades finish on the gear objects of the plan that
                       admitted them, and the current gear index is
                       remapped onto the new plan by measured QPS range.

Both executors drive the identical logic: the ``ServingSimulator`` and the
``CascadeServer`` call ``PlanLifecycle.step`` at every producer measurement
tick, so swap decisions are element-wise comparable through the swap-aware
``DecisionTrace`` (tests/test_scheduling_parity.py). Baseline policies are
swap-frozen via ``PlanProvenance.frozen`` — giving DynBa/MS+/Cocktail+ a
re-provisioning capability the original systems lacked would make the
ablation dishonest.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.gears import GearPlan, PlanProvenance, SLO
from repro_torch.core.plan_state import HardwareSpec, InfeasiblePlanError
from repro_torch.core.scheduling import (GearSelector, SchedulerCore, plan_target,
                                   with_hysteresis)
from repro_torch.core.telemetry import Counter, MetricsRegistry

__all__ = ["MonitorConfig", "PlanMonitor", "ReplanTrigger", "PlanVersion",
           "BackgroundReplanner", "PlanLifecycle", "SwapEvent",
           "planner_replan_fn", "provenance_for_plan"]


# ---------------------------------------------------------------------------
# Triggers + monitor
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReplanTrigger:
    """One detected departure from the active plan's validity regime."""
    reason: str            # qps-exceeds-range | qps-distribution-drift |
    #                        certainty-drift | device-loss | latency-drift |
    #                        scale-out | scale-in
    t: float
    measured_qps: float
    qps_window: Tuple[float, ...] = ()   # recent per-tick measurements
    detail: str = ""


@dataclass(frozen=True)
class MonitorConfig:
    """Drift thresholds. All detection is counter-based and fed only by the
    producer's measurement ticks + the core's certainty stream, so two
    executors replaying the same schedule reach identical verdicts."""
    # offered load beyond the planned range: sustained measured QPS above
    # headroom * qps_max
    qps_headroom: float = 1.0
    qps_sustain_ticks: int = 5
    # measured time-in-range distribution vs the plan's prior (App. C.2)
    tv_threshold: float = 0.35
    tv_min_ticks: int = 200
    tv_check_every: int = 50
    # observed certainty mean vs the profile's validation mean, per model
    cert_drift_threshold: float = 0.10
    cert_min_samples: int = 2000
    # observed p95 latency vs the plan's Monte-Carlo certification band
    # (DESIGN.md §12): trigger when the live p95 exceeds the prior-weighted
    # certified mean by more than ``p95_drift_factor`` prior-weighted CI
    # half-widths. 0.0 (default) disables the check. Plans certified on
    # the single-seed point estimate (empty ``provenance.mc_p95``) carry
    # no CI to key off; they fall back to the scalar certified p95
    # (``provenance.range_p95``) plus ``p95_abs_margin`` seconds. A plan
    # with neither disarms the check with a one-time warning.
    p95_drift_factor: float = 0.0
    p95_min_samples: int = 500
    p95_abs_margin: float = 0.05
    # devices missing for this many consecutive ticks = permanent loss
    device_loss_ticks: int = 20
    # autoscaling triggers (both OFF by default — enabling them changes
    # what on_tick can emit, so existing drivers are unaffected):
    # sustained measured QPS above scale_out_frac * qps_max asks the fleet
    # controller for more devices; sustained below scale_in_frac * qps_max
    # asks to release some (the iso-SLO shrink guard lives in the
    # controller, which knows the candidate plan's capacity)
    scale_out_frac: float = 0.0
    scale_out_ticks: int = 5
    scale_in_frac: float = 0.0
    scale_in_ticks: int = 30
    # no re-trigger storm: quiet period after a trigger fires
    cooldown: float = 10.0
    window_ticks: int = 600


class PlanMonitor:
    """Watches live serving against the active plan's ``PlanProvenance``.

    All four feeds are thin shims over one shared ``MetricsRegistry``
    (core/telemetry.py): ``observe_cert`` (called by
    ``SchedulerCore.next_hop``, the single point every cascade decision
    passes through) accumulates cumulative per-model counters,
    ``observe_latency`` and ``on_tick``'s measured QPS land in bounded
    ``WindowSeries``, and ``observe_devices`` sets a gauge. Drift
    verdicts are computed FROM the registry against rebase-time baseline
    snapshots, so any other consumer (FleetController dashboards,
    ``launch/serve.py --metrics-out``) reads the same stream the monitor
    keys off. Holds no clock and draws no randomness — determinism is
    what makes swap parity testable.
    """

    def __init__(self, provenance: PlanProvenance,
                 cfg: MonitorConfig = MonitorConfig(),
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        # per-model (count, sum) counter pairs, cached so the per-decision
        # observe_cert shim costs one lock acquire + two float adds (the
        # cert stream arrives from every consumer thread in the threaded
        # server; uncontended in the single-threaded drivers: ~no cost)
        self._cert_counters: Dict[str, Tuple[Counter, Counter]] = {}
        self._dev_gauge = self.registry.gauge("devices_alive")
        self._p95_warned = False
        self.rebase(provenance, t=0.0)

    def _cert_pair(self, model: str) -> Tuple[Counter, Counter]:
        pair = self._cert_counters.get(model)
        if pair is None:
            pair = (self.registry.counter("cascade_cert_count",
                                          model=model),
                    self.registry.counter("cascade_cert_sum", model=model))
            self._cert_counters[model] = pair
        return pair

    def rebase(self, provenance: PlanProvenance, t: float) -> None:
        """Start watching a (new) plan; all drift state resets. Registry
        streams are cumulative and shared, so "reset" means snapshotting
        baselines here and reading deltas in ``_check``."""
        self.provenance = provenance
        cfg = self.cfg
        reg = self.registry
        self._prior = np.asarray(provenance.qps_prior, np.float64)
        self._cert_ref: Dict[str, float] = dict(provenance.cert_means)
        self._qps_series = reg.series("measured_qps",
                                      maxlen=cfg.window_ticks)
        self._qps_base = self._qps_series.count
        # live completion latencies for the CI-keyed p95 drift check; the
        # certified band belongs to THIS plan, so the window is scoped to
        # observations made after this rebase
        self._lat_series = reg.series("request_latency_window", maxlen=4096)
        self._lat_base = self._lat_series.count
        self._lat_reported = False
        self._p95_threshold: Optional[float] = None
        self._p95_mode = ""
        if cfg.p95_drift_factor > 0:
            if provenance.mc_p95:
                w = self._prior[:len(provenance.mc_p95)]
                means = np.array([m for m, _ in provenance.mc_p95])
                cis = np.array([c for _, c in provenance.mc_p95])
                self._p95_threshold = float(
                    (w * means).sum()
                    + cfg.p95_drift_factor * (w * cis).sum())
                self._p95_mode = "mc"
            elif provenance.range_p95:
                # single-seed plan: no CI band — fall back to the scalar
                # certified per-range p95 plus an absolute margin
                w = self._prior[:len(provenance.range_p95)]
                means = np.asarray(provenance.range_p95, np.float64)
                self._p95_threshold = float(
                    (w * means).sum() + cfg.p95_abs_margin)
                self._p95_mode = "scalar"
            elif not self._p95_warned:
                self._p95_warned = True
                warnings.warn(
                    "MonitorConfig.p95_drift_factor is set but the plan's "
                    "provenance carries neither mc_p95 (Monte-Carlo band) "
                    "nor range_p95 (scalar certified p95) — the "
                    "latency-drift check is disarmed for this plan",
                    RuntimeWarning, stacklevel=2)
        self._over_ticks = 0
        self._loss_ticks = 0
        self._scale_out_ticks = 0
        self._scale_in_ticks = 0
        self._tick_no = 0
        with reg.lock:   # consumer threads may be mid-observe_cert
            self._cert_base = {
                m: (self._cert_pair(m)[0].value, self._cert_pair(m)[1].value)
                for m in self._cert_ref}
        # _n_alive and _loss_reported_n are WORLD state, not per-plan drift
        # state: a device still dead across a hot-swap must stay visible to
        # loss detection, and a loss level already reported must not
        # re-trigger after the swap's rebase (a pinned-placement re-plan
        # cannot revive devices — re-reporting the same loss forever would
        # just burn planner cycles; see planner_replan_fn). The alive count
        # itself lives in the registry's devices_alive gauge.
        if not hasattr(self, "_loss_reported_n"):
            self._loss_reported_n: Optional[int] = None
            # models whose certainty drift was already reported: a pinned
            # re-plan keeps the same profiles, so the same drift would
            # re-trigger a futile optimizer run every cooldown; re-arm
            # only when the observed mean returns below the threshold
            # (e.g. after a re-profile updates the reference)
            self._cert_reported: Dict[str, bool] = {}
        self._quiet_until = t + self.cfg.cooldown \
            if self.cfg.cooldown > 0 and t > 0 else 0.0

    # ------------------------------------------------------------- feeds
    def observe_cert(self, model: str, cert: float) -> None:
        c, s = self._cert_pair(model)
        with self.registry.lock:
            c.value += 1.0
            s.value += cert

    def observe_devices(self, n_alive: int) -> None:
        self._dev_gauge.set(int(n_alive))

    def observe_latency(self, latency: float) -> None:
        """Completion-latency feed for the CI-keyed p95 drift check
        (drivers call this per finished sample; optional — the check just
        stays silent without it)."""
        self._lat_series.observe(latency)

    @property
    def _n_alive(self) -> Optional[int]:
        v = self._dev_gauge.value
        return None if v is None else int(v)

    def _qps_win(self) -> Tuple[float, ...]:
        """The qps ticks observed under the currently-watched plan (only
        materialised on the rare trigger/TV paths, not every tick)."""
        return self._qps_series.since(self._qps_base)

    # ------------------------------------------------------------ verdict
    def on_tick(self, t: float, measured_qps: float
                ) -> Optional[ReplanTrigger]:
        """One producer measurement tick; returns at most one trigger."""
        cfg = self.cfg
        self._tick_no += 1
        self._qps_series.observe(measured_qps)
        if measured_qps > cfg.qps_headroom * self.provenance.qps_max:
            self._over_ticks += 1
        else:
            self._over_ticks = 0
        if cfg.scale_out_frac > 0 and \
                measured_qps > cfg.scale_out_frac * self.provenance.qps_max:
            self._scale_out_ticks += 1
        else:
            self._scale_out_ticks = 0
        if cfg.scale_in_frac > 0 and \
                measured_qps < cfg.scale_in_frac * self.provenance.qps_max:
            self._scale_in_ticks += 1
        else:
            self._scale_in_ticks = 0
        if self._n_alive is not None and \
                self._n_alive < self.provenance.num_devices:
            self._loss_ticks += 1
        else:
            self._loss_ticks = 0
            self._loss_reported_n = None    # full recovery re-arms

        if t < self._quiet_until:
            return None
        trig = self._check(t, measured_qps)
        if trig is not None:
            self._quiet_until = t + cfg.cooldown
            self._over_ticks = 0
            self._loss_ticks = 0
            self._scale_out_ticks = 0
            self._scale_in_ticks = 0
        return trig

    def _check(self, t: float, measured_qps: float
               ) -> Optional[ReplanTrigger]:
        # the window tuple (<= window_ticks floats) is only materialised on
        # the rare paths that emit a trigger or run the TV check — not on
        # every tick of the measurement loop
        cfg = self.cfg
        # scale-out outranks the in-range re-plan: sustained load near the
        # planned ceiling is a capacity problem before it is a plan problem
        if cfg.scale_out_frac > 0 and \
                self._scale_out_ticks >= cfg.scale_out_ticks:
            return ReplanTrigger(
                "scale-out", t, measured_qps, self._qps_win(),
                detail=f"measured {measured_qps:.0f} qps > "
                       f"{cfg.scale_out_frac:.2f} x qps_max "
                       f"{self.provenance.qps_max:.0f} for "
                       f"{self._scale_out_ticks} ticks")
        if self._over_ticks >= cfg.qps_sustain_ticks:
            return ReplanTrigger(
                "qps-exceeds-range", t, measured_qps,
                self._qps_win(),
                detail=f"measured {measured_qps:.0f} qps > "
                       f"{cfg.qps_headroom:.2f} x qps_max "
                       f"{self.provenance.qps_max:.0f} for "
                       f"{self._over_ticks} ticks")
        if self._loss_ticks >= cfg.device_loss_ticks and (
                self._loss_reported_n is None or
                self._n_alive < self._loss_reported_n):
            # one trigger per loss LEVEL: re-trigger only if loss deepens
            self._loss_reported_n = self._n_alive
            return ReplanTrigger(
                "device-loss", t, measured_qps, self._qps_win(),
                detail=f"{self._n_alive}/{self.provenance.num_devices} "
                       f"devices alive for {self._loss_ticks} ticks")
        for m, ref in self._cert_ref.items():
            c, s_ctr = self._cert_pair(m)
            base_n, base_s = self._cert_base.get(m, (0.0, 0.0))
            with self.registry.lock:
                n = int(c.value - base_n)
                s = s_ctr.value - base_s
            if n < cfg.cert_min_samples:
                continue
            obs = s / n
            if abs(obs - ref) <= cfg.cert_drift_threshold:
                self._cert_reported.pop(m, None)    # recovered: re-arm
            elif not self._cert_reported.get(m):
                self._cert_reported[m] = True       # report once per drift
                return ReplanTrigger(
                    "certainty-drift", t, measured_qps,
                    self._qps_win(),
                    detail=f"{m}: observed mean certainty {obs:.3f} vs "
                           f"profiled {ref:.3f} over {n} samples")
        if self._p95_threshold is not None:
            lats = () if self._lat_series.n_since(self._lat_base) < \
                cfg.p95_min_samples else self._lat_series.since(
                    self._lat_base)
            if lats:
                n_lat = len(lats)
                obs_p95 = float(np.percentile(np.asarray(lats), 95))
                if obs_p95 <= self._p95_threshold:
                    self._lat_reported = False          # recovered: re-arm
                elif not self._lat_reported:
                    self._lat_reported = True           # report once
                    band = (f"mean + {cfg.p95_drift_factor:.1f} x CI"
                            if self._p95_mode == "mc" else
                            f"scalar certified p95 + "
                            f"{cfg.p95_abs_margin * 1e3:.0f}ms margin")
                    return ReplanTrigger(
                        "latency-drift", t, measured_qps,
                        self._qps_win(),
                        detail=f"observed p95 {obs_p95 * 1e3:.0f}ms > "
                               f"certified band "
                               f"{self._p95_threshold * 1e3:.0f}ms "
                               f"({band}, {n_lat} samples)")
        if self._qps_series.n_since(self._qps_base) >= cfg.tv_min_ticks \
                and self._tick_no % cfg.tv_check_every == 0:
            window = self._qps_win()
            tv = self._tv_distance(window)
            if tv > cfg.tv_threshold:
                return ReplanTrigger(
                    "qps-distribution-drift", t, measured_qps, window,
                    detail=f"TV distance {tv:.2f} from planned prior")
        # scale-in is checked LAST: any live drift concern vetoes releasing
        # hardware this tick (hysteresis against shrink-then-scramble)
        if cfg.scale_in_frac > 0 and \
                self._scale_in_ticks >= cfg.scale_in_ticks:
            return ReplanTrigger(
                "scale-in", t, measured_qps, self._qps_win(),
                detail=f"measured {measured_qps:.0f} qps < "
                       f"{cfg.scale_in_frac:.2f} x qps_max "
                       f"{self.provenance.qps_max:.0f} for "
                       f"{self._scale_in_ticks} ticks")
        return None

    def _tv_distance(self, window: Tuple[float, ...]) -> float:
        from repro_torch.core.traces import measured_qps_distribution
        measured = measured_qps_distribution(
            np.asarray(window), len(self._prior), self.provenance.qps_max)
        return 0.5 * float(np.abs(measured - self._prior).sum())


# ---------------------------------------------------------------------------
# Background re-planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanVersion:
    """An epoch-tagged published plan. Samples admitted under one epoch
    finish on its gear objects even after a newer epoch is activated."""
    epoch: int
    plan: GearPlan
    provenance: PlanProvenance
    trigger: Optional[ReplanTrigger] = None


PlanFn = Callable[[ReplanTrigger, PlanVersion], GearPlan]


class BackgroundReplanner:
    """Runs ``plan_fn`` off the serving critical path, publishes the result.

    Two execution modes share one publication contract (a plan becomes
    visible at the first ``poll`` whose time has passed ``ready_at``):

    * deterministic (default): ``plan_fn`` runs synchronously at submit —
      its wall cost is off the *virtual* clock — and the result is
      published ``plan_latency`` virtual seconds after the trigger. This is
      what the simulator and ``run_virtual`` use, and what makes swap
      timing identical across executors.
    * ``threaded=True``: ``plan_fn`` runs in a daemon thread; publication
      additionally waits for the thread to finish. This is the wall-clock
      ``CascadeServer`` mode — the producer tick that polls is never
      blocked by the optimiser.

    A ``plan_fn`` that raises ``InfeasiblePlanError`` (e.g. the drifted
    workload is unservable on the pinned placement) records the failure
    and clears the pending slot; serving continues on the active plan.
    """

    def __init__(self, plan_fn: PlanFn, plan_latency: float = 1.0,
                 threaded: bool = False):
        self.plan_fn = plan_fn
        self.plan_latency = plan_latency
        self.threaded = threaded
        self.failures: List[Tuple[float, str]] = []
        # wall seconds the most recent plan_fn invocation took (virtual
        # drivers publish on plan_latency, but the real drift-to-recovery
        # window is bounded by this — bench_replanning reports it)
        self.last_plan_wall: Optional[float] = None
        self._pending: Optional[dict] = None
        self._lock = threading.Lock()

    @property
    def busy(self) -> bool:
        return self._pending is not None

    def submit(self, trigger: ReplanTrigger, active: PlanVersion,
               t: float) -> bool:
        """Start one re-plan; refused (False) while another is pending."""
        with self._lock:
            if self._pending is not None:
                return False
            pend = {"trigger": trigger, "active": active,
                    "ready_at": t + self.plan_latency, "plan": None,
                    "error": None, "thread": None}
            self._pending = pend
        if self.threaded:
            th = threading.Thread(target=self._compute, args=(pend,),
                                  daemon=True)
            pend["thread"] = th
            th.start()
        else:
            self._compute(pend)
        return True

    def _compute(self, pend: dict) -> None:
        # catch EVERYTHING: a re-plan failure of any kind (infeasible SLO,
        # LP numerics, a buggy plan_fn) must degrade to "keep serving the
        # active plan", never kill the producer tick that polls us
        t0 = time.time()
        try:
            pend["plan"] = self.plan_fn(pend["trigger"], pend["active"])
        except Exception as e:
            pend["error"] = f"{type(e).__name__}: {e}"
        self.last_plan_wall = time.time() - t0

    def poll(self, t: float) -> Optional[PlanVersion]:
        """Return the newly published plan once, when due; else None."""
        with self._lock:
            pend = self._pending
            if pend is None or t < pend["ready_at"]:
                return None
            th = pend["thread"]
            if th is not None and th.is_alive():
                return None
            self._pending = None
        if pend["error"] is not None:
            self.failures.append((t, pend["error"]))
            return None
        plan: GearPlan = pend["plan"]
        prov = plan.provenance or provenance_for_plan(plan)
        return PlanVersion(epoch=pend["active"].epoch + 1, plan=plan,
                           provenance=prov, trigger=pend["trigger"])


def provenance_for_plan(plan: GearPlan, frozen: bool = False
                        ) -> PlanProvenance:
    """Minimal provenance for plans built outside the planner (baselines,
    hand-made test plans): uniform prior, no profile digest."""
    n = max(plan.n_ranges, 1)
    return PlanProvenance(
        qps_max=plan.qps_max, n_ranges=n,
        qps_prior=tuple([1.0 / n] * n),
        num_devices=plan.num_devices, mem_per_device=0.0,
        profile_digest="", cert_means=(), frozen=frozen)


def planner_replan_fn(profiles, hardware: HardwareSpec, slo: SLO,
                      n_ranges: int = 8, sim_cfg=None, seed: int = 0,
                      qps_margin: float = 1.25, pin_placement: bool = True,
                      warm_state=None, max_calls: int = 200,
                      fast_path: bool = True,
                      background_qps=None) -> PlanFn:
    """The production ``plan_fn``: re-run Algorithm 1 warm-started from the
    previous ``PlannerState``, with the measured QPS window as the prior
    (App. C.2) and — for load beyond the planned range — an extended
    ``qps_max``. ``pin_placement`` keeps the serving replica set fixed so
    the result is hot-swappable (no model loading on the critical path).

    A ``device-loss`` trigger re-plans against the measured prior but
    cannot drop the dead device's replicas (placement is pinned); true
    placement repair is ``rebalance_on_failure`` / rolling-restart
    territory. The monitor reports each loss LEVEL once, so this does not
    loop."""
    from repro_torch.core.planner import optimize_gear_plan
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.traces import measured_qps_distribution

    def plan_fn(trigger: ReplanTrigger, active: PlanVersion) -> GearPlan:
        qps_max = active.plan.qps_max
        if trigger.reason in ("qps-exceeds-range",
                              "qps-distribution-drift") and \
                trigger.qps_window:
            peak = max(max(trigger.qps_window), trigger.measured_qps)
            qps_max = max(qps_max, peak * qps_margin)
        prior = None
        if trigger.qps_window:
            prior = measured_qps_distribution(
                np.asarray(trigger.qps_window), n_ranges, qps_max)
            prior = np.maximum(prior, 1e-6)
            prior = prior / prior.sum()
        report = optimize_gear_plan(
            profiles, hardware, slo, qps_max, n_ranges=n_ranges,
            qps_prior=prior, sim_cfg=sim_cfg or SimConfig(), seed=seed,
            max_calls=max_calls,
            pinned_replicas=list(active.plan.replicas)
            if pin_placement else None,
            warm_state=chain["warm"], fast_path=fast_path,
            background_qps=background_qps)
        chain["warm"] = report.state    # next re-plan warm-starts from US
        return report.plan

    chain = {"warm": warm_state}
    return plan_fn


# ---------------------------------------------------------------------------
# Lifecycle: the atomic hot-swap
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SwapEvent:
    """Everything a driver must apply atomically at one measurement tick."""
    t: float
    epoch: int
    old_gear: int
    new_gear: int          # remapped by measured QPS range on the new plan
    reason: str
    plan: GearPlan
    selector: Optional[GearSelector]
    version: PlanVersion


class PlanLifecycle:
    """Owns the active ``PlanVersion``; drivers call ``step`` every
    measurement tick and apply the returned ``SwapEvent`` (new gear table,
    remapped gear index, new selector) as one state update.

    The swap is *atomic* from the scheduling core's perspective: decisions
    before the tick are taken on the old plan, decisions after it on the
    new one, and in-flight samples carry their admitting gear object, so
    they resolve/cascade under the plan that admitted them regardless of
    how many swaps happen while they queue (epoch tagging).

    A lifecycle built over a ``frozen`` provenance (baseline policies)
    still monitors — the observability is free — but never submits a
    re-plan and never swaps.
    """

    def __init__(self, plan: GearPlan,
                 monitor: Optional[PlanMonitor] = None,
                 replanner: Optional[BackgroundReplanner] = None,
                 selector_factory: Optional[
                     Callable[[GearPlan], GearSelector]] = None,
                 alpha: float = 8.0, fleet=None):
        prov = plan.provenance or provenance_for_plan(plan)
        self.monitor = monitor if monitor is not None else PlanMonitor(prov)
        self.replanner = replanner
        # scale-out / scale-in triggers are FLEET actions, not hot-swaps:
        # they route to the FleetController (distributed/fault_tolerance),
        # which applies them between serving windows — a fleet change moves
        # replicas and can never pass _placement_compatible
        self.fleet = fleet
        # when no explicit factory is given, the hysteresis alpha is
        # adopted from the attached core's config (attach()), so a swap
        # never silently resets a driver's tuned alpha to the default
        self._selector_factory = selector_factory
        self._alpha = alpha
        self.active = PlanVersion(epoch=0, plan=plan, provenance=prov)
        self.swaps: List[SwapEvent] = []
        self.triggers: List[ReplanTrigger] = []
        self._trace = None

    @property
    def frozen(self) -> bool:
        return self.active.provenance.frozen

    @property
    def epoch(self) -> int:
        return self.active.epoch

    def attach(self, core: SchedulerCore) -> None:
        """Wire the monitor into the shared core (certainty stream), adopt
        its trace for swap-aware parity checking and its configured
        hysteresis alpha for post-swap selectors."""
        core.monitor = self.monitor
        self._trace = core.trace
        if self._selector_factory is None:
            self._alpha = core.cfg.alpha

    def selector_factory(self, plan: GearPlan) -> GearSelector:
        if self._selector_factory is not None:
            return self._selector_factory(plan)
        return with_hysteresis(plan_target(plan), self._alpha)

    def _placement_compatible(self, plan: GearPlan) -> bool:
        old = self.active.plan.replicas
        return len(plan.replicas) == len(old) and all(
            a.model == b.model and a.device == b.device
            for a, b in zip(plan.replicas, old))

    def step(self, t: float, measured_qps: float, cur_gear: int
             ) -> Optional[SwapEvent]:
        """One measurement tick: feed the monitor, kick off / collect the
        background re-plan, and emit the swap for the driver to apply."""
        trig = self.monitor.on_tick(t, measured_qps)
        if trig is not None:
            self.triggers.append(trig)
            if trig.reason in ("scale-out", "scale-in"):
                if not self.frozen and self.fleet is not None:
                    self.fleet.request(trig, t)
            elif not self.frozen and self.replanner is not None:
                self.replanner.submit(trig, self.active, t)
        if self.frozen or self.replanner is None:
            return None
        ready = self.replanner.poll(t)
        if ready is None:
            return None
        if not self._placement_compatible(ready.plan):
            # queues/engines are keyed by replica index; a plan that moves
            # replicas needs a rolling restart, not a hot-swap
            self.replanner.failures.append(
                (t, f"epoch {ready.epoch}: placement-incompatible plan "
                    f"rejected (replicas moved)"))
            return None
        new_gear = ready.plan.gear_index_for_qps(measured_qps)
        ev = SwapEvent(
            t=t, epoch=ready.epoch, old_gear=cur_gear, new_gear=new_gear,
            reason=ready.trigger.reason if ready.trigger else "",
            plan=ready.plan, selector=self.selector_factory(ready.plan),
            version=ready)
        self.active = ready
        self.swaps.append(ev)
        self.monitor.rebase(ready.provenance, t)
        if self._trace is not None:
            self._trace.record_swap(ready.epoch, cur_gear, new_gear)
        return ev
