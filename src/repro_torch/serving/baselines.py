"""Verbatim copy of ``repro/serving/baselines.py``,
imports rewritten to ``repro_torch``.

Baseline serving policies (paper §6.2), executed on the same
discrete-event simulator as CascadeServe for apples-to-apples cost curves.

* DynBa      — static provisioning, ONE model on all devices, dynamic
               batching (the paper's own batching mechanism).
* MS+        — Model-Switching upgraded: single-model gears selected by
               measured QPS (Clipper-style batching, max replication packing).
* Cocktail+  — bagging-ensemble serving with idealised autoscaling: ground-
               truth workload forecast, instant VMs (+ warmup), coarse
               scaling interval. Ensembles majority-vote; cost = the
               time-average of ACTIVE devices.

Each baseline exposes ``build(profiles, hardware, slo, qps_max)`` returning
(gears, selector, replicas, num_devices) for ``ServingSimulator.run_policy``,
plus a small hyperparameter grid (the paper grid-searches baselines).

The selectors conform to the shared ``repro.core.scheduling.GearSelector``
protocol — the same contract the §5 producer policy uses — so every
baseline can also execute on the REAL runtime: ``build_plan`` packages the
policy as ``(GearPlan, selector)`` for
``CascadeServer(plan, engines, selector=selector)``.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cascade import Cascade, enumerate_model_orderings
from repro_torch.core.gears import Gear, GearPlan, SLO, uniform_load_fractions
from repro_torch.core.lp import Replica
from repro_torch.core.plan_state import HardwareSpec
from repro_torch.core.profiles import ProfileSet
from repro_torch.core.scheduling import GearSelector, is_ensemble
from repro_torch.core.simulator import make_gear


class BaselinePolicy:
    """Shared packaging: any policy whose ``build`` returns
    (gears, selector, replicas, num_devices) can run on either executor."""

    def build(self, profiles: ProfileSet, hw: HardwareSpec, slo: SLO,
              qps_max: float
              ) -> Tuple[List[Gear], GearSelector, List[Replica], int]:
        raise NotImplementedError

    def build_plan(self, profiles: ProfileSet, hw: HardwareSpec, slo: SLO,
                   qps_max: float) -> Tuple[GearPlan, GearSelector]:
        """The same policy as a (GearPlan, GearSelector) pair, directly
        servable by ``CascadeServer(plan, engines, selector=selector)``."""
        gears, selector, reps, num_devices = self.build(
            profiles, hw, slo, qps_max)
        if any(is_ensemble(g) for g in gears):
            # CascadeServer has no voting path: a silent fallback would
            # serve only the first ensemble member and misreport accuracy
            raise NotImplementedError(
                "ensemble-mode gears execute on the simulator only; the "
                "real runtime cannot majority-vote yet")
        plan = GearPlan(qps_max=qps_max, gears=list(gears),
                        replicas=list(reps), num_devices=num_devices,
                        slo=slo)
        # baselines are SWAP-FROZEN: a PlanLifecycle over this plan still
        # monitors but never re-plans or hot-swaps. DynBa/MS+/Cocktail+
        # had no online re-provisioning of the policy itself; granting
        # them ours would make the re-planning ablation dishonest.
        from repro_torch.core.adaption import provenance_for_plan
        plan.provenance = provenance_for_plan(plan, frozen=True)
        return plan, selector


def _replicate_everywhere(profiles: ProfileSet, models: Sequence[str],
                          hw: HardwareSpec) -> List[Replica]:
    """Greedy collocation: every model on every device while memory lasts
    (paper's MS+ adaptation: 'maximize replication and throughput').
    First pass guarantees each model one replica (FFD); second pass fills
    remaining memory with extra replicas, large models first."""
    reps: List[Replica] = []
    free = np.full(hw.num_devices, hw.mem_per_device)
    by_size = sorted(models, key=lambda m: -profiles[m].mem_bytes)
    for m in by_size:  # guarantee pass
        d = int(np.argmax(free))
        if free[d] >= profiles[m].mem_bytes:
            free[d] -= profiles[m].mem_bytes
            reps.append(Replica(m, d, profiles[m].runtime_per_sample(1.0)))
    for m in by_size:  # replication pass
        for d in range(hw.num_devices):
            if any(r.model == m and r.device == d for r in reps):
                continue
            if free[d] >= profiles[m].mem_bytes:
                free[d] -= profiles[m].mem_bytes
                reps.append(Replica(m, d,
                                    profiles[m].runtime_per_sample(1.0)))
    return reps


# ---------------------------------------------------------------------------
# DynBa
# ---------------------------------------------------------------------------

@dataclass
class DynBaPolicy(BaselinePolicy):
    model: str

    def build(self, profiles: ProfileSet, hw: HardwareSpec, slo: SLO,
              qps_max: float):
        reps = _replicate_everywhere(profiles, [self.model], hw)
        gear = make_gear(Cascade((self.model,), ()), reps)
        return [gear], (lambda t, q, g, q0: 0), reps, hw.num_devices

    @staticmethod
    def grid(profiles: ProfileSet) -> List["DynBaPolicy"]:
        return [DynBaPolicy(m) for m in profiles]


# ---------------------------------------------------------------------------
# MS+ (Model Switching on GPUs with Clipper batching)
# ---------------------------------------------------------------------------

@dataclass
class MSPlusPolicy(BaselinePolicy):
    n_ranges: int = 8
    # safety factor on the capacity estimate when choosing the model per range
    headroom: float = 1.0

    def build(self, profiles: ProfileSet, hw: HardwareSpec, slo: SLO,
              qps_max: float):
        order = enumerate_model_orderings(profiles)  # cheap -> expensive
        reps = _replicate_everywhere(profiles, order, hw)
        n_reps = {m: sum(1 for r in reps if r.model == m) for m in order}
        gears: List[Gear] = []
        width = qps_max / self.n_ranges
        for i in range(self.n_ranges):
            hi = (i + 1) * width
            # most accurate single model whose replicas sustain `hi`
            best = order[0]
            for m in order:
                cap = n_reps.get(m, 0) * profiles[m].max_throughput()
                if cap * self.headroom >= hi and (
                        profiles[m].accuracy >= profiles[best].accuracy):
                    best = m
            gears.append(make_gear(Cascade((best,), ()), reps))

        def selector(t, measured_qps, cur, q0):
            return min(int(measured_qps / width), self.n_ranges - 1)

        return gears, selector, reps, hw.num_devices

    @staticmethod
    def grid(profiles: ProfileSet) -> List["MSPlusPolicy"]:
        return [MSPlusPolicy(headroom=h) for h in (0.7, 1.0, 1.3)]


# ---------------------------------------------------------------------------
# Cocktail+ (idealised bagging-ensemble autoscaler)
# ---------------------------------------------------------------------------

@dataclass
class CocktailPlusPolicy(BaselinePolicy):
    scale_interval: float = 10.0   # coarse autoscaling period (paper §6.3)
    target_util: float = 0.7
    ensemble_size: int = 3         # odd, majority vote
    forecast: Optional[np.ndarray] = None  # ground-truth per-second QPS

    def _pick_ensemble(self, profiles: ProfileSet, slo: SLO) -> Tuple[str, ...]:
        """Cheapest odd ensemble whose majority vote matches the most
        accurate single model (Cocktail's premise)."""
        order = enumerate_model_orderings(profiles)
        target_acc = max(p.accuracy for p in profiles.values())
        if slo.kind == "accuracy":
            target_acc = slo.min_accuracy
        best: Optional[Tuple[str, ...]] = None
        best_cost = math.inf
        for combo in itertools.combinations(order, self.ensemble_size):
            votes = np.stack([profiles[m].validation.correct for m in combo])
            acc = float((votes.sum(0) * 2 > len(combo)).mean())
            cost = sum(profiles[m].runtime_per_sample() for m in combo)
            if acc >= target_acc - 1e-3 and cost < best_cost:
                best, best_cost = combo, cost
        if best is None:
            best = tuple(order[-self.ensemble_size:])
        return best

    def build(self, profiles: ProfileSet, hw: HardwareSpec, slo: SLO,
              qps_max: float):
        members = self._pick_ensemble(profiles, slo)
        reps = _replicate_everywhere(profiles, members, hw)
        # gear k = ensemble served by the first (k+1) devices
        gears: List[Gear] = []
        for k in range(hw.num_devices):
            active = [i for i, r in enumerate(reps) if r.device <= k]
            lf = {}
            for m in members:
                idxs = [i for i in active if reps[i].model == m]
                if idxs:
                    lf[m] = {i: 1.0 / len(idxs) for i in idxs}
            g = Gear(cascade=Cascade(members, (0.0,) * (len(members) - 1)),
                     min_queue_lens={m: 1 for m in members},
                     load_fractions=lf)
            g.mode = "ensemble"  # type: ignore[attr-defined]
            gears.append(g)

        cost_per_sample = sum(
            profiles[m].runtime(profiles[m].batch_sizes[-1])
            / profiles[m].batch_sizes[-1] for m in members)
        forecast = self.forecast
        interval = self.scale_interval
        n_dev = hw.num_devices

        def selector(t, measured_qps, cur, q0):
            # ground-truth forecast over the next scaling window
            if forecast is not None:
                lo = int(t)
                hor = forecast[lo:lo + int(interval)]
                peak = float(hor.max()) if len(hor) else measured_qps
            else:
                peak = measured_qps
            need = peak * cost_per_sample / max(self.target_util, 1e-3)
            k = int(np.clip(math.ceil(need), 1, n_dev)) - 1
            # coarse interval: only change at interval boundaries
            if int(t / interval) == int((t - 0.1) / interval) and cur != k:
                return cur
            return k

        return gears, selector, reps, hw.num_devices

    @staticmethod
    def grid(profiles: ProfileSet, forecast: Optional[np.ndarray] = None
             ) -> List["CocktailPlusPolicy"]:
        out = []
        for interval in (5.0, 10.0, 20.0):
            for util in (0.5, 0.7, 0.9):
                out.append(CocktailPlusPolicy(
                    scale_interval=interval, target_util=util,
                    forecast=forecast))
        return out

    @staticmethod
    def active_device_cost(result, gears) -> float:
        """Time-averaged active devices (autoscaled cost metric)."""
        # gear index k <=> k+1 active devices; integrate over switches
        switches = result.gear_switches
        if not switches:
            return 1.0
        total, t_prev, k_prev = 0.0, 0.0, 0
        for t, k in switches:
            total += (t - t_prev) * (k_prev + 1)
            t_prev, k_prev = t, k
        total += (result.horizon - t_prev) * (k_prev + 1)
        return total / result.horizon


# ---------------------------------------------------------------------------
# Static per-tenant partitioning (multi-tenant control, core/tenancy.py)
# ---------------------------------------------------------------------------

def partition_devices(tenants, num_devices: int) -> Dict[str, int]:
    """Weight-proportional static device split (largest remainder, every
    tenant at least one device — it is a PARTITIONING baseline: dedicated
    hardware per tenant, no sharing). Deterministic: remainder ties break
    by tenant order."""
    tenants = list(tenants)
    n = len(tenants)
    if num_devices < n:
        raise ValueError(
            f"cannot partition {num_devices} devices across {n} tenants "
            f"(one device minimum each)")
    wsum = sum(max(t.weight, 0.0) for t in tenants)
    if wsum <= 0:
        shares = [num_devices / n] * n
    else:
        shares = [num_devices * max(t.weight, 0.0) / wsum for t in tenants]
    base = [max(1, int(s)) for s in shares]
    while sum(base) > num_devices:       # min-1 guarantee overshot
        i = max(range(n), key=lambda j: base[j])
        base[i] -= 1
    rem = num_devices - sum(base)
    frac = sorted(range(n), key=lambda j: (-(shares[j] - int(shares[j])), j))
    for k in range(rem):
        base[frac[k % n]] += 1
    return {t.name: b for t, b in zip(tenants, base)}


@dataclass
class StaticPartitionPolicy:
    """The obvious multi-tenant control: carve the fleet into per-tenant
    static partitions (weight-proportional) and run an independent
    single-tenant CascadeServe plan inside each. No capacity is ever
    borrowed across tenants — one tenant's flash crowd is confined to its
    own slice, and its idle headroom is wasted. ``build_plans`` returns,
    per tenant, the partition plan wrapped as a single-tenant
    ``MultiTenantPlan`` (so the benchmark runs both arms through the same
    executor + admission machinery — the comparison isolates sharing) plus
    its partition's ``HardwareSpec``."""

    def build_plans(self, profiles: ProfileSet, hw: HardwareSpec, tenants,
                    sim_cfg=None, seed: int = 0, fast_path: bool = True,
                    max_calls: int = 200) -> Dict[str, Tuple]:
        from repro_torch.core.planner import optimize_gear_plan
        from repro_torch.core.simulator import SimConfig
        from repro_torch.core.tenancy import single_tenant_plan
        parts = partition_devices(tenants, hw.num_devices)
        out: Dict[str, Tuple] = {}
        for t in tenants:
            hw_t = HardwareSpec(num_devices=parts[t.name],
                                mem_per_device=hw.mem_per_device,
                                chips_per_device=hw.chips_per_device)
            report = optimize_gear_plan(
                profiles, hw_t, t.slo, t.qps_max, n_ranges=t.n_ranges,
                qps_prior=np.asarray(t.qps_prior, np.float64)
                if t.qps_prior is not None else None,
                sim_cfg=sim_cfg if sim_cfg is not None else SimConfig(),
                seed=seed, max_calls=max_calls, fast_path=fast_path)
            out[t.name] = (single_tenant_plan(t, report), hw_t, report)
        return out
