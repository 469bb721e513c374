"""Verbatim copy of ``repro/core/fastsim.py``,
imports rewritten to ``repro_torch``.

Fast evaluation layer for the gear planner (DESIGN.md §10).

The planner's inner search used to pay for every probe with a full Python
event-heap ``ServingSimulator.run_fixed`` — and since online re-planning
(core/adaption.py) moved that search onto the serving path, planner
wall-clock directly bounds drift recovery. Following InferLine's structure
(cheap analytic estimator drives the combinatorial search, the high-fidelity
simulator certifies only final candidates), this module supplies the cheap
path; decisions are still *certified* by the exact DES:

* ``FastEvaluator``       — vectorized steady-state evaluator: scores a whole
  ``(gear, qps, min_queue_lens)`` trigger ladder in one numpy-batched call.
  Per-replica batch sizes come from the queueing fixed point
  ``b = clip(max(b_trigger, λ·R(b)), 1, max_batch)`` (arrivals accumulated
  during service self-grow the batch, exactly as in the DES), runtimes via
  vectorized profile interpolation (one ``np.interp`` per model over all
  candidates instead of per-event Python calls), stability from per-device
  utilisation, and closed-form p95/accuracy estimates.
* ``SimMemo``             — memo cache of exact DES outcomes keyed by
  ``(gear signature, qps, horizon, backlog, full SimConfig, placement)``.
  Stored on ``PlannerState`` so warm-started re-plans reuse prior DES
  results verbatim; guarded by a profile digest so calibration or profile
  changes can never serve stale results.
* ``cascade_throughputs`` — SP1's analytic throughput estimate for ALL
  candidate cascades in one vectorized pass (bit-identical floats to the
  per-cascade loop it replaces).
* ``model_capacities``    — per-model replica capacity (the SP3/SP4
  bottleneck check), computed once per placement and shared.

The estimator is deliberately *optimistic* (never reports a config as worse
than the DES would): a too-optimistic verdict is caught when the converged
plan is certified range-by-range by the exact simulator (core/planner.py),
while a pessimistic one could silently steer the search to a different —
never-DES-checked — fixed point. Certified DES outcomes live in the memo and
always override the estimate, so the planner's *fixed point* satisfies the
same DES invariants as the pre-fast-path search.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cascade import Cascade, CascadeEval
from repro_torch.core.gears import Gear
from repro_torch.core.lp import Replica
from repro_torch.core.profiles import ProfileSet, profile_digest
from repro_torch.core.simulator import SimConfig

__all__ = ["MAX_MIN_QUEUE", "FastEval", "FastEvaluator", "SimOutcome",
           "SimMemo", "sim_memo_key", "trigger_ladder", "trim_memo",
           "cascade_throughputs", "model_capacities", "bottleneck_model"]

MAX_MIN_QUEUE = 128

# minimum demand level the steady-state model still calls stable. The DES's
# finite-horizon criterion (SimResult.stable) tolerates a bounded backlog —
# max(64, 5% of offered) — so the per-run cap is 1/(1 - slack), floored
# here: borderline configs must stay optimistic and be settled by the exact
# simulator, not by the estimate.
UTIL_STABLE = 1.06
# cap for the *initial guess* of the trigger search: deliberately generous
# (optimistic) — a guess the DES rejects walks up cheaply, whereas a
# pessimistic overshoot is only unwound by certification restarts.
UTIL_GUESS = 1.15


def trigger_ladder(max_min_queue: int = MAX_MIN_QUEUE) -> List[int]:
    """The exact min-queue growth schedule of the pre-fast-path SP4 loop:
    ``mq <- min(cap, max(mq + 1, int(mq * 1.5)))`` starting from 1."""
    out = [1]
    while out[-1] < max_min_queue:
        b = out[-1]
        out.append(min(max_min_queue, max(b + 1, int(b * 1.5))))
    return out


# ---------------------------------------------------------------------------
# Exact-DES memo cache
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SimOutcome:
    """The planner-relevant slice of one exact ``SimResult``."""
    stable: bool
    p95: float
    throughput: float = 0.0
    completed: int = 0


def sim_memo_key(gear: Gear, qps: float, horizon: float, backlog: int,
                 cfg: SimConfig, replicas: Sequence[Replica],
                 num_devices: int) -> Tuple:
    """Everything an exact ``run_fixed`` outcome depends on. The FULL
    ``SimConfig`` (a frozen dataclass) is part of the key, so any
    calibration change — dispatch overhead, max-wait, hysteresis, seed —
    invalidates the cache instead of serving stale results."""
    return (
        gear.cascade.models,
        gear.cascade.thresholds,
        tuple(sorted(gear.min_queue_lens.items())),
        tuple(sorted((m, tuple(sorted(d.items())))
                     for m, d in gear.load_fractions.items())),
        float(qps), float(horizon), int(backlog),
        cfg,
        tuple((r.model, r.device) for r in replicas),
        int(num_devices),
    )


class SimMemo:
    """DES-outcome cache living on ``PlannerState``; carried across
    warm-started re-plans at per-model granularity.

    Bounded: ``BackgroundReplanner`` chains warm states indefinitely, and
    every drift event introduces fresh qps/placement keys — without a cap
    the serving process the re-planner protects would leak planner cache
    forever. A single plan needs a few hundred entries; when the cap is
    hit the oldest quarter (insertion order) is evicted."""

    MAX_ENTRIES = 8192

    def __init__(self):
        # per-model profile digests: a cached outcome depends on exactly
        # the profiles of the models its gear touches (runtime curves +
        # validation replay), nothing else outside its key
        self.model_digests: Dict[str, str] = {}
        self._d: Dict[Tuple, SimOutcome] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: Tuple) -> Optional[SimOutcome]:
        out = self._d.get(key)
        if out is not None:
            self.hits += 1
        return out

    def peek(self, key: Tuple) -> Optional[SimOutcome]:
        """Speculative lookup that does NOT count as a cache hit — the
        hits/misses counters mean 'DES runs avoided/performed' and are
        reported by bench_planner."""
        return self._d.get(key)

    def put(self, key: Tuple, outcome: SimOutcome) -> None:
        self.misses += 1
        if len(self._d) >= self.MAX_ENTRIES:
            for old in list(self._d)[:self.MAX_ENTRIES // 4]:
                del self._d[old]
        self._d[key] = outcome

    def set_profiles(self, profiles: ProfileSet) -> None:
        self.model_digests = {m: profile_digest({m: p})
                              for m, p in profiles.items()}

    def carry_from(self, other: Optional["SimMemo"],
                   profiles: ProfileSet) -> None:
        """Warm start: adopt another memo's entries whose models all carry
        unchanged profiles (a pinned re-plan may see a *subset* of the
        original profile set; entries over re-profiled or dropped models
        are never served)."""
        if not self.model_digests:
            self.set_profiles(profiles)
        if other is None:
            return
        mine, theirs = self.model_digests, other.model_digests
        for key, out in other._d.items():
            if all(m in mine and mine[m] == theirs.get(m)
                   for m in key[0]):
                self._d[key] = out
        trim_memo(self._d, self.MAX_ENTRIES)


def trim_memo(d: Dict, cap: int) -> None:
    """Drop the oldest entries (insertion order) down to ``cap``."""
    if len(d) > cap:
        for old in list(d)[:len(d) - cap]:
            del d[old]


class CountingMemo(dict):
    """A plain dict that counts lookup hits/misses, for the lp/placement
    memos on ``PlannerState``. Both access idioms the submodules use are
    counted: ``memo.get(key)`` (lp_memo) and ``key in memo`` followed by
    ``memo[key]`` (place_memo) — ``__getitem__`` itself is deliberately
    NOT counted so the contains-then-index pattern registers one lookup,
    not two. Reported via ``PlannerReport.memo_stats`` and printed by
    ``launch/dryrun.py --plan-check``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        out = super().get(key, _MISS)
        if out is _MISS:
            self.misses += 1
            return default
        self.hits += 1
        return out

    def __contains__(self, key) -> bool:
        ok = super().__contains__(key)
        if ok:
            self.hits += 1
        else:
            self.misses += 1
        return ok


_MISS = object()


# ---------------------------------------------------------------------------
# Vectorized steady-state evaluation
# ---------------------------------------------------------------------------

@dataclass
class FastEval:
    """Estimates for one trigger ladder (arrays aligned with ``triggers``)."""
    triggers: np.ndarray      # (T,) first-model min-queue-lengths evaluated
    stable: np.ndarray        # (T,) bool — steady-state utilisation verdict
    util: np.ndarray          # (T,) max per-device utilisation
    p95: np.ndarray           # (T,) closed-form latency estimate, seconds
    accuracy: float           # exact (validation-replay) cascade accuracy


class FastEvaluator:
    """Vectorized steady-state scorer over one ``ProfileSet``.

    Stateless w.r.t. placement: the placement, load fractions, and QPS are
    call arguments, so one evaluator serves every SP3 re-placement within a
    planner run (it is cached on ``PlannerState`` per profile set).
    """

    def __init__(self, profiles: ProfileSet):
        self.profiles = profiles
        # per-model interpolation grids, pulled out of ModelProfile once
        self._grid: Dict[str, Tuple[np.ndarray, np.ndarray, float]] = {}
        for m, p in profiles.items():
            bs, rt = p.batch_sizes, p.batch_runtimes
            if len(bs) >= 2:
                slope = (rt[-1] - rt[-2]) / max(bs[-1] - bs[-2], 1e-9)
            else:
                slope = rt[-1] / bs[-1]
            self._grid[m] = (bs, rt, float(slope))

    # ------------------------------------------------------------ runtimes
    def batch_runtimes(self, model: str, batches: np.ndarray) -> np.ndarray:
        """``ModelProfile.runtime`` over an array of batch sizes (same
        linear interp + marginal-cost extrapolation, one ``np.interp``)."""
        bs, rt, slope = self._grid[model]
        b = np.asarray(batches, np.float64)
        mid = np.interp(b, bs, rt)
        lo = rt[0] * b / bs[0] if bs[0] > 0 else np.full_like(b, rt[0])
        hi = rt[-1] + slope * (b - bs[-1])
        return np.where(b <= bs[0], lo, np.where(b >= bs[-1], hi, mid))

    # ------------------------------------------------------------- ladder
    def evaluate_ladder(self, cascade: Cascade, ev: CascadeEval,
                        load_fracs: Dict[str, Dict[int, float]],
                        replicas: Sequence[Replica], num_devices: int,
                        qps: float, cfg: SimConfig,
                        triggers: Sequence[int],
                        offered: Optional[float] = None) -> FastEval:
        """Score every first-model trigger in ``triggers`` at once.

        Steady-state model of the DES: replicas co-located on a device are
        served in an alternating cycle of length ``T = Σ (R(b_j) + ovh)``,
        and each replica's batch is whatever accumulated since its last
        service — ``b_j = λ_j·T`` — floored by its firing condition: the
        trigger (capped by the head-of-line timeout fill) on the first
        model, the forwarded chunk size downstream (cascaded samples arrive
        in first-batch-sized chunks, which is why the first model's trigger
        drives the whole cascade's batching, §4.5). The joint fixed point
        is iterated for all triggers at once; one vectorized ``np.interp``
        per model supplies all runtimes. A config is stable when every
        device's demand ``Σ λ·(R(b)+ovh)/b`` stays within the DES's
        lenient finite-horizon criterion (``offered`` sets the leniency;
        at the interior fixed point demand is exactly 1).
        """
        trig = np.asarray(triggers, np.float64)
        n_t = len(trig)

        # flatten (stage, replica) slots, ordered by (device, replica
        # index): the DES's consumer scan (``try_start`` over
        # ``reps_on_dev``) serves co-located replicas in replica-index
        # order, so earlier slots get first claim on the device and later
        # ones the residual share
        slot_model: List[str] = []
        slot_dev: List[int] = []
        slot_lam: List[float] = []
        slot_first: List[bool] = []
        slot_stage: List[int] = []
        frac0 = max(ev.fractions[0], 1e-9)
        per_slot = []
        for i, (m, frac) in enumerate(zip(cascade.models, ev.fractions)):
            lam_m = frac * qps
            for ridx, w in (load_fracs.get(m) or {}).items():
                if w <= 0.0 or lam_m <= 0.0:
                    continue
                per_slot.append((replicas[ridx].device, ridx, m,
                                 w * lam_m, i == 0, i))
        for d, ridx, m, lam_j, is_first, stage in sorted(per_slot):
            slot_model.append(m)
            slot_dev.append(d)
            slot_lam.append(lam_j)
            slot_first.append(is_first)
            slot_stage.append(stage)
        if not slot_model:
            return FastEval(triggers=trig,
                            stable=np.ones(n_t, bool),
                            util=np.zeros(n_t),
                            p95=np.zeros(n_t), accuracy=ev.accuracy)

        n_s = len(slot_model)
        lam = np.asarray(slot_lam)[:, None]                 # (S, 1)
        first = np.asarray(slot_first)[:, None]
        dev = np.asarray(slot_dev)
        # first-model firing floor: trigger fill, capped by what the
        # head-of-line timeout lets accumulate
        timeout_b = np.floor(lam * cfg.max_wait) + 1.0
        fill = np.minimum(np.where(first, trig[None, :], 1.0), timeout_b)
        fill = np.clip(fill, 1.0, cfg.max_batch)
        b = fill.copy()

        models = np.asarray(slot_model)
        uniq = sorted(set(slot_model))
        rows_of = {m: np.where(models == m)[0] for m in uniq}

        def runtimes_for(b_arr: np.ndarray) -> np.ndarray:
            rt = np.empty_like(b_arr)
            for m in uniq:
                rows = rows_of[m]
                rt[rows] = self.batch_runtimes(m, b_arr[rows])
            return rt

        first_rows = np.where(np.asarray(slot_first))[0]
        lam_first = float(lam[first_rows].sum()) or 1e-9
        ovh = cfg.dispatch_overhead

        # joint fixed point, priority-ordered within each device: slot j
        # runs a self-cycle inside its residual share s_j of the device —
        # ``b_j = max(floor_j, λ_j · (R_j(b_j)+ovh) / s_j)`` — where the
        # floor is the trigger fill (first model) or the forwarded chunk
        # (downstream). The outer loop re-derives shares from demand.
        rt = runtimes_for(b) + ovh
        f = np.minimum(lam * rt / b, 1.0)                   # (S, T) demand
        for _ in range(12):
            # chunk floor: the average first-stage batch forwards
            # stage-i work in chunks of b_first * (λ_slot / λ_first)
            b_first = (lam[first_rows] * b[first_rows]).sum(axis=0) \
                / lam_first                                  # (T,)
            chunk = 0.5 * b_first[None, :] * lam / (frac0 * qps)
            floor = np.where(first, fill, np.clip(chunk, 1.0,
                                                  cfg.max_batch))
            share = np.ones((num_devices, n_t))
            b_new = np.empty_like(b)
            for j in range(n_s):                 # priority order per device
                s_j = np.maximum(share[dev[j]], 0.02)
                b_new[j] = np.clip(
                    np.maximum(floor[j], lam[j] * rt[j] / s_j),
                    1.0, cfg.max_batch)
                share[dev[j]] = share[dev[j]] - f[j]
            b = 0.5 * b + 0.5 * b_new                        # damped
            rt = runtimes_for(b) + ovh
            f = lam * rt / b
        # per-device demand: batches of size b every b/λ seconds
        util = np.zeros((num_devices, n_t))
        np.add.at(util, dev, f)
        max_util = util.max(axis=0)

        # stability: the DES's finite-horizon criterion tolerates a
        # bounded backlog (max(64, 5% of offered)), i.e. ~5% overload on
        # large runs and far more on small ones
        if offered is None:
            offered = 2.0 * qps
        slack = max(64.0 / max(offered, 1.0), 0.05)
        util_cap = max(1.02 / max(1.0 - slack, 0.2), UTIL_STABLE)
        stable = max_util <= util_cap

        # closed-form p95: per-stage latency = fill wait + service, stage
        # latencies accumulated until >= 95% of samples have resolved
        # (resolve fractions are exact, from the validation replay). A mild
        # congestion factor keeps the estimate ordered in utilisation
        # without ever out-pessimising the DES near saturation.
        wait = np.minimum(cfg.max_wait,
                          np.maximum(b - 1.0, 0.0) / np.maximum(lam, 1e-9))
        stage_lat = np.zeros((len(cascade.models), n_t))
        stage_w = np.zeros((len(cascade.models), n_t))
        lat = (wait + rt) * lam
        np.add.at(stage_lat, np.asarray(slot_stage), lat)
        np.add.at(stage_w, np.asarray(slot_stage), np.broadcast_to(
            lam, lat.shape))
        stage_lat = stage_lat / np.maximum(stage_w, 1e-12)

        frs = list(ev.fractions) + [0.0]
        cum = np.zeros(n_t)
        p95 = np.zeros(n_t)
        done = np.zeros(n_t, bool)
        for i in range(len(cascade.models)):
            cum = cum + stage_lat[i]
            newly = ~done & ((1.0 - frs[i + 1]) >= 0.95)
            p95 = np.where(newly | (~done & (i == len(cascade.models) - 1)),
                           cum, p95)
            done |= newly
        congest = 1.0 / np.maximum(1.0 - np.minimum(max_util, 0.90), 0.10)
        p95 = p95 * np.maximum(congest, 1.0) ** 0.5

        return FastEval(triggers=trig, stable=stable, util=max_util,
                        p95=p95, accuracy=ev.accuracy)


# ---------------------------------------------------------------------------
# Vectorized SP1 throughput + SP3/SP4 bottleneck capacity
# ---------------------------------------------------------------------------

def cascade_throughputs(profiles: ProfileSet, num_devices: int,
                        cascades: Sequence[Cascade],
                        evals: Sequence[CascadeEval]) -> List[float]:
    """Analytic sustainable-QPS upper bound for EVERY candidate cascade in
    one vectorized pass — bit-identical to the per-cascade loop
    (``submodules.cascade_search.estimate_throughput``): the accumulation
    ``cost += (frac * runtime(b_max)) / b_max`` runs stage by stage with
    the same operation order, only batched across cascades."""
    n = len(cascades)
    if n == 0:
        return []
    rt_last = {m: p.batch_runtimes[-1] for m, p in profiles.items()}
    b_last = {m: p.batch_sizes[-1] for m, p in profiles.items()}
    costs = np.zeros(n)
    max_len = max(len(c.models) for c in cascades)
    for stage in range(max_len):
        idx = [i for i, c in enumerate(cascades) if len(c.models) > stage]
        if not idx:
            break
        rt = np.asarray([rt_last[cascades[i].models[stage]] for i in idx])
        bb = np.asarray([b_last[cascades[i].models[stage]] for i in idx])
        fr = np.asarray([evals[i].fractions[stage] for i in idx])
        costs[idx] += (fr * rt) / bb
    return [float("inf") if c <= 0 else num_devices / c for c in costs]


def model_capacities(replicas: Sequence[Replica]) -> Dict[str, float]:
    """Aggregate replica capacity per model (the SP3/SP4 bottleneck check):
    ``Σ 1/runtime_per_sample`` accumulated in replica order, exactly as the
    per-call loop it replaces. Computed once per placement and shared."""
    caps: Dict[str, float] = {}
    for rep in replicas:
        caps[rep.model] = caps.get(rep.model, 0.0) \
            + 1.0 / rep.runtime_per_sample
    return caps


def bottleneck_model(need: Dict[str, float],
                     caps: Dict[str, float]) -> Optional[str]:
    """Model with the highest demand/capacity pressure (first wins ties,
    matching the strict ``>`` scan it replaces)."""
    worst, worst_m = -np.inf, None
    for m, q in need.items():
        pressure = q / (caps.get(m, 0.0) or 1e-9)
        if pressure > worst:
            worst, worst_m = pressure, m
    return worst_m
