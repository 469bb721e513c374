"""Verbatim copy of ``repro/core/vecsim.py``,
imports rewritten to ``repro_torch``.

Lane-batched discrete-event engine + Monte-Carlo plan certification.

``VecSim`` advances ``B`` independent simulation *lanes* — same plan,
different routing seeds and/or QPS scenarios — through one shared macro-step
loop. The scalar ``ServingSimulator`` (core/simulator.py) remains the
correctness oracle: a single-lane VecSim run is decision-trace bit-identical
to it on the behavior-fingerprint scenarios (tests/test_vecsim.py), the same
way the fast planner evaluator was pinned (DESIGN.md §10, §12).

Where the scalar driver keeps ONE global event heap and pays Python
interpreter cost per event, VecSim splits the event population by how it can
be processed in bulk (DESIGN.md §12):

* **arrivals** — the shared per-lane arrival arrays come from the already-
  vectorized ``trace_to_arrivals``; within a provably fire-free window
  (every first-model device busy through the window, or queues bounded
  below their triggers) a whole *run* of consecutive arrivals is routed in
  one masked ``searchsorted`` over the gear's cumulative load-fraction
  table and appended to the per-lane ring buffers in one slice per replica.
* **completions** — at most one live batch per (lane, device); the next
  completion is a reduction over a dense ``comp_t`` array. Per-sample
  cascade continuation is one vectorized threshold compare; forwards whose
  target devices are all busy are enqueued in bulk.
* **head-of-line timeouts** — per-(lane, replica) rings, sorted by
  construction (every push is ``now + max_wait`` with non-decreasing
  ``now``); timeouts that provably cannot fire (their replica's device is
  busy until a completion scheduled after them) are dropped in bulk.
* **rare events** — device failures, hedges, stale completions from killed
  devices, and the one out-of-order timeout the hedge path emits go to a
  per-lane overflow heap, processed exactly like the scalar driver.

Per-lane ``seq`` counters are assigned at push in the same order as the
scalar driver assigns its heap sequence numbers, and the next event is the
lexicographic ``(time, seq)`` minimum over all stores — so tie-breaking,
and therefore every downstream decision, is bit-identical.

On top of the engine, ``mc_certify_ranges`` scores each QPS range of a
converged plan over many routing seeds in one lane-batched call and returns
per-range p95 **distributions** (mean, 95% CI) instead of the single-seed
point estimate — the Monte-Carlo arm of the planner's certification
(core/submodules/batching.py), recorded into ``PlanProvenance.mc_p95``.
"""
from __future__ import annotations

import heapq
import math
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.execution import ExecutionBackend, ReplayBackend
from repro_torch.core.gears import Gear, GearPlan
from repro_torch.core.lp import Replica
from repro_torch.core.profiles import ProfileSet
from repro_torch.core.scheduling import (DecisionTrace, SchedulerCore, is_ensemble,
                                   majority_vote, plan_target,
                                   with_hysteresis)
from repro_torch.core.simulator import (DeviceEvent, SimConfig, SimResult,
                                  _ArrayQueue, validate_device_events)

__all__ = ["VecSim", "LaneResult", "mc_summary"]

# arrival-run fast path: cap on arrivals committed per quantum (bounds the
# temporary arrays; the run simply continues at the next quantum)
_MAX_RUN = 4096
# below this many samples, masked numpy costs more than a plain loop (same
# trade as execution.py's _BATCH_GATHER_MIN)
_MIN_VEC = 24


class _LanePool:
    """One lane's routing-uniform pool. Identical construction and wrap
    semantics to ``RoutePool.for_arrivals`` (scheduling.py), plus a bulk
    slice draw for the vectorized arrival path."""

    __slots__ = ("arr", "lst", "ptr", "n")

    def __init__(self, seed: int, n_arrivals: int):
        size = n_arrivals * 4 + 16
        self.arr = np.random.default_rng(seed).random(max(size, 1))
        self.lst = self.arr.tolist()
        self.n = len(self.lst)
        self.ptr = 0

    def next(self) -> float:
        ptr = self.ptr
        if ptr >= self.n:
            ptr = ptr % self.n
        self.ptr = ptr + 1
        return self.lst[ptr]

    def peek_block(self, k: int) -> np.ndarray:
        """The next ``k`` draws WITHOUT consuming them (the arrival run
        decides how many to commit after seeing where they route)."""
        ptr = self.ptr
        if ptr >= self.n:        # same wrap-at-read as the scalar next()
            ptr %= self.n
        end = ptr + k
        if end <= self.n:        # common case: a contiguous view, no copy
            return self.arr[ptr:end]
        idx = (ptr + np.arange(k, dtype=np.int64)) % self.n
        return self.arr[idx]

    def commit(self, k: int) -> None:
        self.ptr = (self.ptr + k) % self.n


class _Lane:
    """All mutable state of one simulation lane (the scalar driver's locals,
    minus what is shared across lanes)."""

    __slots__ = (
        "qs", "to_t", "to_seq", "to_head", "to_cand", "comp_t", "comp_seq",
        "comp_payload", "rare", "seq", "pool", "arr_ptr", "meas_end",
        "meas_count", "cur_gear", "gears", "dev_idle", "dev_alive",
        "dev_speed", "dev_busy", "dev_epoch", "dev_draining", "revoked",
        "shed", "net", "hedge_used", "hedged_to", "complete", "correct",
        "resolver", "cur_stage", "gear_of", "votes", "switches",
        "per_model_batches", "per_model_samples", "trace", "active",
        "ck", "simple", "single_gear", "traw")

    def __init__(self, n_rep: int, n_dev: int, n_arr: int, seed: int,
                 gears: List[Gear], measure_interval: float,
                 trace: Optional[DecisionTrace]):
        self.qs = [_ArrayQueue() for _ in range(n_rep)]
        self.to_t: List[List[float]] = [[] for _ in range(n_rep)]
        self.to_seq: List[List[int]] = [[] for _ in range(n_rep)]
        self.to_head = [0] * n_rep
        # lazy heap of ring-head candidates (t, seq, ridx): every ring push
        # happens at the current event time + max_wait with nondecreasing
        # event time, so a ring's head can only be displaced by consumption
        # — one candidate per nonempty ring suffices, validated at peek
        self.to_cand: List[Tuple[float, int, int]] = []
        inf = math.inf
        self.comp_t = [inf] * n_dev
        self.comp_seq = [0] * n_dev
        self.comp_payload: List[Optional[tuple]] = [None] * n_dev
        self.rare: List[tuple] = []   # (t, seq, kind, payload) heap
        self.seq = 0
        self.pool = _LanePool(seed, n_arr)
        self.arr_ptr = 0
        self.meas_end = measure_interval
        self.meas_count = 0
        self.cur_gear = 0
        self.gears = list(gears)
        self.dev_idle = [True] * n_dev
        self.dev_alive = [True] * n_dev
        self.dev_speed = [1.0] * n_dev
        self.dev_busy = [0.0] * n_dev
        self.dev_epoch = [0] * n_dev
        self.dev_draining = [False] * n_dev
        # epochs ended by a spot revoke (dev -> set of epochs): in-flight
        # batches carrying them are shed, not re-issued
        self.revoked: Dict[int, set] = {}
        self.shed = 0
        self.net = 1.0                 # fleet-wide "netdeg" multiplier
        self.hedge_used: Dict[int, int] = {}
        self.hedged_to: Dict[int, int] = {}
        self.complete = np.full(n_arr, math.nan)
        self.correct = np.zeros(n_arr, bool)
        self.resolver = np.full(n_arr, -1, np.int32)
        self.cur_stage = np.zeros(n_arr, np.int64)
        self.gear_of: List[Optional[Gear]] = [None] * n_arr
        self.votes: Dict[int, List[int]] = {}
        self.switches: List[Tuple[float, int]] = []
        self.per_model_batches: Dict[str, int] = {}
        self.per_model_samples: Dict[str, int] = {}
        self.trace = trace
        self.active = True
        self.ck = True        # correctness_known
        # simple := no hedging and no device events. Only then are the bulk
        # fast paths provably equivalent: without failures a busy device
        # stays busy until its completion (timeouts before it are no-ops,
        # safe to drop) and a batch can never contain the same sample twice
        # (hedge/re-issue duplicates), so masked completion is exact.
        self.simple = True
        self.single_gear = len(gears) == 1
        # telemetry raw-log append, bound on lane 0 of an observed run
        # (None everywhere else): hot hooks are one `is not None` test
        self.traw = None


class LaneResult:
    """Per-lane p95 summary of one lane-batched certification run."""

    __slots__ = ("seeds", "p95s", "stable")

    def __init__(self, seeds: Sequence[int], p95s: Sequence[float],
                 stable: Sequence[bool]):
        self.seeds = list(seeds)
        self.p95s = list(p95s)
        self.stable = list(stable)

    def mean_ci(self) -> Tuple[float, float]:
        return mc_summary(self.p95s)


def mc_summary(p95s: Sequence[float]) -> Tuple[float, float]:
    """(mean, 95% CI half-width) of a p95 sample; inf-safe (an unstable
    lane's infinite p95 makes the whole verdict infinite, deliberately)."""
    a = np.asarray(p95s, np.float64)
    if not len(a):
        return math.inf, 0.0
    if not np.isfinite(a).all():
        return math.inf, math.inf
    mean = float(a.mean())
    if len(a) < 2:
        return mean, 0.0
    ci = 1.96 * float(a.std(ddof=1)) / math.sqrt(len(a))
    return mean, ci


class VecSim:
    """Lane-batched drop-in for the scalar simulator's planner-facing runs.

    Shares everything shareable across lanes: the execution backend (and
    its runtime-interpolation memo), per-(gear, model) routing tables, the
    per-(model, batch) runtime memo, and the arrival arrays.
    """

    def __init__(self, profiles: ProfileSet, replicas: Sequence[Replica],
                 num_devices: int, cfg: SimConfig = SimConfig(),
                 backend: Optional[ExecutionBackend] = None,
                 telemetry=None):
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        # pure observer (core/telemetry.py): recorded on lane 0 only —
        # multi-lane runs would interleave unrelated sample ids
        self.telemetry = telemetry
        self.profiles = profiles
        self.replicas = list(replicas)
        self.num_devices = num_devices
        self.cfg = cfg
        self.backend = backend or ReplayBackend(profiles)
        self.reps_of: Dict[str, List[int]] = {}
        self.reps_on_dev: Dict[int, List[int]] = {}
        for i, r in enumerate(self.replicas):
            self.reps_of.setdefault(r.model, []).append(i)
            self.reps_on_dev.setdefault(r.device, []).append(i)
        # exact timeout comparison (no epsilon fudge): the elapsed-wait
        # checks below snap to the scheduled deadline float head_t + mw,
        # mirroring scheduling.head_of_line_wait
        self._fire_wait = cfg.max_wait
        self._rep_dev = [r.device for r in self.replicas]
        self._rt_memo: Dict[Tuple[str, int], float] = {}
        # (id(gear), model) -> (gear, cum np, ridx np, fallback, scan list)
        self._route_memo: Dict[Tuple[int, str], tuple] = {}
        # id(gear) -> (gear, thresholds np, models tuple)
        self._hop_memo: Dict[int, tuple] = {}
        self._ens_memo: Dict[int, Tuple[Gear, bool]] = {}
        # id(gear) -> (gear, resolve_stage, correct) precomputed cascade
        # outcome per sample id — valid because the backend's per-sample
        # certainty is a pure function of (model, sid), so a sample's full
        # cascade path under a gear is fixed before the run starts
        self._resolve_memo: Dict[int, tuple] = {}

    # ------------------------------------------------------------------ API
    def run_fixed_lanes(self, gear: Gear, qps: float, horizon: float = 2.0,
                        warm_start_backlog: int = 0,
                        seeds: Sequence[int] = (0,),
                        decision_traces: Optional[
                            List[Optional[DecisionTrace]]] = None
                        ) -> List[SimResult]:
        """``run_fixed`` over B routing-seed lanes in one lane-batched pass.

        Lane ``i`` is bit-identical to
        ``ServingSimulator(cfg=replace(cfg, seed=seeds[i])).run_fixed(...)``.
        """
        if qps < 0:
            raise ValueError(f"qps must be >= 0, got {qps}")
        if horizon <= 0:
            raise ValueError(f"horizon must be positive, got {horizon}")
        if warm_start_backlog < 0:
            raise ValueError(f"warm_start_backlog must be >= 0, got "
                             f"{warm_start_backlog}")
        if not seeds:
            raise ValueError("at least one lane seed is required")
        n = int(qps * horizon)
        arrivals = (np.arange(n) + 0.5) / max(qps, 1e-9)
        if warm_start_backlog:
            arrivals = np.concatenate(
                [np.zeros(warm_start_backlog), arrivals])
        return self._run_lanes(arrivals, [gear],
                               selector=None, horizon=horizon, seeds=seeds,
                               decision_traces=decision_traces,
                               measure=False)

    def run_fixed(self, gear: Gear, qps: float, horizon: float = 2.0,
                  warm_start_backlog: int = 0,
                  decision_trace: Optional[DecisionTrace] = None
                  ) -> SimResult:
        return self.run_fixed_lanes(
            gear, qps, horizon, warm_start_backlog, seeds=(self.cfg.seed,),
            decision_traces=[decision_trace])[0]

    def run_trace(self, plan: GearPlan,
                  qps_per_sec: Optional[np.ndarray] = None,
                  drain: float = 2.0,
                  device_events: Optional[List[DeviceEvent]] = None,
                  hedge=None,
                  decision_trace: Optional[DecisionTrace] = None,
                  on_failure=None, scenario=None) -> SimResult:
        """Single-lane trace replay with the §5 producer policy — the
        equivalence surface against ``ServingSimulator.run_trace``.

        ``scenario`` (a ``repro.core.scenarios.Scenario``) supplies trace,
        device events, and drain in one object, mutually exclusive with
        explicit ``qps_per_sec``/``device_events``. ``on_failure(t, dev)``
        mirrors the scalar driver's survivor-plan callback (invoked at
        drain notices and failures; may return a replacement gear list)."""
        from repro_torch.core.simulator import trace_to_arrivals
        if scenario is not None:
            if qps_per_sec is not None or device_events is not None:
                raise ValueError(
                    "pass either scenario= or explicit qps_per_sec/"
                    "device_events, not both")
            qps_per_sec = scenario.qps()
            device_events = scenario.device_events()
            drain = scenario.drain
        if qps_per_sec is None or not len(qps_per_sec):
            raise ValueError("cannot replay an empty QPS trace")
        if drain < 0:
            raise ValueError(f"drain must be >= 0, got {drain}")
        arrivals = trace_to_arrivals(qps_per_sec)
        horizon = float(len(qps_per_sec)) + drain
        selector = with_hysteresis(plan_target(plan), self.cfg.alpha)
        return self._run_lanes(arrivals, plan.gears, selector=selector,
                               horizon=horizon, seeds=(self.cfg.seed,),
                               decision_traces=[decision_trace],
                               measure=True, device_events=device_events,
                               hedge=hedge, on_failure=on_failure)[0]

    # --------------------------------------------------------- shared tables
    def _route_table(self, gear: Gear, model: str) -> tuple:
        ent = self._route_memo.get((id(gear), model))
        if ent is None or ent[0] is not gear:
            fracs = gear.load_fractions.get(model)
            idxs = self.reps_of.get(model, [])
            if not idxs:
                raise RuntimeError(f"no replica for model {model}")
            if not fracs:
                ent = (gear, None, np.asarray(idxs, np.int64), idxs, None)
            else:
                # same accumulation as SchedulerCore.route, element-wise:
                # cum is non-decreasing, so searchsorted(left) reproduces
                # the first-``u <= acc`` scan bit for bit
                cum, ridxs, acc = [], [], 0.0
                for rj, frac in fracs.items():
                    acc += frac
                    cum.append(acc + 1e-12)
                    ridxs.append(rj)
                ent = (gear, np.asarray(cum), np.asarray(ridxs, np.int64),
                       next(iter(fracs)), list(zip(cum, ridxs)))
            self._route_memo[(id(gear), model)] = ent
        return ent

    def _route_one(self, lane: _Lane, model: str, gear: Gear,
                   u: float) -> int:
        ent = self._route_table(gear, model)
        if ent[1] is None:
            idxs = ent[3]
            ridx = idxs[int(u * len(idxs)) % len(idxs)]
        else:
            ridx = ent[3]
            for acc, rj in ent[4]:
                if u <= acc:
                    ridx = rj
                    break
        if lane.trace is not None:
            lane.trace.routes.append((model, ridx))
        return ridx

    def _route_block(self, lane: _Lane, model: str, gear: Gear,
                     us: np.ndarray) -> np.ndarray:
        ent = self._route_table(gear, model)
        if ent[1] is None:
            idxs = ent[2]
            ridx = idxs[(us * len(idxs)).astype(np.int64) % len(idxs)]
        else:
            pos = np.searchsorted(ent[1], us, side="left")
            over = pos >= len(ent[2])        # u beyond all: first-key fall
            pos[over] = 0
            ridx = ent[2][pos]
            if over.any():
                ridx = np.where(over, ent[3], ridx)
        if lane.trace is not None:
            lane.trace.routes.extend((model, int(r)) for r in ridx)
        return ridx

    def _hop_table(self, gear: Gear) -> tuple:
        ent = self._hop_memo.get(id(gear))
        if ent is None or ent[0] is not gear:
            casc = gear.cascade
            ent = (gear, np.asarray(casc.thresholds, np.float64),
                   casc.models)
            self._hop_memo[id(gear)] = ent
        return ent

    def _gear_is_ensemble(self, g: Gear) -> bool:
        ent = self._ens_memo.get(id(g))
        if ent is None or ent[0] is not g:
            ent = (g, is_ensemble(g))
            self._ens_memo[id(g)] = ent
        return ent[1]

    def _runtime(self, model: str, bsz: int) -> float:
        rt = self._rt_memo.get((model, bsz))
        if rt is None:
            rt = self.backend.batch_runtime(model, bsz) \
                + self.cfg.dispatch_overhead
            self._rt_memo[(model, bsz)] = rt
        return rt

    # ------------------------------------------------------------ the engine
    def _run_lanes(self, arrivals: np.ndarray, gears: List[Gear],
                   selector, horizon: float, seeds: Sequence[int],
                   decision_traces=None, measure: bool = True,
                   device_events: Optional[List[DeviceEvent]] = None,
                   hedge=None, on_failure=None) -> List[SimResult]:
        cfg = self.cfg
        n_arr = len(arrivals)
        arrive = np.asarray(arrivals, np.float64)
        arrive_l = arrive.tolist()
        core = SchedulerCore(self.replicas, cfg, selector=selector)
        traces = decision_traces or [None] * len(seeds)
        if len(traces) != len(seeds):
            raise ValueError("decision_traces must align with seeds")

        device_events = validate_device_events(device_events,
                                               self.num_devices)
        simple = hedge is None and not device_events
        lanes = []
        for seed, trace in zip(seeds, traces):
            lane = _Lane(len(self.replicas), self.num_devices, n_arr, seed,
                         gears, cfg.measure_interval, trace)
            lane.simple = simple
            if self.telemetry is not None and not lanes:
                lane.traw = self.telemetry.raw.append
            for ev_t, ev_d, ev_kind, ev_f in device_events:
                heapq.heappush(lane.rare,
                               (ev_t, lane.seq, "devevent",
                                (ev_d, ev_kind, ev_f)))
                lane.seq += 1
            lanes.append(lane)

        active = list(lanes)
        while active:
            nxt = []
            for lane in active:
                if self._quantum(lane, core, arrive, arrive_l, horizon,
                                 measure, hedge, on_failure):
                    nxt.append(lane)
            active = nxt

        return [self._result(lane, arrive, n_arr, horizon)
                for lane in lanes]

    # ------------------------------------------------------- event selection
    def _next_timeout(self, lane: _Lane) -> Tuple[float, int, int]:
        """(t, seq, ridx) of the earliest pending timeout — a validated
        peek at the lazy candidate heap. Stale candidates (their ring head
        moved on) are replaced by the true head; heads that provably cannot
        fire are bulk-dropped: a timeout strictly before its replica's busy
        device completes is a no-op (``try_start`` returns on the busy
        check) — dead devices are exempt, their queues are revived by
        timeouts after recovery."""
        cand = lane.to_cand
        rep_dev = self._rep_dev
        to_t, to_seq, to_head = lane.to_t, lane.to_seq, lane.to_head
        dev_idle, dev_alive, comp_t = \
            lane.dev_idle, lane.dev_alive, lane.comp_t
        simple = lane.simple
        while cand:
            t, seq, r = cand[0]
            ts = to_t[r]
            h = to_head[r]
            n = len(ts)
            if h >= n:                    # ring drained since queued
                heapq.heappop(cand)
                continue
            seqs = to_seq[r]
            if ts[h] != t or seqs[h] != seq:
                # superseded: re-anchor the candidate at the true head
                heapq.heapreplace(cand, (ts[h], seqs[h], r))
                continue
            dev = rep_dev[r]
            if simple and not dev_idle[dev] and dev_alive[dev]:
                ct = comp_t[dev]
                if t < ct:                # droppable no-op prefix
                    while h < n and ts[h] < ct:
                        h += 1
                    if h >= n:            # fully drained: free the ring
                        to_t[r] = []
                        to_seq[r] = []
                        to_head[r] = 0
                        heapq.heappop(cand)
                    else:
                        to_head[r] = h
                        heapq.heapreplace(cand, (ts[h], seqs[h], r))
                    continue
            return t, seq, r
        return math.inf, 0, -1

    def _pop_timeout(self, lane: _Lane, to_r: int) -> None:
        """Consume the ring head just returned by ``_next_timeout`` (it is
        the validated top of the candidate heap)."""
        heapq.heappop(lane.to_cand)
        h = lane.to_head[to_r] + 1
        ts = lane.to_t[to_r]
        if h >= len(ts):
            lane.to_t[to_r] = []
            lane.to_seq[to_r] = []
            lane.to_head[to_r] = 0
        else:
            lane.to_head[to_r] = h
            heapq.heappush(lane.to_cand,
                           (ts[h], lane.to_seq[to_r][h], to_r))

    def _ring_append(self, lane: _Lane, r: int, t: float) -> None:
        """Push one timeout onto replica ``r``'s ring, assigning the next
        sequence number (mirrors one scalar ``push_event`` call)."""
        seq = lane.seq
        lane.seq = seq + 1
        ts = lane.to_t[r]
        if not ts:
            heapq.heappush(lane.to_cand, (t, seq, r))
        ts.append(t)
        lane.to_seq[r].append(seq)

    def _quantum(self, lane: _Lane, core: SchedulerCore, arrive: np.ndarray,
                 arrive_l: List[float], horizon: float, measure: bool,
                 hedge, on_failure=None) -> bool:
        """Advance one lane by one event — or one bulk arrival run. Returns
        False when the lane is finished."""
        inf = math.inf
        n_arr = len(arrive_l)
        t_arr = arrive_l[lane.arr_ptr] if lane.arr_ptr < n_arr else inf

        # earliest completion across devices
        c_t, c_seq, c_dev = inf, 0, -1
        for d, t in enumerate(lane.comp_t):
            if t < c_t or (t == c_t and lane.comp_seq[d] < c_seq):
                c_t, c_seq, c_dev = t, lane.comp_seq[d], d
        to_t, to_seq, to_r = self._next_timeout(lane)
        r_t, r_seq = (lane.rare[0][0], lane.rare[0][1]) if lane.rare \
            else (inf, 0)

        t_evt = min(c_t, to_t, r_t)
        meas_end = lane.meas_end if measure else inf
        t = min(t_arr, t_evt, meas_end)
        if t > horizon or t == inf:
            lane.active = False
            return False

        if measure and t == meas_end and t < min(t_arr, t_evt):
            self._measure_tick(lane, core, t)
            return True

        if t_arr <= t_evt:
            self._arrivals(lane, core, arrive, arrive_l, t_arr,
                           min(t_evt, meas_end), horizon, hedge)
            return True

        # pop the (t, seq)-minimal event, matching the scalar heap order
        if c_t <= t and (c_t < to_t or (c_t == to_t and c_seq < to_seq)) \
                and (c_t < r_t or (c_t == r_t and c_seq < r_seq)):
            payload = lane.comp_payload[c_dev]
            lane.comp_t[c_dev] = inf
            lane.comp_payload[c_dev] = None
            ridx, sids, stages, epoch = payload
            if epoch != lane.dev_epoch[self.replicas[ridx].device]:
                self._reissue(lane, ridx, sids, stages, c_t, epoch)
            else:
                self._on_complete(lane, core, ridx, sids, stages, c_t,
                                  hedge)
            return True
        if to_t <= t and (to_t < r_t or (to_t == r_t and to_seq < r_seq)):
            self._pop_timeout(lane, to_r)
            self._try_start(lane, core, to_r, to_t, hedge)
            return True

        _, _, kind, payload = heapq.heappop(lane.rare)
        if kind == "timeout":
            self._try_start(lane, core, payload[0], r_t, hedge)
        elif kind == "hedge":
            self._on_hedge(lane, payload, r_t, hedge)
        elif kind == "stale":
            ridx, sids, stages, epoch = payload
            if epoch != lane.dev_epoch[self.replicas[ridx].device]:
                self._reissue(lane, ridx, sids, stages, r_t, epoch)
            else:       # unreachable (epoch only moves at fail), kept for
                self._on_complete(lane, core, ridx, sids, stages, r_t,
                                  hedge)  # structural parity
        elif kind == "devevent":
            self._on_device_event(lane, core, r_t, *payload,
                                  on_failure=on_failure)
        return True

    # ------------------------------------------------------------- arrivals
    def _arrivals(self, lane: _Lane, core: SchedulerCore,
                  arrive: np.ndarray, arrive_l: List[float], t_arr: float,
                  t_bound: float, horizon: float, hedge) -> None:
        """Process the arrival at ``t_arr``; when a whole run of consecutive
        arrivals provably triggers no batch, commit the run in one step —
        a tight scalar loop for short runs, masked numpy above ``_MIN_VEC``
        (numpy setup costs more than it saves on a handful of samples)."""
        gear = lane.gears[lane.cur_gear]
        if self._gear_is_ensemble(gear):
            self._arrival_one(lane, core, t_arr, gear, hedge)
            return
        m0 = gear.cascade.models[0]
        trig = gear.min_queue_lens.get(m0, 1)
        reps0 = self.reps_of.get(m0, [])

        # window: arrivals up to the next event/tick (ties to the arrival),
        # the horizon, and — when any first-model device is idle — the
        # head-of-line fire window
        hi = min(t_bound, horizon)
        idle_reps = []
        rep_dev = self._rep_dev
        for r in reps0:
            dev = rep_dev[r]
            if lane.dev_idle[dev] and lane.dev_alive[dev]:
                q = lane.qs[r]
                if q.n:
                    if q.n >= trig:     # would fire on the next enqueue
                        self._arrival_one(lane, core, t_arr, gear, hedge)
                        return
                    hw = q.t[q.head] + self._fire_wait
                    if t_arr >= hw:
                        self._arrival_one(lane, core, t_arr, gear, hedge)
                        return
                    if hw <= hi:
                        hi = math.nextafter(hw, -math.inf)
                idle_reps.append(r)
        if idle_reps:
            # any sample of this run can become a fresh head-of-line
            hw = t_arr + self._fire_wait
            if hw <= hi:
                hi = math.nextafter(hw, -math.inf)

        p = lane.arr_ptr
        e = bisect_right(arrive_l, hi, p, min(p + _MAX_RUN, len(arrive_l)))
        k0 = e - p
        if k0 <= 1:
            self._arrival_one(lane, core, t_arr, gear, hedge)
            return
        if k0 < _MIN_VEC or (idle_reps and k0 < 2 * _MIN_VEC):
            self._arrival_run_scalar(lane, gear, m0, trig, idle_reps, p, e,
                                     arrive_l, hedge, core)
            return

        us = lane.pool.peek_block(k0)
        ent = self._route_table(gear, m0)
        if ent[1] is None:
            idxs = ent[2]
            routes = idxs[(us * len(idxs)).astype(np.int64) % len(idxs)]
        else:
            pos = np.searchsorted(ent[1], us, side="left")
            over = pos >= len(ent[2])
            pos[over] = 0
            routes = ent[2][pos]
            if over.any():
                routes = np.where(over, ent[3], routes)

        k = k0
        for r in idle_reps:
            budget = trig - 1 - lane.qs[r].n   # enqueues before a fire
            hits = np.flatnonzero(routes[:k] == r)
            if len(hits) > budget:
                k = int(hits[budget])          # stop BEFORE the firing one
        if k <= 1:
            self._arrival_one(lane, core, t_arr, gear, hedge)
            return
        if k < _MIN_VEC:
            self._arrival_run_scalar(lane, gear, m0, trig, idle_reps, p,
                                     p + k, arrive_l, hedge, core)
            return
        routes = routes[:k]

        ts = arrive[p:p + k]
        lane.pool.commit(k)
        lane.arr_ptr = p + k
        lane.meas_count += k
        lane.gear_of[p:p + k] = [gear] * k
        lane.per_model_samples[m0] = \
            lane.per_model_samples.get(m0, 0) + k
        if lane.traw is not None:
            cg = lane.cur_gear
            for i, ta in enumerate(ts.tolist()):
                lane.traw(("admit", ta, p + i, cg, 0, ""))
        if lane.trace is not None:
            lane.trace.routes.extend((m0, int(r)) for r in routes)
        seq0 = lane.seq
        lane.seq = seq0 + k                     # one timeout push each
        mw = self.cfg.max_wait
        for r in set(routes.tolist()) if len(reps0) > 1 else [reps0[0]]:
            nz = np.flatnonzero(routes == r)
            r_ts = ts[nz]
            sl = (nz + p).tolist()
            tl = r_ts.tolist()
            lane.qs[r].push_block(sl, [0] * len(sl), tl)
            new_ts = (r_ts + mw).tolist()
            new_seqs = (nz + seq0).tolist()
            if not lane.to_t[r]:
                heapq.heappush(lane.to_cand, (new_ts[0], new_seqs[0], r))
            lane.to_t[r].extend(new_ts)
            lane.to_seq[r].extend(new_seqs)

    def _arrival_run_scalar(self, lane: _Lane, gear: Gear, m0: str,
                            trig: int, idle_reps: List[int], p: int, e: int,
                            arrive_l: List[float], hedge, core) -> None:
        """Short-run twin of the vectorized arrival commit: same no-fire
        window, plain Python. Skips the per-arrival ``try_start`` the scalar
        driver pays (provably a no-op inside the window) and the event-heap
        push (ring append instead)."""
        ent = self._route_table(gear, m0)
        scan = ent[4]
        budgets = {r: trig - 1 - lane.qs[r].n for r in idle_reps} \
            if idle_reps else None
        pool = lane.pool
        arr, npool = pool.lst, pool.n
        mw = self.cfg.max_wait
        trace = lane.trace
        # no push in this window can fire (that is what the window bounds
        # prove), so queue and ring writes commute with the draws — buffer
        # the routed sids per replica and commit each queue in one
        # push_block after the loop
        bufs: Dict[int, List[int]] = {}
        sid = p
        while sid < e:
            ptr = pool.ptr
            if ptr >= npool:
                ptr %= npool
            u = arr[ptr]
            if scan is None:
                idxs = ent[3]
                r = idxs[int(u * len(idxs)) % len(idxs)]
            else:
                r = ent[3]
                for acc, rj in scan:
                    if u <= acc:
                        r = rj
                        break
            if budgets is not None:
                b = budgets.get(r)
                if b is not None:
                    if not b:          # this enqueue would reach the trigger
                        break
                    budgets[r] = b - 1
            pool.ptr = ptr + 1
            buf = bufs.get(r)
            if buf is None:
                bufs[r] = [sid]
            else:
                buf.append(sid)
            if trace is not None:
                trace.routes.append((m0, r))
            if lane.traw is not None:
                lane.traw(("admit", arrive_l[sid], sid, lane.cur_gear,
                           0, ""))
            sid += 1
        k = sid - p
        lane.arr_ptr = sid
        lane.meas_count += k
        if not k:          # first arrival of the run hits a trigger: full
            self._arrival_one(lane, core, arrive_l[p], gear, hedge)
            return
        lane.gear_of[p:sid] = [gear] * k
        lane.per_model_samples[m0] = \
            lane.per_model_samples.get(m0, 0) + k
        seq0 = lane.seq
        lane.seq = seq0 + k
        to_t, to_seq = lane.to_t, lane.to_seq
        for r, sl in bufs.items():
            tl = [arrive_l[s] for s in sl]
            lane.qs[r].push_block(sl, [0] * len(sl), tl)
            ts_r = to_t[r]
            if not ts_r:
                heapq.heappush(lane.to_cand,
                               (tl[0] + mw, seq0 + sl[0] - p, r))
            ts_r.extend(x + mw for x in tl)
            to_seq[r].extend(seq0 + s - p for s in sl)

    def _arrival_one(self, lane: _Lane, core: SchedulerCore, t_arr: float,
                     gear: Gear, hedge) -> None:
        sid = lane.arr_ptr
        lane.arr_ptr += 1
        lane.meas_count += 1
        lane.gear_of[sid] = gear
        if lane.traw is not None:
            lane.traw(("admit", t_arr, sid, lane.cur_gear, 0, ""))
        if self._gear_is_ensemble(gear):
            members = gear.cascade.models
            lane.votes[sid] = [len(members), 0, len(members)]
            for m in members:
                self._enqueue(lane, core, sid, 0, m, t_arr, gear, hedge)
        else:
            self._enqueue(lane, core, sid, 0, gear.cascade.models[0],
                          t_arr, gear, hedge)

    # -------------------------------------------------------- driver innards
    def _enqueue(self, lane: _Lane, core: SchedulerCore, sid: int,
                 stage: int, model: str, t: float, gear: Gear,
                 hedge) -> None:
        # no telemetry: the caller's admit/escalate/reissue event implies
        # this queue-enter at the same instant
        ridx = self._route_one(lane, model, gear, lane.pool.next())
        lane.qs[ridx].push(sid, stage, t)
        lane.per_model_samples[model] = \
            lane.per_model_samples.get(model, 0) + 1
        self._try_start(lane, core, ridx, t, hedge)
        if lane.qs[ridx].n:
            self._ring_append(lane, ridx, t + self.cfg.max_wait)

    def _try_start(self, lane: _Lane, core: SchedulerCore, ridx: int,
                   t: float, hedge) -> None:
        q = lane.qs[ridx]
        qlen = q.n
        if not qlen:
            return
        r = self.replicas[ridx]
        if not lane.dev_idle[r.device] or not lane.dev_alive[r.device]:
            return
        gear = lane.gears[lane.cur_gear]
        trig = gear.min_queue_lens.get(r.model, 1)
        ht = q.t[q.head]
        if not (qlen >= trig or t - ht >= self._fire_wait
                or t >= ht + self._fire_wait):
            return
        max_batch = self.cfg.max_batch
        bsz = qlen if qlen < max_batch else max_batch
        sids, stages = q.pop(bsz)
        if lane.trace is not None:
            lane.trace.record_fire(ridx, sids)
        if lane.traw is not None:
            lane.traw(("fire", t, ridx, tuple(sids)))
        # dead-ring sweep (simple mode only): with devices permanently
        # alive, every trigger-fire opportunity is seized at the event that
        # creates it, so a pending timeout matters only if it can still
        # wait-fire the *current* head (the scalar pops the rest as no-ops)
        # — drop the provably-dead prefix, or the whole ring when the queue
        # drained. With device events a dropped timeout could be the one
        # that revives a queue after recovery, so the rings stay intact.
        # Stale to_cand entries are re-validated at peek.
        ts = lane.to_t[ridx]
        if ts and lane.simple:
            if not q.n:
                lane.to_t[ridx] = []
                lane.to_seq[ridx] = []
                lane.to_head[ridx] = 0
            else:
                h = lane.to_head[ridx]
                n = len(ts)
                head_t = q.t[q.head]
                fw = self._fire_wait
                while h < n and ts[h] < head_t + fw:
                    h += 1
                lane.to_head[ridx] = h
        rt = self._runtime(r.model, bsz)
        # hedge straggler tests compare against the expected runtime under
        # current FLEET conditions (rt * net) — mirrors the scalar driver
        rt_eff = rt * lane.net
        rt_actual = rt_eff * lane.dev_speed[r.device]
        lane.dev_idle[r.device] = False
        lane.dev_busy[r.device] += rt_actual
        lane.per_model_batches[r.model] = \
            lane.per_model_batches.get(r.model, 0) + 1
        lane.comp_t[r.device] = t + rt_actual
        lane.comp_seq[r.device] = lane.seq
        lane.comp_payload[r.device] = (ridx, sids, stages,
                                       lane.dev_epoch[r.device])
        lane.seq += 1
        if hedge is not None and hedge.enabled and \
                rt_actual > hedge.hedge_multiplier * rt_eff:
            heapq.heappush(lane.rare,
                           (t + rt_eff * hedge.hedge_multiplier, lane.seq,
                            "hedge", (ridx, sids, stages)))
            lane.seq += 1

    def _resolve_table(self, gear: Gear, n_arr: int) -> Optional[tuple]:
        """(resolve_stage[sid], correct_at_resolve[sid]) for every sample
        id under ``gear``'s cascade — the backend's per-sample certainty is
        deterministic in (model, sid), so the whole path is precomputable.
        None when the backend cannot report correctness (EngineBackend
        without labels): the runtime path handles that case."""
        ent = self._resolve_memo.get(id(gear))
        if ent is not None and ent[0] is gear and len(ent[1]) >= n_arr:
            return ent
        models = gear.cascade.models
        thrs = gear.cascade.thresholds
        sids = np.arange(n_arr, dtype=np.int64)
        alive = np.ones(n_arr, bool)
        resolve_stage = np.zeros(n_arr, np.int64)
        correct = np.zeros(n_arr, bool)
        for s, m in enumerate(models):
            ex = self.backend.execute(m, sids)
            if ex.correct is None:
                return None
            if s < len(thrs):
                fwd = np.asarray(ex.certs, np.float64) < thrs[s]
            else:
                fwd = np.zeros(n_arr, bool)
            res_here = alive & ~fwd
            resolve_stage[res_here] = s
            correct[res_here] = np.asarray(ex.correct, bool)[res_here]
            alive &= fwd
        ent = (gear, resolve_stage, correct,
               resolve_stage.tolist(), correct.tolist())
        self._resolve_memo[id(gear)] = ent
        return ent

    def _on_complete(self, lane: _Lane, core: SchedulerCore, ridx: int,
                     sids: List[int], stages: List[int], t: float,
                     hedge) -> None:
        r = self.replicas[ridx]
        gear0 = lane.gear_of[sids[0]]
        same_gear = not self._gear_is_ensemble(gear0) and \
            (lane.single_gear or
             all(lane.gear_of[s] is gear0 for s in sids))
        if lane.simple and same_gear and lane.trace is None:
            tab = self._resolve_table(gear0, len(lane.cur_stage))
            if tab is not None:
                if len(sids) >= _MIN_VEC:
                    self._complete_fast(lane, core, gear0, tab, sids,
                                        stages, t, hedge)
                else:
                    # small batch: same table, per-sample — still skips
                    # the backend call and the threshold compare
                    models = gear0.cascade.models
                    rs, cs = tab[3], tab[4]
                    for sid, stage in zip(sids, stages):
                        if rs[sid] == stage:
                            self._finish(lane, sid, stage, t, cs[sid])
                        else:
                            lane.cur_stage[sid] = stage + 1
                            if lane.traw is not None:
                                lane.traw(("escalate", t, sid, stage))
                            self._enqueue(lane, core, sid, stage + 1,
                                          models[stage + 1], t, gear0,
                                          hedge)
                if lane.dev_alive[r.device]:
                    lane.dev_idle[r.device] = True
                    for rj in self.reps_on_dev.get(r.device, []):
                        self._try_start(lane, core, rj, t, hedge)
                        if not lane.dev_idle[r.device]:
                            break
                return
        uniform = lane.simple and len(sids) >= _MIN_VEC and same_gear

        ex = self.backend.execute(r.model, sids)
        certs = ex.certs
        corr = ex.correct
        if corr is None:
            lane.ck = False
            corr = [False] * len(sids)

        if uniform:
            self._complete_block(lane, core, gear0, sids, stages, certs,
                                 corr, t, hedge)
        else:
            for k, (sid, stage) in enumerate(zip(sids, stages)):
                if lane.cur_stage[sid] != stage:
                    continue
                if lane.hedge_used:
                    # per-batch hedge budget: a stage advance (or
                    # resolution) retires the straggler history
                    lane.hedge_used.pop(sid, None)
                    lane.hedged_to.pop(sid, None)
                g = lane.gear_of[sid]
                if self._gear_is_ensemble(g):
                    st = lane.votes[sid]
                    st[0] -= 1
                    st[1] += int(corr[k])
                    if st[0] == 0:
                        self._finish(lane, sid, stage, t,
                                     majority_vote(st[1], st[2]))
                    continue
                _, thr_np, models = self._hop_table(g)
                if stage < len(thr_np) and certs[k] < thr_np[stage]:
                    if lane.trace is not None:
                        lane.trace.hops.append(
                            (stage, float(certs[k]), models[stage + 1]))
                    lane.cur_stage[sid] = stage + 1
                    if lane.traw is not None:
                        lane.traw(("escalate", t, sid, stage))
                    self._enqueue(lane, core, sid, stage + 1,
                                  models[stage + 1], t, g, hedge)
                else:
                    if lane.trace is not None:
                        lane.trace.hops.append(
                            (stage, float(certs[k]), "resolve"))
                    self._finish(lane, sid, stage, t, corr[k])

        if lane.dev_alive[r.device]:
            lane.dev_idle[r.device] = True
            for rj in self.reps_on_dev.get(r.device, []):
                self._try_start(lane, core, rj, t, hedge)
                if not lane.dev_idle[r.device]:
                    break

    def _complete_block(self, lane: _Lane, core: SchedulerCore, gear: Gear,
                        sids: List[int], stages: List[int], certs, corr,
                        t: float, hedge) -> None:
        """Vectorized cascade continuation for a uniform-gear batch.

        Resolutions commute (no draws, no queue effects), so they are
        applied in one masked write; forwards then run in sample order —
        they consume routing draws and may fire interleaved batches, which
        keeps the scalar driver's decision order exactly."""
        sids_np = np.asarray(sids, np.int64)
        stages_np = np.asarray(stages, np.int64)
        certs_np = np.asarray(certs, np.float64)
        live = lane.cur_stage[sids_np] == stages_np
        _, thr_np, models = self._hop_table(gear)
        n_thr = len(thr_np)
        if n_thr:
            has_next = stages_np < n_thr
            thr_of = np.where(
                has_next, thr_np[np.minimum(stages_np, n_thr - 1)], -np.inf)
            fwd = live & has_next & (certs_np < thr_of)
        else:
            fwd = np.zeros(len(sids_np), bool)
        res = live & ~fwd

        if lane.trace is not None:
            for k in np.flatnonzero(live):
                out = models[stages_np[k] + 1] if fwd[k] else "resolve"
                lane.trace.hops.append(
                    (int(stages_np[k]), float(certs_np[k]), out))

        if res.any():
            r_sids = sids_np[res]
            lane.complete[r_sids] = t
            lane.correct[r_sids] = np.asarray(corr, bool)[res]
            lane.resolver[r_sids] = stages_np[res]
            lane.cur_stage[r_sids] = 1 << 30
            if lane.traw is not None:
                lane.traw(("closeb", t, r_sids.tolist()))

        fwd_idx = np.flatnonzero(fwd)
        if len(fwd_idx):
            self._forward(lane, core, gear, models, sids_np, stages_np,
                          fwd_idx, t, hedge)

    def _complete_fast(self, lane: _Lane, core: SchedulerCore, gear: Gear,
                       tab: tuple, sids: List[int], stages: List[int],
                       t: float, hedge) -> None:
        """`_complete_block` with the cascade outcome pre-resolved: no
        backend call, no threshold math — one table gather decides every
        sample. Only taken untraced and in simple mode, where every popped
        sample is live at its recorded stage (no hedged duplicates)."""
        sids_np = np.asarray(sids, np.int64)
        stage0 = stages[0]
        if stages.count(stage0) == len(stages):
            # a same-gear batch from one replica is single-stage (a model
            # occurs at one cascade position): skip the stages array
            res = tab[1][sids_np] == stage0
            r_sids = sids_np[res]
            if len(r_sids):
                lane.complete[r_sids] = t
                lane.correct[r_sids] = tab[2][r_sids]
                lane.resolver[r_sids] = stage0
                lane.cur_stage[r_sids] = 1 << 30
                if lane.traw is not None:
                    lane.traw(("closeb", t, r_sids.tolist()))
            f_sids = sids_np[~res]
            if len(f_sids):
                self._forward_block(lane, core, gear, gear.cascade.models,
                                    f_sids, stage0, t, hedge)
            return
        stages_np = np.asarray(stages, np.int64)
        res = tab[1][sids_np] == stages_np
        r_sids = sids_np[res]
        if len(r_sids):
            lane.complete[r_sids] = t
            lane.correct[r_sids] = tab[2][r_sids]
            lane.resolver[r_sids] = stages_np[res]
            lane.cur_stage[r_sids] = 1 << 30
            if lane.traw is not None:
                lane.traw(("closeb", t, r_sids.tolist()))
        fwd_idx = np.flatnonzero(~res)
        if len(fwd_idx):
            self._forward(lane, core, gear, gear.cascade.models, sids_np,
                          stages_np, fwd_idx, t, hedge)

    def _forward(self, lane: _Lane, core: SchedulerCore, gear: Gear,
                 models, sids_np: np.ndarray, stages_np: np.ndarray,
                 fwd_idx: np.ndarray, t: float, hedge) -> None:
        """Cascade-forward the masked samples in sample order.

        All pushes happen at the same instant ``t``, so a replica's
        wait-ripeness cannot change mid-block and the only fire source is
        a trigger crossing on an idle device. That makes the no-fire run
        computable up front, exactly like the arrival commit: route the
        whole block on peeked draws, cut at the first push that would
        fire, bulk-commit the prefix, fire through the scalar enqueue, and
        continue with the rest."""
        stage = int(stages_np[fwd_idx[0]])
        if lane.trace is not None or len(fwd_idx) < 2 or \
                not bool((stages_np[fwd_idx] == stage).all()):
            for k in fwd_idx:
                sid = int(sids_np[k])
                st = int(stages_np[k])
                lane.cur_stage[sid] = st + 1
                if lane.traw is not None:
                    lane.traw(("escalate", t, sid, st))
                self._enqueue(lane, core, sid, st + 1, models[st + 1], t,
                              gear, hedge)
            return
        self._forward_block(lane, core, gear, models, sids_np[fwd_idx],
                            stage, t, hedge)

    def _forward_block(self, lane: _Lane, core: SchedulerCore, gear: Gear,
                       models, f_sids: np.ndarray, stage: int, t: float,
                       hedge) -> None:
        """Forward a single-stage block (the workhorse behind ``_forward``
        and the fast completion path)."""
        st1 = stage + 1
        nxt = models[st1]
        lane.cur_stage[f_sids] = st1
        if lane.traw is not None:
            for s in f_sids.tolist():
                lane.traw(("escalate", t, s, stage))
        trig = gear.min_queue_lens.get(nxt, 1)
        reps_n = self.reps_of.get(nxt, [])
        rep_dev = self._rep_dev
        qs = lane.qs
        fw = self._fire_wait
        mw = self.cfg.max_wait
        pos, n = 0, len(f_sids)
        while pos < n:
            k_rem = n - pos
            if k_rem < _MIN_VEC:
                for sid in f_sids[pos:].tolist():
                    self._enqueue(lane, core, sid, st1, nxt, t, gear,
                                  hedge)
                return
            # fire budget per idle-alive replica: pushes it can absorb
            # before firing (0 when its head is already wait-ripe or the
            # queue already sits at the trigger)
            budgets = []
            for r in reps_n:
                dev = rep_dev[r]
                if lane.dev_idle[dev] and lane.dev_alive[dev]:
                    q = qs[r]
                    if q.n and (q.n >= trig or t - q.t[q.head] >= fw
                                or t >= q.t[q.head] + fw):
                        budgets.append((r, 0))
                    else:
                        budgets.append((r, trig - 1 - q.n))
            us = lane.pool.peek_block(k_rem)
            routes = self._route_block(lane, nxt, gear, us)
            cut = k_rem
            for r, b in budgets:
                hits = np.flatnonzero(routes == r)
                if len(hits) > b:
                    c = int(hits[b])       # stop BEFORE the firing push
                    if c < cut:
                        cut = c
            if cut < _MIN_VEC:
                # short no-fire run + the firing push: plain enqueues
                for sid in f_sids[pos:pos + cut + 1].tolist():
                    self._enqueue(lane, core, sid, st1, nxt, t, gear,
                                  hedge)
                pos += cut + 1
                continue
            routes_c = routes[:cut]
            sids_c = f_sids[pos:pos + cut]
            lane.pool.commit(cut)
            lane.per_model_samples[nxt] = \
                lane.per_model_samples.get(nxt, 0) + cut
            seq0 = lane.seq
            lane.seq = seq0 + cut
            tw = t + mw
            for r in set(routes_c.tolist()) if len(reps_n) > 1 \
                    else [reps_n[0]]:
                mask = routes_c == r
                sl = sids_c[mask].tolist()
                qs[r].push_block(sl, [st1] * len(sl), [t] * len(sl))
                new_seqs = (seq0 + np.flatnonzero(mask)).tolist()
                if not lane.to_t[r]:
                    heapq.heappush(lane.to_cand, (tw, new_seqs[0], r))
                lane.to_t[r].extend([tw] * len(sl))
                lane.to_seq[r].extend(new_seqs)
            if cut == k_rem:
                return
            self._enqueue(lane, core, int(f_sids[pos + cut]), st1, nxt, t,
                          gear, hedge)
            pos += cut + 1

    def _finish(self, lane: _Lane, sid: int, stage: int, t: float,
                is_correct) -> None:
        lane.complete[sid] = t
        lane.correct[sid] = bool(is_correct)
        lane.resolver[sid] = stage
        lane.cur_stage[sid] = 1 << 30
        if lane.traw is not None:
            lane.traw(("close", t, sid, "completed"))

    # ------------------------------------------------------------ rare paths
    def _sibling(self, lane: _Lane, ridx: int) -> Optional[int]:
        """Fastest (min-queue) alive, non-draining sibling of ridx."""
        model = self.replicas[ridx].model
        best, best_q = None, None
        for rj in self.reps_of.get(model, []):
            d = self.replicas[rj].device
            if rj == ridx or not lane.dev_alive[d] or lane.dev_draining[d]:
                continue
            if best is None or lane.qs[rj].n < best_q:
                best, best_q = rj, lane.qs[rj].n
        return best

    @staticmethod
    def _refund_hedge(lane: _Lane, sid: int, rj: int) -> None:
        # forced re-issue off replica rj: when the live hedge copy is the
        # one parked there, hand the retry budget back (the fleet, not the
        # sample's straggler history, caused this re-issue)
        if lane.hedged_to.get(sid) == rj:
            lane.hedged_to.pop(sid, None)
            n_used = lane.hedge_used.get(sid, 0) - 1
            if n_used > 0:
                lane.hedge_used[sid] = n_used
            else:
                lane.hedge_used.pop(sid, None)

    def _reissue(self, lane: _Lane, ridx: int, sids, stages,
                 t: float, epoch: int) -> None:
        if epoch in lane.revoked.get(self.replicas[ridx].device, ()):
            # the batch died WITH the revoked spot machine: sole copies
            # are shed, hedged samples are carried by their duplicate
            for sid, stage in zip(sids, stages):
                if lane.cur_stage[sid] == stage and \
                        lane.hedged_to.get(sid) is None:
                    lane.cur_stage[sid] = 1 << 30
                    lane.shed += 1
                    if lane.traw is not None:
                        lane.traw(("close", t, sid, "revoked"))
            return
        alt = self._sibling(lane, ridx)
        if alt is None:
            return
        mw = self.cfg.max_wait
        for sid, stage in zip(sids, stages):
            if lane.cur_stage[sid] == stage:
                self._refund_hedge(lane, sid, ridx)
                lane.qs[alt].push(sid, stage, t)
                if lane.traw is not None:
                    lane.traw(("reissue", t, sid, stage))
                self._ring_append(lane, alt, t + mw)

    def _on_hedge(self, lane: _Lane, payload, t: float, hedge) -> None:
        ridx, sids, stages = payload
        alt = self._sibling(lane, ridx)
        if alt is None:
            return
        pushed = False
        budget = hedge.max_hedges_per_batch
        for sid, stage in zip(sids, stages):
            if lane.cur_stage[sid] == stage and \
                    lane.hedge_used.get(sid, 0) < budget:
                lane.hedge_used[sid] = lane.hedge_used.get(sid, 0) + 1
                lane.hedged_to[sid] = alt
                lane.qs[alt].push(sid, stage, t)
                if lane.traw is not None:
                    lane.traw(("hedge", t, sid, stage))
                pushed = True
        if pushed:
            # immediate poll goes to the overflow heap: its time equals the
            # current event time, which would break the ring's sort order
            heapq.heappush(lane.rare, (t, lane.seq, "timeout", (alt,)))
            lane.seq += 1
            self._ring_append(lane, alt, t + self.cfg.max_wait)

    def _drain_queues(self, lane: _Lane, t: float, dev: int) -> None:
        """Move queued samples off ``dev`` to sibling replicas."""
        mw = self.cfg.max_wait
        for rj in self.reps_on_dev.get(dev, []):
            sids, stages = lane.qs[rj].pop(lane.qs[rj].n)
            alt = self._sibling(lane, rj)
            if alt is None:
                continue
            for sid, stage in zip(sids, stages):
                self._refund_hedge(lane, sid, rj)
                lane.qs[alt].push(sid, stage, t)
                self._ring_append(lane, alt, t + mw)

    def _on_device_event(self, lane: _Lane, core: SchedulerCore, t: float,
                         dev: int, kind: str, factor: float,
                         on_failure=None) -> None:
        if kind == "slow":
            lane.dev_speed[dev] = factor
            return
        if kind == "netdeg":
            lane.net = factor
            return
        if kind == "recover":
            lane.dev_speed[dev] = 1.0
            lane.dev_draining[dev] = False
            if not lane.dev_alive[dev]:
                lane.dev_alive[dev] = True
                lane.dev_idle[dev] = True
                for rj in self.reps_on_dev.get(dev, []):
                    self._try_start(lane, core, rj, t, None)
                    if not lane.dev_idle[dev]:
                        break
            return
        if kind == "drain":
            # preemption notice: NEW work stops landing here (survivor
            # gears from the failure callback route around it, sibling /
            # hedge re-issues skip it), but the device keeps serving its
            # queued batches, racing the revoke deadline; the callback
            # also pre-computes the survivor plan so the swap at revoke
            # time is O(1)
            lane.dev_draining[dev] = True
            if on_failure is not None:
                new_gears = on_failure(t, dev)
                if new_gears is not None:
                    lane.gears = list(new_gears)
                    lane.single_gear = len(lane.gears) == 1
            return
        if kind == "revoke":
            # spot revoke: the machine vanishes with whatever it holds.
            # Queued sole copies are shed now; the in-flight batch becomes
            # a stale completion under a revoked epoch, so `_reissue`
            # sheds (not re-issues) it at exactly the (t, seq) the scalar
            # heap pops it.
            lane.revoked.setdefault(dev, set()).add(lane.dev_epoch[dev])
            lane.dev_alive[dev] = False
            lane.dev_idle[dev] = False
            lane.dev_draining[dev] = False
            lane.dev_epoch[dev] += 1
            if lane.comp_payload[dev] is not None:
                heapq.heappush(lane.rare,
                               (lane.comp_t[dev], lane.comp_seq[dev],
                                "stale", lane.comp_payload[dev]))
                lane.comp_t[dev] = math.inf
                lane.comp_payload[dev] = None
            for rj in self.reps_on_dev.get(dev, []):
                sids, stages = lane.qs[rj].pop(lane.qs[rj].n)
                for sid, stage in zip(sids, stages):
                    if lane.cur_stage[sid] != stage:
                        continue  # stale duplicate, sample lives on
                    alt = lane.hedged_to.get(sid)
                    if alt == rj:
                        # the queued copy is the hedge duplicate; the
                        # primary batch is still running elsewhere
                        self._refund_hedge(lane, sid, rj)
                    elif alt is None:
                        lane.cur_stage[sid] = 1 << 30
                        lane.shed += 1
                        if lane.traw is not None:
                            lane.traw(("close", t, sid, "revoked"))
                    # else: primary dies, hedge copy carries the sample
            if on_failure is not None:
                new_gears = on_failure(t, dev)
                if new_gears is not None:
                    lane.gears = list(new_gears)
                    lane.single_gear = len(lane.gears) == 1
            return
        # fail: the in-flight batch becomes a stale completion — it keeps
        # its (t, seq) so it pops exactly when the scalar heap would pop it
        lane.dev_alive[dev] = False
        lane.dev_idle[dev] = False
        lane.dev_draining[dev] = False
        lane.dev_epoch[dev] += 1
        if lane.comp_payload[dev] is not None:
            heapq.heappush(lane.rare,
                           (lane.comp_t[dev], lane.comp_seq[dev], "stale",
                            lane.comp_payload[dev]))
            lane.comp_t[dev] = math.inf
            lane.comp_payload[dev] = None
        self._drain_queues(lane, t, dev)
        if on_failure is not None:
            new_gears = on_failure(t, dev)
            if new_gears is not None:
                lane.gears = list(new_gears)
                lane.single_gear = len(lane.gears) == 1

    def _measure_tick(self, lane: _Lane, core: SchedulerCore,
                      t: float) -> None:
        measured = lane.meas_count / self.cfg.measure_interval
        if lane.traw is not None:
            reg = self.telemetry.registry
            reg.gauge("sim_measured_qps").set(measured)
            reg.gauge("sim_cur_gear").set(lane.cur_gear)
        first_q = 0
        g = lane.gears[lane.cur_gear]
        m0 = g.cascade.models[0]
        for ridx in self.reps_of.get(m0, []):
            first_q += lane.qs[ridx].n
        trace_core = core.trace
        core.trace = lane.trace
        new_gear = core.select_gear(t, measured, lane.cur_gear, first_q,
                                    len(lane.gears))
        core.trace = trace_core
        if new_gear != lane.cur_gear:
            lane.switches.append((t, new_gear))
            lane.cur_gear = new_gear
        lane.meas_count = 0
        lane.meas_end += self.cfg.measure_interval

    # --------------------------------------------------------------- results
    def _result(self, lane: _Lane, arrive: np.ndarray, n_arr: int,
                horizon: float) -> SimResult:
        done = ~np.isnan(lane.complete)
        return SimResult(
            latencies=(lane.complete[done] - arrive[done]),
            correct=lane.correct[done],
            arrive_times=arrive[done],
            complete_times=lane.complete[done],
            resolver=lane.resolver[done],
            completed=int(done.sum()),
            offered=n_arr,
            backlog_end=int(n_arr - done.sum()) - lane.shed,
            shed=lane.shed,
            device_busy=np.asarray(lane.dev_busy),
            horizon=horizon,
            gear_switches=lane.switches,
            per_model_batches=lane.per_model_batches,
            per_model_samples=lane.per_model_samples,
            correctness_known=lane.ck)
