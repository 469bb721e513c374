"""Port of ``repro/serving/runtime.py``.

``Request``, ``_ReplicaQueue``, ``_TenantReplicaQueue``, ``CascadeServer``
and ``MultiTenantServer`` (each with ``run_trace`` on the wall clock with
threads and ``run_virtual`` in virtual time) are copied line for line: the
runtime owns only threads, queues and the clock, every decision goes
through the shared ``SchedulerCore`` copy, and execution through an
``ExecutionBackend`` — by default the port's ``EngineBackend``, whose
engines run on the card. Every logical device of the plan gets its own
consumer thread; on one card they all launch on the same device and
stream, so their batches run one after another there, where the
discrete-event simulator models independent devices. The tenants of a
``MultiTenantServer`` share those devices the same way.

The reference module's description follows.

Online serving runtime (paper §5) — the REAL system.

Producer-consumer architecture: the producer accepts requests, measures QPS
over a fixed interval, switches gears (with the α-hysteresis rule), and
routes each request to a replica queue of the gear's first model. One
consumer thread per device polls its replicas' queues and triggers inference
when a queue reaches the gear's min-queue-length (or the head-of-line
timeout fires); non-certain samples cascade to the next model's queue.

Every serving *decision* — routing, gear selection, batch trigger, cascade
continuation — is delegated to the shared ``repro.core.scheduling
.SchedulerCore``, the same object the discrete-event simulator drives, so
the gear planner's simulator cannot drift from the served system (DESIGN.md
§2). Model *execution* goes through an ``repro.core.execution
.ExecutionBackend`` (default: ``EngineBackend`` over the given jitted
engines; a ``ReplayBackend`` instead serves recorded validation behaviour —
compute-free high-QPS stress runs on the real threaded machinery). This
module owns only threads, queues and the wall clock. The decision path is
factored into step methods (``submit`` / ``_poll_replica`` / ``_run_batch``
/ ``_gear_step``) that the threaded loops call with wall time and
``run_virtual`` calls with simulated time — the latter makes the runtime's
decisions deterministic and directly comparable to the simulator
(tests/test_scheduling_parity.py).

In the paper each box is a Ray actor; here they are threads in one process
(the decision logic — the paper's contribution — is identical; process
isolation is an orchestration detail, DESIGN.md §3). Wall-clock timing makes
this the ground truth for the simulator-fidelity benchmark (Fig. 13).
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.execution import EngineBackend, ExecutionBackend
from repro_torch.core.gears import Gear, GearPlan
from repro_torch.core.scheduling import (CascadeHop, DecisionTrace, GearSelector,
                                   RoutePool, SchedulerConfig, SchedulerCore,
                                   head_of_line_wait, plan_target,
                                   with_hysteresis)
from repro_torch.serving.engine import InferenceEngine


@dataclass
class Request:
    rid: int
    tokens: np.ndarray
    t_arrive: float = 0.0
    t_done: float = 0.0
    pred: int = -1
    cert: float = 0.0
    resolver: int = -1          # cascade stage that resolved it
    gear_idx: int = 0
    stage: int = 0
    # admitting gear OBJECT + plan epoch: across plan hot-swaps a request
    # finishes its cascade on the plan that admitted it (core/adaption.py)
    gear: Optional[Gear] = None
    plan_epoch: int = 0
    # owning tenant (multi-tenant serving, core/tenancy.py); "" = the
    # single-tenant CascadeServer path
    tenant: str = ""

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrive


class _ReplicaQueue:
    def __init__(self):
        self.q: deque = deque()
        self.lock = threading.Lock()

    def push(self, req: Request, t: float):
        with self.lock:
            self.q.append((req, t))

    def pop_batch(self, max_n: int) -> List:
        with self.lock:
            n = min(len(self.q), max_n)
            return [self.q.popleft() for _ in range(n)]

    def __len__(self):
        return len(self.q)

    def head_time(self) -> Optional[float]:
        with self.lock:
            return self.q[0][1] if self.q else None


class _TenantReplicaQueue(_ReplicaQueue):
    """Replica queue with per-tenant occupancy counts, maintained under the
    same lock as the queue itself (the effective batch trigger of a shared
    queue is the min over the tenants actually waiting in it)."""

    def __init__(self, n_tenants: int):
        super().__init__()
        self.counts = [0] * n_tenants

    def push_tenant(self, req: Request, t: float, ti: int):
        with self.lock:
            self.q.append((req, t))
            self.counts[ti] += 1

    def pop_batch_tenant(self, max_n: int, tidx_of) -> List:
        with self.lock:
            n = min(len(self.q), max_n)
            batch = [self.q.popleft() for _ in range(n)]
            for req, _ in batch:
                self.counts[tidx_of[req.tenant]] -= 1
            return batch


class CascadeServer:
    """Gear-plan-driven online server, backend-agnostic.

    ``backend`` supplies the execution physics; by default the given
    ``engines`` (real jitted models) are wrapped in an ``EngineBackend``
    with the chosen certainty ``estimator``. ``selector`` overrides the
    default §5 plan policy (plan target composed with α-hysteresis) — this
    is how the baseline policies of ``repro.serving.baselines`` execute on
    the real runtime, via the same ``GearSelector`` protocol the simulator
    uses.
    """

    def __init__(self, plan: GearPlan,
                 engines: Optional[Dict[str, InferenceEngine]] = None,
                 estimator="top2_gap", alpha: float = 8.0,
                 measure_interval: float = 0.1, max_wait: float = 0.05,
                 max_batch: int = 128,
                 selector: Optional[GearSelector] = None,
                 route_pool: Optional[RoutePool] = None,
                 decision_trace: Optional[DecisionTrace] = None,
                 seed: int = 0, lifecycle=None,
                 backend: Optional[ExecutionBackend] = None,
                 telemetry=None):
        # (active plan, current gear index, plan epoch) as ONE tuple: a
        # hot-swap (or a gear switch) replaces the reference in a single
        # assignment, so a concurrent submit/_poll_replica thread always
        # reads a consistent triple — never the new plan with a stale gear
        # index, nor an epoch tag contradicting the admitting gear
        self._active: Tuple[GearPlan, int, int] = (plan, 0, 0)
        # all execution physics (inference, certainty estimation, runtime
        # prediction) live behind the backend — estimator resolution
        # included (repro.core.execution.resolve_estimator)
        self.backend = backend if backend is not None \
            else EngineBackend(engines or {}, estimator=estimator)
        self.cfg = SchedulerConfig(
            max_wait=max_wait, measure_interval=measure_interval,
            alpha=alpha, max_batch=max_batch, seed=seed)
        self.core = SchedulerCore(
            plan.replicas, self.cfg,
            selector=selector or with_hysteresis(plan_target(plan), alpha),
            trace=decision_trace)
        # online re-planning (core/adaption.py): stepped at every producer
        # measurement tick; its SwapEvents replace self.plan atomically
        self.lifecycle = lifecycle
        if lifecycle is not None:
            lifecycle.attach(self.core)
        self.plan_swaps: List[Tuple[float, int, str]] = []
        self.route_pool = route_pool or RoutePool(seed)
        # pure observer (core/telemetry.py): hot hooks are one `is not
        # None` test plus a flat tuple append; list.append is atomic
        # under the GIL, so the threaded drivers share the log lock-free
        self.telemetry = telemetry
        self._traw = telemetry.raw.append if telemetry is not None else None

        self.queues: List[_ReplicaQueue] = [
            _ReplicaQueue() for _ in plan.replicas]
        self._arr_count = 0
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self.completed: List[Request] = []
        self._done_lock = threading.Lock()
        self.gear_switches: List = []
        self._threads: List[threading.Thread] = []

    @property
    def plan(self) -> GearPlan:
        return self._active[0]

    @property
    def cur_gear(self) -> int:
        return self._active[1]

    # --------------------------------------------------- decision steps
    # These four methods are the ONLY places serving decisions are taken,
    # and each consists of one SchedulerCore call plus state updates. The
    # threaded loops feed them wall time; run_virtual feeds them simulated
    # time. Policy must go into the core, never in here.

    def submit(self, req: Request, now: Optional[float] = None) -> int:
        """Accept one request: stamp arrival, route to a replica queue of
        the current gear's first model. Returns the chosen replica index."""
        t = time.monotonic() if now is None else now
        req.t_arrive = t
        with self._count_lock:
            self._arr_count += 1
        plan, cur, epoch = self._active   # one consistent read
        req.gear_idx = cur
        gear = plan.gears[cur]
        req.gear = gear
        req.plan_epoch = epoch
        req.stage = 0
        if self._traw is not None:
            self._traw(("admit", t, req.rid, cur, epoch, req.tenant))
        ridx = self.core.route(gear.cascade.models[0], gear,
                               self.route_pool.next())
        self.queues[ridx].push(req, t)
        return ridx

    def _gear_step(self, now: float, measured_qps: float) -> None:
        """One producer measurement tick (§5), plus the plan-lifecycle
        step: drift monitoring, background re-plan hand-off, and the
        atomic hot-swap (gear table + QPS-remapped gear index + selector
        replaced within one tick, before any further decision)."""
        plan, cur, epoch = self._active
        if self.lifecycle is not None:
            # swap application MUST mirror the simulator's measurement-tick
            # branch (core/simulator.py) step for step — the hot-swap
            # parity test pins the two copies to each other
            swap = self.lifecycle.step(now, measured_qps, cur)
            if swap is not None:
                self._active = (swap.plan, swap.new_gear, swap.epoch)
                if swap.selector is not None:
                    self.core.selector = swap.selector
                self.plan_swaps.append((now, swap.epoch, swap.reason))
                if swap.new_gear != cur:
                    self.gear_switches.append((now, swap.new_gear))
                plan, cur, epoch = swap.plan, swap.new_gear, swap.epoch
        gear = plan.gears[cur]
        q0 = sum(len(self.queues[i])
                 for i in self.core.reps_of[gear.cascade.models[0]])
        new = self.core.select_gear(now, measured_qps, cur, q0,
                                    len(plan.gears))
        if new != cur:
            self.gear_switches.append((now, new))
            self._active = (plan, new, epoch)

    def _poll_replica(self, ridx: int, now: float) -> Optional[List]:
        """Batch-trigger decision for one replica: pop and return the batch
        if the core says fire, else None."""
        q = self.queues[ridx]
        qlen = len(q)
        if not qlen:
            return None
        plan, cur, _ = self._active     # one consistent read
        model = plan.replicas[ridx].model
        head = q.head_time()
        head_wait = head_of_line_wait(now, head, self.cfg.max_wait) \
            if head is not None else 0.0
        gear = plan.gears[cur]
        if not self.core.should_fire(qlen, head_wait, model, gear):
            return None
        batch = q.pop_batch(self.core.batch_size(qlen))
        if not batch:
            return None
        if self.core.trace is not None:
            self.core.trace.record_fire(ridx, [r.rid for r, _ in batch])
        if self._traw is not None:
            self._traw(("fire", now, ridx,
                        tuple(r.rid for r, _ in batch)))
        return batch

    def _run_batch(self, model: str, batch: List,
                   now: Optional[float] = None,
                   on_enqueue: Optional[Callable[[int, float], None]] = None
                   ) -> None:
        """Execute one batch through the backend, then resolve or cascade
        each sample per the core's continuation decision. ``on_enqueue(ridx,
        t)`` is notified of each cascade push (run_virtual uses it to
        schedule polls; the threaded consumers poll continuously and pass
        nothing)."""
        reqs = [r for r, _ in batch]
        # the ONLY execution call: jitted engines, validation replay, or
        # any other backend — the driver never special-cases the source
        ex = self.backend.execute(model, [r.rid for r in reqs],
                                  tokens=[r.tokens for r in reqs])
        certs, preds = ex.certs, ex.preds
        t = time.monotonic() if now is None else now
        for i, req in enumerate(reqs):
            # the ADMITTING gear, not the active plan's: in-flight work is
            # immune to hot-swaps (requests from before lifecycle support
            # fall back to the plan lookup)
            gear = req.gear if req.gear is not None \
                else self.plan.gears[req.gear_idx]
            hop = self.core.next_hop(req.stage, float(certs[i]), gear)
            if isinstance(hop, CascadeHop):
                if self._traw is not None:
                    self._traw(("escalate", t, req.rid, req.stage))
                req.stage = hop.next_stage
                ridx = self.core.route(hop.next_model, gear,
                                       self.route_pool.next())
                self.queues[ridx].push(req, t)
                if on_enqueue is not None:
                    on_enqueue(ridx, t)
            else:
                req.t_done = t
                req.pred = int(preds[i]) if preds is not None else -1
                req.cert = float(certs[i])
                req.resolver = hop.stage
                if self._traw is not None:
                    self._traw(("close", t, req.rid, "completed"))
                with self._done_lock:
                    self.completed.append(req)

    # -------------------------------------------------- threaded drivers
    def _producer_loop(self):
        """QPS measurement + gear switching (§5)."""
        while not self._stop.is_set():
            time.sleep(self.cfg.measure_interval)
            with self._count_lock:
                measured = self._arr_count / self.cfg.measure_interval
                self._arr_count = 0
            self._gear_step(time.monotonic(), measured)

    def _consumer_loop(self, device: int):
        my_reps = self.core.reps_on_dev.get(device, [])
        while not self._stop.is_set():
            ran = False
            now = time.monotonic()
            for ridx in my_reps:
                batch = self._poll_replica(ridx, now)
                if batch:
                    self._run_batch(self.plan.replicas[ridx].model, batch)
                    ran = True
            if not ran:
                time.sleep(0.0005)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        # wall-clock mode: the re-planner must never run the optimiser on
        # the producer tick that polls it — flip it to its daemon-thread
        # mode (run_virtual never starts threads, so it stays deterministic)
        if self.lifecycle is not None and \
                self.lifecycle.replanner is not None:
            self.lifecycle.replanner.threaded = True
        self._stop.clear()
        self._threads = [threading.Thread(target=self._producer_loop,
                                          daemon=True)]
        for d in range(self.plan.num_devices):
            self._threads.append(threading.Thread(
                target=self._consumer_loop, args=(d,), daemon=True))
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    def run_trace(self, requests: Sequence[Request],
                  qps_per_sec: np.ndarray, drain: float = 2.0
                  ) -> List[Request]:
        """Open-loop replay: issue requests per the trace regardless of
        completion (paper §6.2)."""
        from repro_torch.core.simulator import trace_to_arrivals
        arrivals = trace_to_arrivals(qps_per_sec)
        assert len(requests) >= len(arrivals)
        self.start()
        t0 = time.monotonic()
        for i, at in enumerate(arrivals):
            delay = t0 + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            self.submit(requests[i])
        time.sleep(drain)
        self.stop()
        return list(self.completed)

    # ------------------------------------------------- virtual-time driver
    def run_virtual(self, requests: Sequence[Request],
                    qps_per_sec: Optional[np.ndarray] = None,
                    batch_runtime: Optional[Callable[[str, int], float]]
                    = None,
                    drain: float = 2.0,
                    device_events=None, scenario=None) -> List[Request]:
        """Deterministic open-loop replay in VIRTUAL time: no threads, no
        wall clock, no sleeps.

        Exercises the identical decision path as the threaded server —
        ``submit`` → ``_poll_replica`` → ``_run_batch`` → ``_gear_step`` —
        but drives it from a discrete event loop whose service times come
        from ``batch_runtime(model, batch_size)`` (default: the backend's
        own runtime prediction) instead of the wall clock. Event ordering
        mirrors the simulator's loop (arrivals win ties over queue events;
        measurement ticks fire only when strictly earliest), so a
        ``DecisionTrace`` captured here is directly comparable to one from
        ``ServingSimulator.run_trace`` — that equality is the planner's
        fidelity contract (tests/test_scheduling_parity.py).

        ``device_events`` (or a full ``repro.core.scenarios.Scenario`` via
        ``scenario=``, mutually exclusive with explicit trace/events) run
        the same fail / slow / recover / drain / revoke / netdeg machinery
        as the simulators: a failed device invalidates its in-flight batch
        (the epoch guard re-issues the work on a sibling), a draining
        device keeps serving its queued batches but receives no re-issued
        work, racing the revoke deadline, and a revoked device sheds
        whatever was still resident on it — the spot machine is gone.
        """
        from repro_torch.core.simulator import (trace_to_arrivals,
                                          validate_device_events)
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
        if batch_runtime is None:
            batch_runtime = self.backend.batch_runtime
        arrivals = trace_to_arrivals(qps_per_sec).tolist()
        n_arr = len(arrivals)
        assert len(requests) >= n_arr
        horizon = float(len(qps_per_sec)) + drain
        replicas = self.plan.replicas
        reps_on_dev = self.core.reps_on_dev
        reps_of = self.core.reps_of
        max_wait = self.cfg.max_wait
        n_dev = self.plan.num_devices
        dev_idle = [True] * n_dev
        dev_alive = [True] * n_dev
        dev_speed = [1.0] * n_dev
        dev_epoch = [0] * n_dev
        dev_draining = [False] * n_dev
        # epochs ended by a spot revoke: in-flight batches carrying them
        # are dropped (the requests never resolve — shed), not re-issued
        revoked: Dict[int, set] = {}
        net = 1.0

        heap: List[Tuple[float, int, str, tuple]] = []
        seq = 0

        def push_event(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        def try_fire(ridx: int, t: float):
            dev = replicas[ridx].device
            if not dev_idle[dev] or not dev_alive[dev]:
                return
            batch = self._poll_replica(ridx, t)
            if not batch:
                return
            rt = batch_runtime(replicas[ridx].model, len(batch))
            rt_actual = rt * net * dev_speed[dev]
            dev_idle[dev] = False
            push_event(t + rt_actual, "complete",
                       (ridx, batch, dev_epoch[dev]))

        def on_enqueue(ridx: int, t: float):
            # mirror the simulator's enqueue: poll the target replica, then
            # arm the head-of-line timeout if the sample is still queued
            try_fire(ridx, t)
            if len(self.queues[ridx]):
                push_event(t + max_wait, "timeout", (ridx,))

        def sibling_replica(ridx: int) -> Optional[int]:
            # fastest (min-queue) alive, non-draining sibling — mirrors the
            # simulators' re-issue target choice
            model = replicas[ridx].model
            best, best_q = None, None
            for rj in reps_of.get(model, []):
                d = replicas[rj].device
                if rj == ridx or not dev_alive[d] or dev_draining[d]:
                    continue
                if best is None or len(self.queues[rj]) < best_q:
                    best, best_q = rj, len(self.queues[rj])
            return best

        def drain_queues(t: float, dev: int) -> None:
            for rj in reps_on_dev.get(dev, []):
                moved = self.queues[rj].pop_batch(len(self.queues[rj]))
                alt = sibling_replica(rj)
                if alt is None:
                    continue
                for req, _ in moved:
                    self.queues[alt].push(req, t)
                    push_event(t + max_wait, "timeout", (alt,))

        def on_device_event(t: float, dev: int, kind: str, factor: float):
            nonlocal net
            if kind == "slow":
                dev_speed[dev] = factor
            elif kind == "netdeg":
                net = factor
            elif kind == "recover":
                dev_speed[dev] = 1.0
                dev_draining[dev] = False
                if not dev_alive[dev]:
                    dev_alive[dev] = True
                    dev_idle[dev] = True
                    for rj in reps_on_dev.get(dev, []):
                        try_fire(rj, t)
                        if not dev_idle[dev]:
                            break
            elif kind == "drain":
                # preemption notice: new routing (sibling re-issues) skips
                # the device, but it keeps serving its queued batches,
                # racing the revoke deadline
                dev_draining[dev] = True
            elif kind == "revoke":
                # spot revoke: the machine vanishes with whatever it
                # holds — queued requests are dropped now, the in-flight
                # batch's epoch is recorded so its completion drops too
                revoked.setdefault(dev, set()).add(dev_epoch[dev])
                dev_alive[dev] = False
                dev_idle[dev] = False
                dev_draining[dev] = False
                dev_epoch[dev] += 1
                for rj in reps_on_dev.get(dev, []):
                    dropped = self.queues[rj].pop_batch(
                        len(self.queues[rj]))
                    if self._traw is not None:
                        for req, _ in dropped:
                            self._traw(("close", t, req.rid, "revoked"))
            else:  # fail
                dev_alive[dev] = False
                dev_idle[dev] = False
                dev_draining[dev] = False
                dev_epoch[dev] += 1
                drain_queues(t, dev)

        for ev_t, ev_d, ev_kind, ev_f in validate_device_events(
                device_events, n_dev):
            push_event(ev_t, "devevent", (ev_d, ev_kind, ev_f))

        meas_end = self.cfg.measure_interval
        arr_ptr = 0
        inf = float("inf")
        while True:
            t_arr = arrivals[arr_ptr] if arr_ptr < n_arr else inf
            t_evt = heap[0][0] if heap else inf
            t = min(t_arr, t_evt, meas_end)
            if t > horizon or t == inf:
                break
            if t == meas_end and t < min(t_arr, t_evt):
                with self._count_lock:
                    measured = self._arr_count / self.cfg.measure_interval
                    self._arr_count = 0
                self._gear_step(t, measured)
                meas_end += self.cfg.measure_interval
                continue
            if t_arr <= t_evt:
                ridx = self.submit(requests[arr_ptr], now=t_arr)
                arr_ptr += 1
                on_enqueue(ridx, t_arr)
            else:
                _, _, kind, payload = heapq.heappop(heap)
                if kind == "complete":
                    ridx, batch, epoch = payload
                    dev = replicas[ridx].device
                    if epoch != dev_epoch[dev]:
                        if epoch in revoked.get(dev, ()):
                            # the batch died WITH the revoked spot machine:
                            # its requests are shed, never resolved
                            if self._traw is not None:
                                for req, _ in batch:
                                    self._traw(("close", t_evt, req.rid,
                                                "revoked"))
                            continue
                        # device died mid-batch: re-issue the in-flight
                        # work on a sibling (the request objects were never
                        # resolved, so no duplicate completions arise)
                        alt = sibling_replica(ridx)
                        if alt is not None:
                            for req, _ in batch:
                                self.queues[alt].push(req, t_evt)
                                if self._traw is not None:
                                    self._traw(("reissue", t_evt, req.rid,
                                                req.stage))
                                push_event(t_evt + max_wait, "timeout",
                                           (alt,))
                        continue
                    self._run_batch(replicas[ridx].model, batch, now=t_evt,
                                    on_enqueue=on_enqueue)
                    if dev_alive[dev]:
                        dev_idle[dev] = True
                        for rj in reps_on_dev.get(dev, []):
                            try_fire(rj, t_evt)
                            if not dev_idle[dev]:
                                break
                elif kind == "timeout":
                    try_fire(payload[0], t_evt)
                else:  # devevent
                    on_device_event(t_evt, *payload)

        return list(self.completed)


# ---------------------------------------------------------------------------
# Multi-tenant frontend (core/tenancy.py)
# ---------------------------------------------------------------------------

class MultiTenantServer:
    """Several tenants' gear ladders served over ONE shared fleet.

    The tenant extension of ``CascadeServer``: per-tenant
    ``SchedulerCore``s (own selector, own decision trace, own drift
    monitor) with KEYED per-tenant route-RNG streams, shared tenant-tagged
    replica queues (one fired batch may mix tenants — execution is
    per-model, continuation is per-sample under the admitting gear), the
    ``AdmissionController`` hooks (downgrade / weighted-fair / shed) on
    the submit path, and per-tenant ``PlanLifecycle``s so a drifted
    tenant's ladder hot-swaps without touching anyone else's.

    Threaded mode serves wall-clock traffic; ``run_virtual`` drives the
    identical decision path deterministically and is decision-trace
    comparable to ``ServingSimulator.run_multi_tenant``
    (tests/test_tenancy.py).
    """

    def __init__(self, mt_plan, engines: Optional[Dict[str,
                                                       InferenceEngine]]
                 = None, estimator="top2_gap", alpha: float = 8.0,
                 measure_interval: float = 0.1, max_wait: float = 0.05,
                 max_batch: int = 128, seed: int = 0, admission=None,
                 lifecycles: Optional[Dict] = None,
                 decision_traces: Optional[Dict[str, DecisionTrace]] = None,
                 fleet_trace: Optional[DecisionTrace] = None,
                 backend: Optional[ExecutionBackend] = None,
                 route_pools: Optional[Dict[str, RoutePool]] = None,
                 telemetry=None):
        self.mt_plan = mt_plan
        self.names: List[str] = list(mt_plan.names)
        self._tidx = {n: i for i, n in enumerate(self.names)}
        self.replicas = mt_plan.replicas
        self.backend = backend if backend is not None \
            else EngineBackend(engines or {}, estimator=estimator)
        self.cfg = SchedulerConfig(
            max_wait=max_wait, measure_interval=measure_interval,
            alpha=alpha, max_batch=max_batch, seed=seed)
        self.admission = admission
        self.fleet_trace = fleet_trace
        # pure observer: span ids are (tenant, rid) pairs — per-tenant
        # request ids may collide across tenants
        self.telemetry = telemetry
        self._traw = telemetry.raw.append if telemetry is not None else None
        # per-tenant: (plan, cur gear, epoch) swapped atomically, core,
        # keyed route pool, lifecycle
        self._active: List[Tuple] = []
        self.cores: List[SchedulerCore] = []
        self.pools: List[RoutePool] = []
        self.lifecycles: List = []
        for n in self.names:
            plan = mt_plan.plans[n]
            self._active.append((plan, 0, 0))
            tr = decision_traces.get(n) if decision_traces else None
            core = SchedulerCore(
                self.replicas, self.cfg,
                selector=with_hysteresis(plan_target(plan), alpha),
                trace=tr)
            lc = lifecycles.get(n) if lifecycles else None
            if lc is not None:
                lc.attach(core)
            self.cores.append(core)
            self.pools.append(
                route_pools.get(n) if route_pools and n in route_pools
                else RoutePool(seed, key=n))
            self.lifecycles.append(lc)
        self.queues: List[_TenantReplicaQueue] = [
            _TenantReplicaQueue(len(self.names)) for _ in self.replicas]
        self._arr_counts = [0] * len(self.names)
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self.completed: Dict[str, List[Request]] = {n: [] for n in
                                                    self.names}
        self.shed_counts: Dict[str, int] = {n: 0 for n in self.names}
        self.offered_counts: Dict[str, int] = {n: 0 for n in self.names}
        self._done_lock = threading.Lock()
        self.gear_switches: Dict[str, List] = {n: [] for n in self.names}
        self.plan_swaps: Dict[str, List] = {n: [] for n in self.names}
        self._threads: List[threading.Thread] = []

    # --------------------------------------------------- decision steps
    def submit(self, req: Request, now: Optional[float] = None) -> int:
        """One arrival of ``req.tenant``: measured-QPS count, admission
        verdict (shed = return -1, no fleet state touched), then route to
        a replica queue of the tenant's current gear. Mirrors the
        simulator's arrival branch decision for decision."""
        ti = self._tidx[req.tenant]
        t = time.monotonic() if now is None else now
        req.t_arrive = t
        with self._count_lock:
            self._arr_counts[ti] += 1
            self.offered_counts[req.tenant] += 1
        if self.admission is not None and \
                not self.admission.admit(req.tenant):
            with self._done_lock:
                self.shed_counts[req.tenant] += 1
            if self._traw is not None:
                # a shed request still opens (and immediately closes) a
                # span — conservation counts it on the offered side
                self._traw(("admit", t, (req.tenant, req.rid),
                            self._active[ti][1], self._active[ti][2],
                            req.tenant))
                self._traw(("close", t, (req.tenant, req.rid), "shed"))
            return -1
        plan, cur, epoch = self._active[ti]
        req.gear_idx = cur
        gear = plan.gears[cur]
        req.gear = gear
        req.plan_epoch = epoch
        req.stage = 0
        if self._traw is not None:
            self._traw(("admit", t, (req.tenant, req.rid), cur, epoch,
                        req.tenant))
        ridx = self.cores[ti].route(gear.cascade.models[0], gear,
                                    self.pools[ti].next())
        self.queues[ridx].push_tenant(req, t, ti)
        return ridx

    def _gear_step(self, now: float, measured: Dict[str, float]) -> None:
        """One producer tick for every tenant, in tenant order — the same
        sequence the simulator's measurement branch runs: lifecycle step
        (+ atomic per-tenant swap), admission tick, then gear selection
        (admission's downgrade overrides the selector while engaged)."""
        for ti, n in enumerate(self.names):
            plan, cur, epoch = self._active[ti]
            lc = self.lifecycles[ti]
            if lc is not None:
                swap = lc.step(now, measured[n], cur)
                if swap is not None:
                    self._active[ti] = (swap.plan, swap.new_gear,
                                        swap.epoch)
                    if swap.selector is not None:
                        self.cores[ti].selector = swap.selector
                    self.plan_swaps[n].append((now, swap.epoch,
                                               swap.reason))
                    if swap.new_gear != cur:
                        self.gear_switches[n].append((now, swap.new_gear))
        if self.admission is not None:
            self.admission.on_tick(
                now, measured,
                {n: self._active[ti][1]
                 for ti, n in enumerate(self.names)})
        for ti, n in enumerate(self.names):
            plan, cur, epoch = self._active[ti]
            d = self.admission.decision(n) \
                if self.admission is not None else None
            if d is not None and d.force_cheapest:
                tgt = min(self.admission.cheapest[n], len(plan.gears) - 1)
                if tgt != cur:
                    self.gear_switches[n].append((now, tgt))
                    if self.cores[ti].trace is not None:
                        self.cores[ti].trace.gear_switches.append(
                            (cur, tgt))
                    self._active[ti] = (plan, tgt, epoch)
                continue
            m0 = plan.gears[cur].cascade.models[0]
            q0 = 0
            for ridx in self.cores[ti].reps_of.get(m0, []):
                q0 += self.queues[ridx].counts[ti]
            new = self.cores[ti].select_gear(now, measured[n], cur, q0,
                                             len(plan.gears))
            if new != cur:
                self.gear_switches[n].append((now, new))
                self._active[ti] = (plan, new, epoch)

    def _poll_replica(self, ridx: int, now: float) -> Optional[List]:
        q = self.queues[ridx]
        qlen = len(q)
        if not qlen:
            return None
        model = self.replicas[ridx].model
        from repro_torch.core.tenancy import effective_trigger
        trig = effective_trigger(
            model, q.counts,
            [self._active[ti][0].gears[self._active[ti][1]]
             for ti in range(len(self.names))])
        head = q.head_time()
        head_wait = head_of_line_wait(now, head, self.cfg.max_wait) \
            if head is not None else 0.0
        if not self.cores[0].fire_at(qlen, head_wait, trig):
            return None
        batch = q.pop_batch_tenant(self.cores[0].batch_size(qlen),
                                   self._tidx)
        if not batch:
            return None
        if self.fleet_trace is not None:
            self.fleet_trace.record_fire(ridx, [r.rid for r, _ in batch])
        if self._traw is not None:
            self._traw(("fire", now, ridx,
                        tuple((r.tenant, r.rid) for r, _ in batch)))
        return batch

    def _run_batch(self, model: str, batch: List,
                   now: Optional[float] = None,
                   on_enqueue: Optional[Callable[[int, float], None]]
                   = None) -> None:
        reqs = [r for r, _ in batch]
        ex = self.backend.execute(model, [r.rid for r in reqs],
                                  tokens=[r.tokens for r in reqs])
        certs, preds = ex.certs, ex.preds
        t = time.monotonic() if now is None else now
        for i, req in enumerate(reqs):
            ti = self._tidx[req.tenant]
            gear = req.gear
            hop = self.cores[ti].next_hop(req.stage, float(certs[i]), gear)
            if isinstance(hop, CascadeHop):
                if self._traw is not None:
                    self._traw(("escalate", t, (req.tenant, req.rid),
                                req.stage))
                req.stage = hop.next_stage
                ridx = self.cores[ti].route(hop.next_model, gear,
                                            self.pools[ti].next())
                self.queues[ridx].push_tenant(req, t, ti)
                if on_enqueue is not None:
                    on_enqueue(ridx, t)
            else:
                req.t_done = t
                req.pred = int(preds[i]) if preds is not None else -1
                req.cert = float(certs[i])
                req.resolver = hop.stage
                if self._traw is not None:
                    self._traw(("close", t, (req.tenant, req.rid),
                                "completed"))
                with self._done_lock:
                    self.completed[req.tenant].append(req)

    # -------------------------------------------------- threaded drivers
    def _producer_loop(self):
        while not self._stop.is_set():
            time.sleep(self.cfg.measure_interval)
            with self._count_lock:
                measured = {n: self._arr_counts[ti] /
                            self.cfg.measure_interval
                            for ti, n in enumerate(self.names)}
                self._arr_counts = [0] * len(self.names)
            self._gear_step(time.monotonic(), measured)

    def _consumer_loop(self, device: int):
        my_reps = self.cores[0].reps_on_dev.get(device, [])
        while not self._stop.is_set():
            ran = False
            now = time.monotonic()
            for ridx in my_reps:
                batch = self._poll_replica(ridx, now)
                if batch:
                    self._run_batch(self.replicas[ridx].model, batch)
                    ran = True
            if not ran:
                time.sleep(0.0005)

    def start(self) -> None:
        for lc in self.lifecycles:
            if lc is not None and lc.replanner is not None:
                lc.replanner.threaded = True
        self._stop.clear()
        self._threads = [threading.Thread(target=self._producer_loop,
                                          daemon=True)]
        for d in range(self.mt_plan.num_devices):
            self._threads.append(threading.Thread(
                target=self._consumer_loop, args=(d,), daemon=True))
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    def run_trace(self, requests: Dict[str, Sequence[Request]],
                  traces: Dict[str, np.ndarray], drain: float = 2.0
                  ) -> Dict[str, List[Request]]:
        """Wall-clock open-loop replay of superposed tenant traces."""
        from repro_torch.core.tenancy import merge_tenant_arrivals
        times, tidx, lidx = merge_tenant_arrivals(traces, self.names)
        self.start()
        t0 = time.monotonic()
        for k in range(len(times)):
            delay = t0 + times[k] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            req = requests[self.names[int(tidx[k])]][int(lidx[k])]
            req.tenant = self.names[int(tidx[k])]
            self.submit(req)
        time.sleep(drain)
        self.stop()
        return {n: list(v) for n, v in self.completed.items()}

    # ------------------------------------------------- virtual-time driver
    def run_virtual(self, requests: Dict[str, Sequence[Request]],
                    traces: Dict[str, np.ndarray],
                    batch_runtime: Optional[Callable[[str, int], float]]
                    = None, drain: float = 2.0
                    ) -> Dict[str, List[Request]]:
        """Deterministic virtual-time replay, decision-comparable to
        ``ServingSimulator.run_multi_tenant`` (same event ordering as the
        single-tenant ``run_virtual``)."""
        from repro_torch.core.tenancy import merge_tenant_arrivals
        if batch_runtime is None:
            batch_runtime = self.backend.batch_runtime
        times, tidx, lidx = merge_tenant_arrivals(traces, self.names)
        n_arr = len(times)
        times_l = times.tolist()
        horizon = float(max((len(traces.get(n, ())) for n in self.names),
                            default=0)) + drain
        replicas = self.replicas
        reps_on_dev = self.cores[0].reps_on_dev
        max_wait = self.cfg.max_wait
        dev_idle = [True] * self.mt_plan.num_devices

        heap: List[Tuple[float, int, str, tuple]] = []
        seq = 0

        def push_event(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        def try_fire(ridx: int, t: float):
            dev = replicas[ridx].device
            if not dev_idle[dev]:
                return
            batch = self._poll_replica(ridx, t)
            if not batch:
                return
            rt = batch_runtime(replicas[ridx].model, len(batch))
            dev_idle[dev] = False
            push_event(t + rt, "complete", (ridx, batch))

        def on_enqueue(ridx: int, t: float):
            try_fire(ridx, t)
            if len(self.queues[ridx]):
                push_event(t + max_wait, "timeout", (ridx,))

        meas_end = self.cfg.measure_interval
        arr_ptr = 0
        inf = float("inf")
        while True:
            t_arr = times_l[arr_ptr] if arr_ptr < n_arr else inf
            t_evt = heap[0][0] if heap else inf
            t = min(t_arr, t_evt, meas_end)
            if t > horizon or t == inf:
                break
            if t == meas_end and t < min(t_arr, t_evt):
                with self._count_lock:
                    measured = {n: self._arr_counts[ti] /
                                self.cfg.measure_interval
                                for ti, n in enumerate(self.names)}
                    self._arr_counts = [0] * len(self.names)
                self._gear_step(t, measured)
                meas_end += self.cfg.measure_interval
                continue
            if t_arr <= t_evt:
                n = self.names[int(tidx[arr_ptr])]
                req = requests[n][int(lidx[arr_ptr])]
                req.tenant = n
                ridx = self.submit(req, now=t_arr)
                arr_ptr += 1
                if ridx >= 0:
                    on_enqueue(ridx, t_arr)
            else:
                _, _, kind, payload = heapq.heappop(heap)
                if kind == "complete":
                    ridx, batch = payload
                    dev = replicas[ridx].device
                    self._run_batch(replicas[ridx].model, batch, now=t_evt,
                                    on_enqueue=on_enqueue)
                    dev_idle[dev] = True
                    for rj in reps_on_dev.get(dev, []):
                        try_fire(rj, t_evt)
                        if not dev_idle[dev]:
                            break
                else:  # timeout
                    try_fire(payload[0], t_evt)

        return {n: list(v) for n, v in self.completed.items()}
