"""Verbatim copy of ``repro/core/simulator.py``,
imports rewritten to ``repro_torch``.

Discrete-event serving simulator (paper Appendix C).

Mirrors the online system exactly: requests arrive, the producer measures
QPS each interval and switches gears (with the α-hysteresis of §5), samples
queue at the first model's replicas, the consumer triggers a batch when a
replica's queue reaches the gear's min-queue-length (or a head-of-line
timeout fires), the device is blocked for the batch runtime, and non-certain
samples cascade to the next model at batch completion.

Every serving *decision* — routing, gear selection, batch trigger, cascade
continuation — is delegated to the shared ``repro.core.scheduling
.SchedulerCore``; model *execution* — per-sample predictions/certainty/
correctness and per-batch runtimes — is obtained exclusively through an
``repro.core.execution.ExecutionBackend``. This module is only the
discrete-event *driver* (state, time, the event heap). The default backend
is ``ReplayBackend`` (validation-record replay, App. C physics); an
``EngineBackend`` instead runs REAL jitted models under the virtual clock.
The threaded ``repro.serving.runtime.CascadeServer`` drives the very same
core and backend layer, so simulator and real system cannot drift
(DESIGN.md §2/§9; parity is asserted by ``tests/test_scheduling_parity.py``).

Also executes *ensemble* gears (all members vote; used by the Cocktail+
baseline) through the same machinery.

One simulator core serves three callers: the gear planner (fixed-QPS
feasibility + latency checks), plan evaluation, and the baseline policies in
``repro.serving.baselines``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cascade import Cascade
from repro_torch.core.certainty import StreamingCertainty
from repro_torch.core.execution import (ExecutionBackend, ReplayBackend,
                                  TokenReplayBackend)
from repro_torch.core.gears import Gear, GearPlan, uniform_load_fractions
from repro_torch.core.lp import Replica
from repro_torch.core.profiles import ProfileSet
from repro_torch.core.scheduling import (CascadeHop, ContinuousBatcher,
                                   DecisionTrace, GearSelector, Resolved,
                                   RoutePool, SchedulerConfig, SchedulerCore,
                                   head_of_line_wait, is_ensemble,
                                   majority_vote, plan_target,
                                   with_hysteresis)

__all__ = ["SimConfig", "SimResult", "TokenSimResult", "ServingSimulator",
           "GearSelector", "trace_to_arrivals", "make_gear",
           "validate_device_events"]


@dataclass(frozen=True)
class SimConfig(SchedulerConfig):
    """Shared scheduling knobs plus simulator-only calibration."""
    # fixed per-batch serving overhead (queueing machinery, dispatch),
    # calibrated against the real runtime (bench_simulator_fidelity)
    dispatch_overhead: float = 0.0


@dataclass
class SimResult:
    latencies: np.ndarray           # per completed sample, seconds
    correct: np.ndarray             # per completed sample, bool
    arrive_times: np.ndarray
    complete_times: np.ndarray
    resolver: np.ndarray            # index of resolving model in its cascade
    completed: int
    offered: int
    backlog_end: int
    device_busy: np.ndarray         # busy seconds per device
    horizon: float
    # samples permanently lost to spot revokes ("revoke" events): they were
    # resident on the machine when it vanished and had no live hedge copy.
    # Disjoint from backlog_end, which is recoverable work still in flight.
    shed: int = 0
    gear_switches: List[Tuple[float, int]] = field(default_factory=list)
    per_model_batches: Dict[str, int] = field(default_factory=dict)
    per_model_samples: Dict[str, int] = field(default_factory=dict)
    # plan hot-swaps applied during the run: (time, epoch, reason)
    plan_swaps: List[Tuple[float, int, str]] = field(default_factory=list)
    # False when the backend could not report correctness for some batch
    # (e.g. an EngineBackend without a label pool): latency metrics are
    # valid, accuracy is UNKNOWN (nan), not zero
    correctness_known: bool = True

    @property
    def accuracy(self) -> float:
        if not self.correctness_known:
            return math.nan
        return float(self.correct.mean()) if self.completed else 0.0

    def latency_quantile(self, q: float = 0.95) -> float:
        if not self.completed:
            return math.inf
        return float(np.quantile(self.latencies, q))

    @property
    def p95(self) -> float:
        return self.latency_quantile(0.95)

    @property
    def throughput(self) -> float:
        return self.completed / self.horizon if self.horizon else 0.0

    @property
    def stable(self) -> bool:
        """Backlog at horizon bounded (no unbounded queue growth)."""
        allow = max(64.0, 0.05 * self.offered)
        return self.backlog_end <= allow and \
            self.completed >= 0.9 * (self.offered - allow)

    @property
    def utilization(self) -> float:
        return float(self.device_busy.mean() / self.horizon) \
            if self.horizon else 0.0


class _ArrayQueue:
    """Flat ring-buffer replica queue of (sample id, stage, enqueue time).

    Replaces the previous three-deque replica queue: each field lives in one
    preallocated flat ring array, so a batch pop is a contiguous slice copy
    (two when the ring wraps) instead of ``3 * batch_size`` popleft calls +
    per-sample tuple builds, and the head-of-line time is a single indexed
    read. Slots are plain Python lists because the hot path is scalar reads
    and writes — numpy's per-element coercion is ~3x slower there.
    """
    __slots__ = ("sid", "stage", "t", "head", "n", "cap")

    def __init__(self, cap: int = 64):
        self.sid = [0] * cap
        self.stage = [0] * cap
        self.t = [0.0] * cap
        self.head = 0
        self.n = 0
        self.cap = cap

    def __len__(self) -> int:
        return self.n

    def head_time(self) -> float:
        return self.t[self.head]

    def push(self, sid: int, stage: int, t: float) -> None:
        cap = self.cap
        if self.n == cap:
            self._grow()
            cap = self.cap
        tail = self.head + self.n
        if tail >= cap:
            tail -= cap
        self.sid[tail] = sid
        self.stage[tail] = stage
        self.t[tail] = t
        self.n += 1

    def push_block(self, sids: List[int], stages: List[int],
                   ts: List[float]) -> None:
        """Bulk ``push``: append ``len(sids)`` entries in order with two
        slice writes instead of per-sample calls (used by the lane-batched
        simulator's no-fire commit paths)."""
        k = len(sids)
        while self.cap - self.n < k:
            self._grow()
        cap = self.cap
        tail = self.head + self.n
        if tail >= cap:
            tail -= cap
        end = tail + k
        if end <= cap:
            self.sid[tail:end] = sids
            self.stage[tail:end] = stages
            self.t[tail:end] = ts
        else:
            cut = cap - tail
            self.sid[tail:] = sids[:cut]
            self.stage[tail:] = stages[:cut]
            self.t[tail:] = ts[:cut]
            end -= cap
            self.sid[:end] = sids[cut:]
            self.stage[:end] = stages[cut:]
            self.t[:end] = ts[cut:]
        self.n += k

    def _grow(self) -> None:
        cap, h = self.cap, self.head
        self.sid = self.sid[h:] + self.sid[:h] + [0] * cap
        self.stage = self.stage[h:] + self.stage[:h] + [0] * cap
        self.t = self.t[h:] + self.t[:h] + [0.0] * cap
        self.head = 0
        self.cap = cap * 2

    def pop(self, k: int) -> Tuple[List[int], List[int]]:
        """Pop the ``k`` oldest entries -> (sample ids, stages)."""
        cap, h = self.cap, self.head
        end = h + k
        if end <= cap:
            sids = self.sid[h:end]
            stages = self.stage[h:end]
        else:
            sids = self.sid[h:] + self.sid[:end - cap]
            stages = self.stage[h:] + self.stage[:end - cap]
        self.head = end % cap
        self.n -= k
        return sids, stages


# (time, device, kind, factor): kind in {"fail", "slow", "recover", "drain",
# "netdeg"}. "drain" is a spot-preemption notice: new routing moves off the
# device while it keeps serving its queued batches, racing the revoke
# deadline (factor carries the warning lead, for observability). "revoke"
# is the spot machine actually vanishing: same teardown as "fail", but the
# work still resident on the device (queued samples and the in-flight
# batch) is LOST — shed, never replayed — because the machine that held it
# no longer exists. "fail" keeps replay semantics: it models a crash where
# the serving layer re-issues everything to siblings. "netdeg" (device
# must be -1) is fleet-wide dispatch degradation: every batch runtime is
# multiplied by `factor` until a second netdeg resets it to 1.0.
DeviceEvent = Tuple[float, int, str, float]

_EVENT_KINDS = frozenset(
    ("fail", "slow", "recover", "drain", "revoke", "netdeg"))


def validate_device_events(events: Optional[List[DeviceEvent]],
                           num_devices: int) -> List[DeviceEvent]:
    """Validate a ``DeviceEvent`` stream at driver entry.

    Checks shape, time-sortedness, known kinds, device range (``-1`` only
    for the fleet-wide ``netdeg``), and factor sign (multiplicative kinds
    need ``factor > 0``; fail/recover/drain/revoke carry informational
    factors that only need to be non-negative). Raises ``ValueError`` instead of
    letting a malformed stream silently mis-simulate. Returns the stream
    as a normalized list of plain tuples."""
    if not events:
        return []
    out: List[DeviceEvent] = []
    prev_t = -math.inf
    for i, ev in enumerate(events):
        try:
            t, dev, kind, factor = ev
            t, dev, factor = float(t), int(dev), float(factor)
        except (TypeError, ValueError):
            raise ValueError(
                f"device event #{i} must be a (time, device, kind, factor) "
                f"tuple, got {ev!r}")
        if t < 0:
            raise ValueError(f"device event #{i}: time must be >= 0, "
                             f"got {t}")
        if t < prev_t:
            raise ValueError(
                f"device event #{i}: stream must be sorted by time "
                f"({t} after {prev_t})")
        prev_t = t
        if kind not in _EVENT_KINDS:
            raise ValueError(
                f"device event #{i}: unknown kind {kind!r} (expected one "
                f"of {sorted(_EVENT_KINDS)})")
        if kind == "netdeg":
            if dev != -1:
                raise ValueError(
                    f"device event #{i}: netdeg is fleet-wide, device must "
                    f"be -1, got {dev}")
            if factor <= 0:
                raise ValueError(
                    f"device event #{i}: netdeg factor must be > 0, "
                    f"got {factor}")
        else:
            if not 0 <= dev < num_devices:
                raise ValueError(
                    f"device event #{i}: device {dev} out of range "
                    f"[0, {num_devices})")
            if kind == "slow" and factor <= 0:
                raise ValueError(
                    f"device event #{i}: slow-down factor must be > 0, "
                    f"got {factor}")
            if factor < 0:
                raise ValueError(
                    f"device event #{i}: factor must be >= 0, got {factor}")
        out.append((t, dev, kind, factor))
    return out


@dataclass
class TokenSimResult:
    """Per-request outcome of a token-level run (``run_token_trace``).

    ``first_token`` is the time the RESOLVING stage emitted its first token
    (a mid-stream escalation restarts the clock at the next model — the
    abandoned stream's tokens were never the answer); ``tokens_out`` is the
    resolving stage's generation length. ``total_tokens`` additionally
    counts every token of abandoned streams (wasted decode work)."""
    arrive: np.ndarray              # (completed,) seconds
    first_token: np.ndarray         # (completed,) seconds
    complete: np.ndarray            # (completed,) seconds
    tokens_out: np.ndarray          # (completed,) int
    correct: np.ndarray             # (completed,) bool
    resolver: np.ndarray            # (completed,) resolving cascade stage
    offered: int
    completed: int
    horizon: float
    total_tokens: int = 0
    device_busy: np.ndarray = field(default_factory=lambda: np.zeros(1))
    per_model_steps: Dict[str, int] = field(default_factory=dict)
    # step-time breakdown: busy seconds split by phase per model (prefill
    # = join phases, decode = resident-batch steps); sums to device_busy
    per_model_prefill_time: Dict[str, float] = field(default_factory=dict)
    per_model_decode_time: Dict[str, float] = field(default_factory=dict)

    @property
    def accuracy(self) -> float:
        return float(self.correct.mean()) if self.completed else 0.0

    @property
    def ttft(self) -> np.ndarray:
        return self.first_token - self.arrive

    @property
    def tpot(self) -> np.ndarray:
        """Mean seconds per output token after the first, per request."""
        return (self.complete - self.first_token) \
            / np.maximum(self.tokens_out - 1, 1)

    def ttft_p95(self) -> float:
        return float(np.quantile(self.ttft, 0.95)) if self.completed \
            else math.inf

    def tpot_p95(self) -> float:
        return float(np.quantile(self.tpot, 0.95)) if self.completed \
            else math.inf

    @property
    def token_throughput(self) -> float:
        """Useful (resolving-stage) tokens per second of makespan."""
        if not self.completed:
            return 0.0
        span = float(self.complete.max() - self.arrive.min())
        return float(self.tokens_out.sum()) / max(span, 1e-9)


class ServingSimulator:
    """Backend-agnostic discrete-event driver.

    ``backend`` supplies all execution physics (default: ``ReplayBackend``
    over ``profiles`` — the App. C validation replay). ``profiles`` remains
    the planner-facing artifact set and the default backend source.
    """

    def __init__(self, profiles: ProfileSet, replicas: Sequence[Replica],
                 num_devices: int, cfg: SimConfig = SimConfig(),
                 backend: Optional[ExecutionBackend] = None,
                 telemetry=None):
        # explicit ValueError, not assert: validation must survive python -O
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        self.profiles = profiles
        self.replicas = list(replicas)
        self.num_devices = num_devices
        self.cfg = cfg
        self.backend = backend or ReplayBackend(profiles)
        # optional core.telemetry.Telemetry: a pure observer — when None
        # (the default) every hook below is a single predicate test, and
        # when set the hooks only append flat event tuples / set gauges,
        # so decisions (and the golden fingerprint) are bit-identical
        # either way
        self.telemetry = telemetry

    # ------------------------------------------------------------------ API
    def run_fixed(self, gear: Gear, qps: float, horizon: float = 2.0,
                  warm_start_backlog: int = 0) -> SimResult:
        """Constant-rate arrivals; the gear never changes (planner use)."""
        if qps < 0:
            raise ValueError(f"qps must be >= 0, got {qps}")
        if horizon <= 0:
            raise ValueError(f"horizon must be positive, got {horizon}")
        if warm_start_backlog < 0:
            raise ValueError(f"warm_start_backlog must be >= 0, got "
                             f"{warm_start_backlog}")
        n = int(qps * horizon)
        arrivals = (np.arange(n) + 0.5) / max(qps, 1e-9)
        if warm_start_backlog:
            arrivals = np.concatenate(
                [np.zeros(warm_start_backlog), arrivals])
        return self._run(arrivals, [gear], lambda t, q, g, q0: 0,
                         horizon=horizon)

    def run_trace(self, plan: GearPlan,
                  qps_per_sec: Optional[np.ndarray] = None,
                  drain: float = 2.0,
                  device_events: Optional[List[DeviceEvent]] = None,
                  on_failure: Optional[Callable] = None,
                  hedge=None,
                  decision_trace: Optional[DecisionTrace] = None,
                  lifecycle=None, scenario=None) -> SimResult:
        """Replay a trace (per-second QPS) with the §5 producer policy.

        ``lifecycle`` (a ``repro.core.adaption.PlanLifecycle`` over the
        same plan) enables online re-planning: it is stepped at every
        measurement tick and its ``SwapEvent``s are applied atomically
        (new gear table + QPS-remapped gear index + new selector).

        ``scenario`` (a ``repro.core.scenarios.Scenario``) is the
        declarative spelling: it supplies the trace, the device-event
        stream, and the drain window in one object and is mutually
        exclusive with explicit ``qps_per_sec``/``device_events``.
        """
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
        return self._run(arrivals, plan.gears, selector, horizon=horizon,
                         device_events=device_events, on_failure=on_failure,
                         hedge=hedge, decision_trace=decision_trace,
                         lifecycle=lifecycle)

    def run_multi_tenant(self, mt_plan, traces, drain: float = 2.0,
                         admission=None, lifecycles=None,
                         decision_traces=None, fleet_trace=None):
        """Superposed multi-tenant traffic over the shared placement
        (core/tenancy.py): per-tenant gear ladders, tenant-tagged queues,
        admission control, per-tenant lifecycles. Returns
        ``{tenant: TenantResult}``."""
        from repro_torch.core.tenancy import run_multi_tenant_sim
        return run_multi_tenant_sim(
            self, mt_plan, traces, drain=drain, admission=admission,
            lifecycles=lifecycles, decision_traces=decision_traces,
            fleet_trace=fleet_trace)

    def run_policy(self, gears: List[Gear], selector: GearSelector,
                   qps_per_sec: np.ndarray, drain: float = 2.0,
                   decision_trace: Optional[DecisionTrace] = None
                   ) -> SimResult:
        """Custom gear list + selector (baseline policies)."""
        arrivals = trace_to_arrivals(qps_per_sec)
        horizon = float(len(qps_per_sec)) + drain
        return self._run(arrivals, gears, selector, horizon=horizon,
                         decision_trace=decision_trace)

    # ------------------------------------------------- token-level execution
    def run_token_trace(self, gear: Gear, arrivals: np.ndarray,
                        prompt_lens: np.ndarray,
                        token_backend: TokenReplayBackend,
                        mode: str = "continuous", n_slots: int = 8,
                        min_tokens: int = 4, early_margin: float = 0.5,
                        stream_mode: str = "ewma", beta: float = 0.35,
                        horizon: Optional[float] = None,
                        decision_trace: Optional[DecisionTrace] = None
                        ) -> TokenSimResult:
        """Token-level discrete-event mode (DESIGN.md §13).

        Each request is a (prompt length, generation) pair; execution
        physics come from ``token_backend`` (prompt-proportional prefill,
        batch-dependent per-token decode steps, per-token certainty-gap
        streams). Two scheduling modes over the SAME decisions layer:

        * ``continuous`` — requests join/leave the running decode batch at
          token boundaries (``ContinuousBatcher``); a join inserts a
          prefill phase (phase split: the resident batch stalls while the
          joiners' prompts are processed), after which the enlarged batch
          decodes on.
        * ``rebatch`` — static batching baseline: a replica admits only
          when its batch has fully drained, forming batches with the
          ordinary ``should_fire`` trigger; stragglers hold the batch.

        Cascade decisions run mid-stream: per-token gaps fold into a
        ``StreamingCertainty`` and ``ContinuousBatcher.boundary_hop``
        resolves/escalates at token boundaries. An escalation carries the
        PROMPT to the next model (fresh prefill there), never the cache.
        """
        if mode not in ("continuous", "rebatch"):
            raise ValueError(f"mode must be continuous|rebatch, got {mode!r}")
        arrivals = np.asarray(arrivals, np.float64)
        prompt_lens = np.asarray(prompt_lens, np.int64)
        if arrivals.shape != prompt_lens.shape:
            raise ValueError(
                f"arrivals/prompt_lens shape mismatch: {arrivals.shape} vs "
                f"{prompt_lens.shape}")
        n_arr = len(arrivals)
        cfg = self.cfg
        replicas = self.replicas
        core = SchedulerCore(replicas, cfg, trace=decision_trace)
        pool = RoutePool.for_arrivals(cfg.seed, n_arr)
        if horizon is None:
            horizon = (float(arrivals[-1]) if n_arr else 0.0) + 120.0

        # telemetry (pure observer, same contract as _run): hot hooks are
        # one `is not None` test + a flat tuple append; token-path extras
        # are TTFT/TPOT histograms and per-replica KV-slot occupancy gauges
        telem = self.telemetry
        traw = telem.raw.append if telem is not None else None
        if telem is not None:
            h_ttft = telem.registry.histogram("token_ttft")
            h_tpot = telem.registry.histogram("token_tpot")
            g_slots = [telem.registry.gauge("kv_slots_active",
                                            replica=str(i))
                       for i in range(len(replicas))]

        # per-replica slot capacity: the gear's planned decode_slots when
        # present, else the uniform default
        slots_of = [gear.decode_slots.get(r.model, n_slots)
                    for r in replicas]
        batchers = [ContinuousBatcher(core, s, min_tokens=min_tokens,
                                      early_margin=early_margin)
                    for s in slots_of]

        # per-request records
        arrive_l = arrivals.tolist()
        plens = prompt_lens.tolist()
        first_tok = [math.nan] * n_arr
        complete = [math.nan] * n_arr
        tokens_out = [0] * n_arr
        correct = [False] * n_arr
        resolver = [-1] * n_arr
        total_tokens = 0

        # per-replica state: waiting queue + resident decode slots
        # (parallel lists per slot: request id, stage, tokens generated,
        # generation length, certainty fold)
        wait: List[_ArrayQueue] = [_ArrayQueue() for _ in replicas]
        act_rid: List[List[int]] = [[] for _ in replicas]
        act_stage: List[List[int]] = [[] for _ in replicas]
        act_pos: List[List[int]] = [[] for _ in replicas]
        act_gen: List[List[int]] = [[] for _ in replicas]
        act_str: List[List[StreamingCertainty]] = [[] for _ in replicas]
        pending: List[List[Tuple[int, int]]] = [[] for _ in replicas]
        dev_idle = np.ones(self.num_devices, bool)
        dev_busy = np.zeros(self.num_devices)
        per_model_steps: Dict[str, int] = {}
        pf_time: Dict[str, float] = {}
        dec_time: Dict[str, float] = {}
        reps_on_dev = core.reps_on_dev

        heap: List[Tuple[float, int, str, int]] = []
        seq = 0

        def push_event(t: float, kind: str, ridx: int):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, ridx))
            seq += 1

        def enqueue(rid: int, stage: int, model: str, t: float):
            # queue-enter is implied by the caller's admit/escalate event
            ridx = core.route(model, gear, pool.next())
            wait[ridx].push(rid, stage, t)
            poll(ridx, t)
            if wait[ridx].n and mode == "rebatch":
                push_event(t + cfg.max_wait, "timeout", ridx)

        def poll(ridx: int, t: float):
            """Start the next phase on ``ridx`` if its device is idle:
            prefill for admitted joiners first (phase split), else one
            decode step over the resident batch."""
            r = replicas[ridx]
            if not dev_idle[r.device]:
                return
            q = wait[ridx]
            n_act = len(act_rid[ridx])
            if mode == "continuous":
                joiners = batchers[ridx].admit(n_act, q.n)
            else:
                joiners = 0
                if n_act == 0 and q.n and core.should_fire(
                        q.n, head_of_line_wait(t, q.t[q.head], cfg.max_wait),
                        r.model, gear):
                    joiners = min(q.n, slots_of[ridx], cfg.max_batch)
            if joiners:
                rids, stages = q.pop(joiners)
                if decision_trace is not None:
                    decision_trace.record_fire(ridx, rids)
                if traw is not None:
                    traw(("fire", t, ridx, rids))
                pending[ridx] = list(zip(rids, stages))
                pf = token_backend.prefill_runtime(
                    r.model, sum(plens[rid] for rid in rids))
                dev_idle[r.device] = False
                dev_busy[r.device] += pf
                pf_time[r.model] = pf_time.get(r.model, 0.0) + pf
                push_event(t + pf, "pfdone", ridx)
            elif n_act:
                dt = token_backend.decode_step_runtime(r.model, n_act)
                dev_idle[r.device] = False
                dev_busy[r.device] += dt
                dec_time[r.model] = dec_time.get(r.model, 0.0) + dt
                per_model_steps[r.model] = \
                    per_model_steps.get(r.model, 0) + 1
                push_event(t + dt, "stepdone", ridx)

        def leave(ridx: int, k: int, t: float, hop) -> None:
            """Remove slot ``k`` from the resident batch per ``hop``."""
            rid = act_rid[ridx][k]
            stage = act_stage[ridx][k]
            if isinstance(hop, Resolved):
                complete[rid] = t
                tokens_out[rid] = act_pos[ridx][k]
                correct[rid] = token_backend.correct(
                    replicas[ridx].model, rid)
                resolver[rid] = stage
                if traw is not None:
                    traw(("close", t, rid, "completed"))
                    ft = first_tok[rid]
                    h_ttft.observe(ft - arrive_l[rid])
                    ntok = tokens_out[rid]
                    if ntok > 1:
                        h_tpot.observe((t - ft) / (ntok - 1))
            else:
                if traw is not None:
                    traw(("escalate", t, rid, stage))
                enqueue(rid, hop.next_stage, hop.next_model, t)
            for lst in (act_rid, act_stage, act_pos, act_gen, act_str):
                lst[ridx].pop(k)
            if telem is not None:
                g_slots[ridx].set(len(act_rid[ridx]))

        def boundary(ridx: int, t: float) -> None:
            """Apply per-request boundary decisions right-to-left (pops
            keep earlier indices valid)."""
            model = replicas[ridx].model
            for k in range(len(act_rid[ridx]) - 1, -1, -1):
                hop = batchers[ridx].boundary_hop(
                    act_stage[ridx][k], act_str[ridx][k].value,
                    act_pos[ridx][k], act_gen[ridx][k], gear)
                if hop is not None:
                    leave(ridx, k, t, hop)

        def release_device(dev: int, t: float) -> None:
            dev_idle[dev] = True
            for rj in reps_on_dev.get(dev, []):
                poll(rj, t)
                if not dev_idle[dev]:
                    break

        arr_ptr = 0
        inf = math.inf
        while True:
            t_arr = arrive_l[arr_ptr] if arr_ptr < n_arr else inf
            t_evt = heap[0][0] if heap else inf
            t = min(t_arr, t_evt)
            if t == inf or t > horizon:
                break
            if t_arr <= t_evt:
                rid = arr_ptr
                arr_ptr += 1
                if traw is not None:
                    traw(("admit", t_arr, rid, 0, 0, ""))
                enqueue(rid, 0, gear.cascade.models[0], t_arr)
                continue
            _, _, kind, ridx = heapq.heappop(heap)
            model = replicas[ridx].model
            if kind == "pfdone":
                # joiners become resident; prefill emits each request's
                # FIRST token (TTFT is measured here — re-stamped when a
                # later stage becomes the resolving stream)
                for rid, stage in pending[ridx]:
                    first_tok[rid] = t_evt
                    stream = StreamingCertainty(stream_mode, beta)
                    stream.update(token_backend.token_gap(model, rid, 0))
                    act_rid[ridx].append(rid)
                    act_stage[ridx].append(stage)
                    act_pos[ridx].append(1)
                    act_gen[ridx].append(
                        token_backend.gen_len(model, rid))
                    act_str[ridx].append(stream)
                    total_tokens += 1
                pending[ridx] = []
                if telem is not None:
                    g_slots[ridx].set(len(act_rid[ridx]))
                boundary(ridx, t_evt)
                release_device(replicas[ridx].device, t_evt)
            elif kind == "stepdone":
                for k in range(len(act_rid[ridx])):
                    pos = act_pos[ridx][k]
                    act_str[ridx][k].update(token_backend.token_gap(
                        model, act_rid[ridx][k], pos))
                    act_pos[ridx][k] = pos + 1
                total_tokens += len(act_rid[ridx])
                boundary(ridx, t_evt)
                release_device(replicas[ridx].device, t_evt)
            elif kind == "timeout":
                poll(ridx, t_evt)

        complete_a = np.asarray(complete, np.float64)
        done = ~np.isnan(complete_a)
        return TokenSimResult(
            arrive=arrivals[done],
            first_token=np.asarray(first_tok, np.float64)[done],
            complete=complete_a[done],
            tokens_out=np.asarray(tokens_out, np.int64)[done],
            correct=np.asarray(correct, bool)[done],
            resolver=np.asarray(resolver, np.int32)[done],
            offered=n_arr, completed=int(done.sum()), horizon=horizon,
            total_tokens=total_tokens, device_busy=dev_busy,
            per_model_steps=per_model_steps,
            per_model_prefill_time=pf_time,
            per_model_decode_time=dec_time)

    # ----------------------------------------------------------------- core
    def _run(self, arrivals: np.ndarray, gears: List[Gear],
             selector: GearSelector, horizon: float,
             device_events: Optional[List[DeviceEvent]] = None,
             on_failure: Optional[Callable] = None,
             hedge=None,
             decision_trace: Optional[DecisionTrace] = None,
             lifecycle=None) -> SimResult:
        cfg = self.cfg
        backend = self.backend
        replicas = self.replicas
        n_arr = len(arrivals)
        core = SchedulerCore(replicas, cfg, selector=selector,
                             trace=decision_trace)
        if lifecycle is not None:
            lifecycle.attach(core)
        pool = RoutePool.for_arrivals(cfg.seed, n_arr)

        # telemetry (pure observer): hot hooks are one `is not None` test
        # plus a flat tuple append on the raw span log; gauges update once
        # per measurement tick
        telem = self.telemetry
        traw = telem.raw.append if telem is not None else None
        if telem is not None:
            g_qps = telem.registry.gauge("sim_measured_qps")
            g_gear = telem.registry.gauge("sim_cur_gear")
            if lifecycle is not None:
                g_epoch = telem.registry.gauge("sim_plan_epoch")
            epoch0 = lifecycle.epoch if lifecycle is not None else 0

        # per-sample records (plain lists: the loop is scalar reads/writes,
        # where list indexing beats numpy's per-element boxing ~3x; converted
        # to arrays once at the end)
        arrive = np.asarray(arrivals, np.float64)
        arrive_l = arrive.tolist()
        complete = [math.nan] * n_arr
        correct = [False] * n_arr
        resolver = [-1] * n_arr
        # admitting gear OBJECT per sample: in-flight cascades must finish
        # on the plan that admitted them even across plan hot-swaps
        gear_of: List[Optional[Gear]] = [None] * n_arr
        # duplicate-suppression for hedged/re-issued work: a sample is only
        # processed at its current stage
        cur_stage = [0] * n_arr
        votes = {}   # ensemble mode: sid -> [n_remaining, n_correct, n_members]
        # per-batch-size runtime memo (same values as the backend returns;
        # avoids repeated interpolation on the hot path)
        rt_memo: Dict[Tuple[str, int], float] = {}
        ens_memo: Dict[int, Tuple[Gear, bool]] = {}

        def gear_is_ensemble(g: Gear) -> bool:
            ent = ens_memo.get(id(g))
            if ent is None or ent[0] is not g:
                ent = (g, is_ensemble(g))
                ens_memo[id(g)] = ent
            return ent[1]

        # state
        qs: List[_ArrayQueue] = [_ArrayQueue() for _ in replicas]
        dev_busy = np.zeros(self.num_devices)
        dev_idle = np.ones(self.num_devices, bool)
        dev_alive = np.ones(self.num_devices, bool)
        dev_speed = np.ones(self.num_devices)
        dev_epoch = np.zeros(self.num_devices, np.int64)
        # preemption drain windows: a draining device finishes its in-flight
        # batch (racing the revoke deadline) but starts nothing new and is
        # skipped as a re-issue/hedge sibling
        dev_draining = np.zeros(self.num_devices, bool)
        # epochs that ended in a spot revoke: an in-flight batch carrying
        # one of these epochs died WITH the machine — its samples are shed,
        # not re-issued (contrast "fail", where the batch is replayed)
        revoked: Dict[int, set] = {}
        shed_count = 0
        net = 1.0   # fleet-wide dispatch degradation multiplier ("netdeg")
        # hedge retry budget: hedges issued per live sample, and the replica
        # the live hedge copy went to (for the drain/fail refund)
        hedge_used: Dict[int, int] = {}
        hedged_to: Dict[int, int] = {}
        gears = list(gears)
        cur_gear = 0
        correctness_known = True
        switches: List[Tuple[float, int]] = []
        plan_swaps: List[Tuple[float, int, str]] = []
        per_model_batches: Dict[str, int] = {}
        per_model_samples: Dict[str, int] = {}
        reps_of = core.reps_of
        reps_on_dev = core.reps_on_dev

        # event heap: (time, seq, kind, payload)
        heap: List[Tuple[float, int, str, tuple]] = []
        seq = 0

        def push_event(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        def enqueue(sid: int, stage: int, model: str, t: float, gear: Gear):
            # no telemetry here: every caller's own event (admit, escalate,
            # reissue) implies this queue-enter at the same instant
            ridx = core.route(model, gear, pool.next())
            qs[ridx].push(sid, stage, t)
            per_model_samples[model] = per_model_samples.get(model, 0) + 1
            # consumer polls on enqueue (cascaded samples must not wait for
            # the next arrival to trigger their target device)
            try_start(ridx, t)
            if qs[ridx].n:
                # head-of-line timeout for this enqueue; skipped when the
                # sample already left with the batch fired above
                push_event(t + cfg.max_wait, "timeout", (ridx,))

        max_batch = cfg.max_batch

        def try_start(ridx: int, t: float):
            """Start a batch on replica ridx if triggered and device idle."""
            q = qs[ridx]
            qlen = q.n
            if not qlen:
                return
            r = replicas[ridx]
            if not dev_idle[r.device] or not dev_alive[r.device]:
                return
            gear = gears[cur_gear]
            if not core.should_fire(
                    qlen, head_of_line_wait(t, q.t[q.head], cfg.max_wait),
                    r.model, gear):
                return
            bsz = qlen if qlen < max_batch else max_batch
            sids, stages = q.pop(bsz)
            if decision_trace is not None:
                decision_trace.record_fire(ridx, sids)
            if traw is not None:
                # sids is a fresh list from q.pop and never mutated — safe
                # to share with the heap payload, no defensive copy
                traw(("fire", t, ridx, sids))
            rt = rt_memo.get((r.model, bsz))
            if rt is None:
                rt = backend.batch_runtime(r.model, bsz) \
                    + cfg.dispatch_overhead
                rt_memo[(r.model, bsz)] = rt
            # the hedge straggler test compares against the expected runtime
            # under current FLEET conditions (rt * net): a global dispatch
            # degradation is not one straggling device
            rt_eff = rt * net
            rt_actual = rt_eff * dev_speed[r.device]
            dev_idle[r.device] = False
            dev_busy[r.device] += rt_actual
            per_model_batches[r.model] = per_model_batches.get(r.model, 0) + 1
            push_event(t + rt_actual, "complete",
                       (ridx, sids, stages, dev_epoch[r.device]))
            if hedge is not None and hedge.enabled and \
                    rt_actual > hedge.hedge_multiplier * rt_eff:
                # straggler: re-issue on a sibling replica after the
                # expected runtime; duplicate completions are suppressed
                # by the per-sample stage guard
                push_event(t + rt_eff * hedge.hedge_multiplier, "hedge",
                           (ridx, sids, stages))

        def finish_sample(sid: int, stage: int, t: float, is_correct: bool):
            complete[sid] = t
            correct[sid] = is_correct
            resolver[sid] = stage
            cur_stage[sid] = 1 << 30

        def on_complete(ridx: int, sids, stages, t: float):
            r = replicas[ridx]
            # the ONLY execution call: whatever backend is plugged in
            # (validation replay, real jitted models, analytic roofline)
            # supplies per-sample certainty/correctness through one shape
            ex = backend.execute(r.model, sids)
            certs = ex.certs
            corr = ex.correct
            if corr is None:
                nonlocal correctness_known
                correctness_known = False
                corr = [False] * len(sids)
            if traw is not None:
                # batched span events: per-sample appends into flat lists,
                # one raw tuple per batch (keeps mid-run allocations — and
                # the gen-0 GC pressure they cause — off the decision loop)
                done, esc_s, esc_g = [], [], []
            else:
                done = esc_s = esc_g = None
            for k, (sid, stage) in enumerate(zip(sids, stages)):
                if cur_stage[sid] != stage:
                    continue  # hedged duplicate / stale work
                g = gear_of[sid]
                if gear_is_ensemble(g):
                    st = votes[sid]
                    st[0] -= 1
                    st[1] += int(corr[k])
                    if st[0] == 0:
                        finish_sample(sid, stage, t,
                                      majority_vote(st[1], st[2]))
                        if done is not None:
                            done.append(sid)
                    continue
                hop = core.next_hop(stage, certs[k], g)
                if hedge_used:
                    # the hedge budget is per batch: a stage advance (or
                    # resolution) retires the sample's straggler history
                    hedge_used.pop(sid, None)
                    hedged_to.pop(sid, None)
                if isinstance(hop, CascadeHop):
                    cur_stage[sid] = hop.next_stage
                    if esc_s is not None:
                        esc_s.append(sid)
                        esc_g.append(stage)
                    enqueue(sid, hop.next_stage, hop.next_model, t, g)
                else:
                    finish_sample(sid, stage, t, corr[k])
                    if done is not None:
                        done.append(sid)
            if esc_s:
                traw(("escb", t, esc_s, esc_g))
            if done:
                traw(("closeb", t, done))
            if dev_alive[r.device]:
                dev_idle[r.device] = True
                for rj in reps_on_dev.get(r.device, []):
                    try_start(rj, t)
                    if not dev_idle[r.device]:
                        break

        def sibling_replica(ridx: int) -> Optional[int]:
            """Fastest (min-queue) alive, non-draining sibling of ridx."""
            model = replicas[ridx].model
            best, best_q = None, None
            for rj in reps_of.get(model, []):
                d = replicas[rj].device
                if rj == ridx or not dev_alive[d] or dev_draining[d]:
                    continue
                if best is None or qs[rj].n < best_q:
                    best, best_q = rj, qs[rj].n
            return best

        def refund_hedge(sid: int, rj: int) -> None:
            # forced re-issue off replica rj: when the live hedge copy is
            # the one parked there (the drain/fail won the race), hand the
            # retry budget back — the fleet, not the sample's straggler
            # history, caused this re-issue
            if hedged_to.get(sid) == rj:
                hedged_to.pop(sid, None)
                n_used = hedge_used.get(sid, 0) - 1
                if n_used > 0:
                    hedge_used[sid] = n_used
                else:
                    hedge_used.pop(sid, None)

        def drain_queues(t: float, dev: int) -> None:
            """Move queued samples off ``dev`` to sibling replicas."""
            for rj in reps_on_dev.get(dev, []):
                sids, stages = qs[rj].pop(qs[rj].n)
                alt = sibling_replica(rj)
                if alt is None:
                    continue
                for sid, stage in zip(sids, stages):
                    refund_hedge(sid, rj)
                    qs[alt].push(sid, stage, t)
                    push_event(t + cfg.max_wait, "timeout", (alt,))

        def on_device_event(t: float, dev: int, kind: str, factor: float):
            nonlocal gears, net
            if kind == "slow":
                dev_speed[dev] = factor
                return
            if kind == "netdeg":
                net = factor
                return
            if kind == "recover":
                dev_speed[dev] = 1.0
                dev_draining[dev] = False
                if not dev_alive[dev]:
                    dev_alive[dev] = True
                    dev_idle[dev] = True
                    # work routed here during the outage has only expired
                    # timeouts left — restart it now
                    for rj in reps_on_dev.get(dev, []):
                        try_start(rj, t)
                        if not dev_idle[dev]:
                            break
                return
            if kind == "drain":
                # preemption notice: open the drain window — NEW work stops
                # landing here (the survivor gears from the failure callback
                # route around it, sibling/hedge re-issues skip it), but the
                # device keeps serving its queued batches, racing the revoke
                # deadline; the callback also pre-computes the survivor plan
                # so the swap at revoke time is O(1)
                dev_draining[dev] = True
                if on_failure is not None:
                    new_gears = on_failure(t, dev)
                    if new_gears is not None:
                        gears = list(new_gears)
                return
            if kind == "revoke":
                # spot revoke: the machine vanishes with whatever it holds.
                # Queued samples are shed now; the in-flight batch's epoch
                # is recorded so its completion event sheds (not re-issues)
                # the samples still riding it. A sample whose live copy is
                # a hedge duplicate elsewhere survives — only sole copies
                # die with the machine.
                nonlocal shed_count
                revoked.setdefault(dev, set()).add(int(dev_epoch[dev]))
                dev_alive[dev] = False
                dev_idle[dev] = False
                dev_draining[dev] = False
                dev_epoch[dev] += 1
                for rj in reps_on_dev.get(dev, []):
                    sids, stages = qs[rj].pop(qs[rj].n)
                    for sid, stage in zip(sids, stages):
                        if cur_stage[sid] != stage:
                            continue  # stale duplicate, sample lives on
                        alt = hedged_to.get(sid)
                        if alt == rj:
                            # the queued copy is the hedge duplicate; the
                            # primary batch is still running elsewhere
                            refund_hedge(sid, rj)
                        elif alt is None:
                            cur_stage[sid] = 1 << 30
                            shed_count += 1
                            if traw is not None:
                                traw(("close", t, sid, "revoked"))
                        # else: primary copy dies, hedge copy carries it
                if on_failure is not None:
                    new_gears = on_failure(t, dev)
                    if new_gears is not None:
                        gears = list(new_gears)
                return
            # fail: kill the device, invalidate its in-flight batch, move
            # queued samples to sibling replicas
            dev_alive[dev] = False
            dev_idle[dev] = False
            dev_draining[dev] = False
            dev_epoch[dev] += 1
            drain_queues(t, dev)
            if on_failure is not None:
                new_gears = on_failure(t, dev)
                if new_gears is not None:
                    gears = list(new_gears)

        def feed_device_count():
            if lifecycle is not None:
                lifecycle.monitor.observe_devices(int(dev_alive.sum()))

        # scheduled device events (failures / stragglers / drain windows),
        # validated up front: a malformed stream raises instead of silently
        # simulating the wrong world
        for ev_t, ev_d, ev_kind, ev_f in validate_device_events(
                device_events, self.num_devices):
            push_event(ev_t, "devevent", (ev_d, ev_kind, ev_f))

        # producer QPS measurement
        meas_end = cfg.measure_interval
        meas_count = 0

        arr_ptr = 0
        inf = math.inf
        while True:
            t_arr = arrive_l[arr_ptr] if arr_ptr < n_arr else inf
            t_evt = heap[0][0] if heap else inf
            t = min(t_arr, t_evt, meas_end)
            if t > horizon or t == inf:
                break
            if t == meas_end and t < min(t_arr, t_evt):
                measured = meas_count / cfg.measure_interval
                if telem is not None:
                    g_qps.set(measured)
                    g_gear.set(cur_gear)
                    if lifecycle is not None:
                        g_epoch.set(lifecycle.epoch)
                if lifecycle is not None:
                    # swap application MUST mirror CascadeServer._gear_step
                    # step for step — the hot-swap parity test pins the two
                    # copies to each other
                    swap = lifecycle.step(t, measured, cur_gear)
                    if swap is not None:
                        # atomic hot-swap: new gear table, gear index
                        # remapped by measured QPS range, new selector —
                        # all within this tick, before any further decision
                        gears = list(swap.plan.gears)
                        if swap.selector is not None:
                            core.selector = swap.selector
                        plan_swaps.append((t, swap.epoch, swap.reason))
                        if swap.new_gear != cur_gear:
                            switches.append((t, swap.new_gear))
                            cur_gear = swap.new_gear
                first_q = 0
                g = gears[cur_gear]
                m0 = g.cascade.models[0]
                for ridx in reps_of.get(m0, []):
                    first_q += qs[ridx].n
                new_gear = core.select_gear(t, measured, cur_gear, first_q,
                                            len(gears))
                if new_gear != cur_gear:
                    switches.append((t, new_gear))
                    cur_gear = new_gear
                meas_count = 0
                meas_end += cfg.measure_interval
                continue
            if t_arr <= t_evt:
                sid = arr_ptr
                arr_ptr += 1
                meas_count += 1
                g = gears[cur_gear]
                gear_of[sid] = g
                # no admit event here: the whole admit stream is rebuilt
                # off the clock after the loop from arrive_l + the
                # switch/swap timelines (finalize folds admits first, so
                # their raw-log position does not matter)
                if gear_is_ensemble(g):
                    members = g.cascade.models
                    votes[sid] = [len(members), 0, len(members)]
                    for m in members:
                        enqueue(sid, 0, m, t_arr, g)
                else:
                    enqueue(sid, 0, g.cascade.models[0], t_arr, g)
            else:
                _, _, kind, payload = heapq.heappop(heap)
                if kind == "complete":
                    ridx, sids, stages, epoch = payload
                    if epoch != dev_epoch[replicas[ridx].device]:
                        if epoch in revoked.get(replicas[ridx].device, ()):
                            # the batch died WITH the revoked spot machine:
                            # sole copies are shed, hedged samples are
                            # carried by their duplicate elsewhere
                            for sid, stage in zip(sids, stages):
                                if cur_stage[sid] == stage and \
                                        hedged_to.get(sid) is None:
                                    cur_stage[sid] = 1 << 30
                                    shed_count += 1
                                    if traw is not None:
                                        traw(("close", t_evt, sid,
                                              "revoked"))
                            continue
                        # device died mid-batch: re-issue surviving work
                        alt = sibling_replica(ridx)
                        if alt is not None:
                            for sid, stage in zip(sids, stages):
                                if cur_stage[sid] == stage:
                                    refund_hedge(sid, ridx)
                                    qs[alt].push(sid, stage, t_evt)
                                    if traw is not None:
                                        traw(("reissue", t_evt, sid, stage))
                                    push_event(t_evt + cfg.max_wait,
                                               "timeout", (alt,))
                    else:
                        on_complete(ridx, sids, stages, t_evt)
                elif kind == "timeout":
                    try_start(payload[0], t_evt)
                elif kind == "hedge":
                    ridx, sids, stages = payload
                    alt = sibling_replica(ridx)
                    if alt is not None:
                        pushed = False
                        budget = hedge.max_hedges_per_batch
                        for sid, stage in zip(sids, stages):
                            if cur_stage[sid] == stage and \
                                    hedge_used.get(sid, 0) < budget:
                                hedge_used[sid] = hedge_used.get(sid, 0) + 1
                                hedged_to[sid] = alt
                                qs[alt].push(sid, stage, t_evt)
                                if traw is not None:
                                    traw(("hedge", t_evt, sid, stage))
                                pushed = True
                        if pushed:
                            # immediate poll, plus the head-of-line timeout
                            # in case the sibling is below its min-queue
                            # trigger right now
                            push_event(t_evt, "timeout", (alt,))
                            push_event(t_evt + cfg.max_wait, "timeout",
                                       (alt,))
                elif kind == "devevent":
                    on_device_event(t_evt, *payload)
                    feed_device_count()

        if traw is not None:
            # admit stream, deferred to finalize() (off the decision
            # clock): arrivals are sorted and switches/plan_swaps carry
            # (t, value) in event order, so a two-pointer merge recovers
            # the admitting gear index and plan epoch of every sample.
            # An arrival AT a tick timestamp is processed before the
            # tick, so a switch at time s applies only to arrivals with
            # t_arr > s (strict compare).
            def _emit_admits(append, arrive_l=arrive_l, n=arr_ptr,
                             switches=switches, plan_swaps=plan_swaps,
                             e_cur=epoch0):
                gi = ei = 0
                g_cur = 0
                n_sw, n_ep = len(switches), len(plan_swaps)
                for sid in range(n):
                    ta = arrive_l[sid]
                    while gi < n_sw and switches[gi][0] < ta:
                        g_cur = switches[gi][1]
                        gi += 1
                    while ei < n_ep and plan_swaps[ei][0] < ta:
                        e_cur = plan_swaps[ei][1]
                        ei += 1
                    append(("admit", ta, sid, g_cur, e_cur, ""))

            telem.deferred.append(_emit_admits)

        complete_a = np.asarray(complete, np.float64)
        correct_a = np.asarray(correct, bool)
        resolver_a = np.asarray(resolver, np.int32)
        done = ~np.isnan(complete_a)
        backlog = int(n_arr - done.sum()) - shed_count
        return SimResult(
            latencies=(complete_a[done] - arrive[done]),
            correct=correct_a[done],
            arrive_times=arrive[done],
            complete_times=complete_a[done],
            resolver=resolver_a[done],
            completed=int(done.sum()),
            offered=n_arr,
            backlog_end=backlog,
            shed=shed_count,
            device_busy=dev_busy,
            horizon=horizon,
            gear_switches=switches,
            per_model_batches=per_model_batches,
            per_model_samples=per_model_samples,
            plan_swaps=plan_swaps,
            correctness_known=correctness_known)


def trace_to_arrivals(qps_per_sec: np.ndarray) -> np.ndarray:
    """Deterministic evenly-spaced arrivals within each 1-second bucket.

    Vectorized: one ``np.repeat`` + offset-cumsum construction instead of a
    per-second Python loop (bit-identical to it: same banker's rounding,
    same ``second + (i + 0.5) / k`` float ops elementwise)."""
    q = np.asarray(qps_per_sec, np.float64)
    if q.size == 0:
        return np.zeros(0)
    k = np.round(q).astype(np.int64)
    k = np.where(k > 0, k, 0)
    total = int(k.sum())
    if total == 0:
        return np.zeros(0)
    seconds = np.repeat(np.arange(len(q), dtype=np.int64), k)
    k_rep = np.repeat(k, k).astype(np.float64)
    # index of each arrival within its second: global index minus the
    # bucket's starting offset
    idx = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(k) - k, k)
    return seconds + (idx + 0.5) / k_rep


def make_gear(cascade: Cascade, replicas: Sequence[Replica],
              min_queue_lens: Optional[Dict[str, int]] = None,
              load_fractions=None, mode: str = "cascade") -> Gear:
    """Convenience constructor with uniform defaults."""
    mq = {m: 1 for m in cascade.models}
    if min_queue_lens:
        mq.update(min_queue_lens)
    lf = load_fractions or uniform_load_fractions(replicas, cascade.models)
    g = Gear(cascade=cascade, min_queue_lens=mq, load_fractions=lf)
    g.mode = mode  # type: ignore[attr-defined]
    return g
