"""Verbatim copy of ``repro/core/scheduling.py``,
imports rewritten to ``repro_torch``.

SchedulerCore: the single home of every online serving decision.

The offline gear planner is only as good as the simulator's fidelity to the
online system (paper §5, App. C, Fig. 13), so the decision logic must not be
duplicated. This module owns all four decisions as pure functions over
explicit state; the discrete-event ``ServingSimulator`` and the threaded
``CascadeServer`` are thin *drivers* over it (DESIGN.md §2):

* ``route(model, gear, u)``        — weighted replica routing (LP fractions)
* ``select_gear(...)``             — gear switching; the §5 α-hysteresis is
                                     composed in via ``with_hysteresis``
* ``should_fire(...)``             — min-queue-length batch trigger with the
                                     head-of-line timeout (§4.5)
* ``next_hop(stage, cert, gear)``  — cascade continuation vs. resolution

Drivers own *state and time* (queues, clocks, threads, the event heap); the
core owns *decisions*. A new scheduling policy is one selector/config here —
never a parallel edit of simulator and runtime.

``DecisionTrace`` records every decision the core makes so that the two
executors can be checked for exact decision parity (decision-trace equality,
not wall-clock — ``tests/test_scheduling_parity.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Sequence, Tuple, Union)

import numpy as np

from repro_torch.core.gears import Gear, GearPlan
from repro_torch.core.lp import Replica


@dataclass(frozen=True)
class SchedulerConfig:
    """Knobs shared by every executor (simulator and real runtime)."""
    max_wait: float = 0.05          # head-of-line timeout (impl. necessity)
    measure_interval: float = 0.1   # producer QPS measurement window (§5)
    alpha: float = 8.0              # gear-downgrade hysteresis (§5)
    max_batch: int = 512
    seed: int = 0


def head_of_line_wait(t: float, head_t: float, max_wait: float) -> float:
    """Head-of-line wait for the EXACT ``head_wait >= max_wait`` fire
    comparison (no epsilon fudge).

    Virtual-time drivers schedule the head's timeout event at the float
    ``head_t + max_wait``; by the driver's own clock the head has waited
    the full ``max_wait`` once ``t`` reaches that float, even where the
    raw IEEE subtraction ``t - head_t`` undershoots ``max_wait`` by an
    ulp. Snapping the wait to ``max_wait`` at the scheduled deadline makes
    the exact comparison fire at exactly the event times the driver
    scheduled — the ``max_wait - 1e-9`` fudge this replaces instead fired
    any head within 1e-9 of the timeout EARLY, and made the trigger
    brittle to float accumulation of virtual time."""
    w = t - head_t
    if w < max_wait and t >= head_t + max_wait:
        return max_wait
    return w


# ---------------------------------------------------------------------------
# Gear selection: the GearSelector protocol + α-hysteresis composition
# ---------------------------------------------------------------------------

GearSelector = Callable[[float, float, int, int], int]
# (time, measured_qps, current_gear_idx, first_model_queue_len) -> gear idx


def plan_target(plan: GearPlan) -> GearSelector:
    """Raw §5 producer target: the plan's gear for the measured QPS range
    (no hysteresis — compose with ``with_hysteresis``)."""
    def target(t: float, measured_qps: float, cur: int, q0: int) -> int:
        return plan.gear_index_for_qps(measured_qps)
    return target


def with_hysteresis(target: GearSelector, alpha: float) -> GearSelector:
    """§5 α-hysteresis: never downgrade while the first model's backlog is
    large relative to the measured rate (measured < α·Q0) — drain first.
    This is the ONLY implementation of the rule; both executors compose it."""
    def select(t: float, measured_qps: float, cur: int, q0: int) -> int:
        tgt = target(t, measured_qps, cur, q0)
        if tgt < cur and measured_qps < alpha * q0:
            return cur
        return tgt
    return select


# ---------------------------------------------------------------------------
# Cascade continuation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Resolved:
    """The sample is answered at this cascade stage."""
    stage: int


@dataclass(frozen=True)
class CascadeHop:
    """The sample was not certain enough: forward to the next model."""
    next_model: str
    next_stage: int


Hop = Union[Resolved, CascadeHop]


def is_ensemble(gear: Gear) -> bool:
    return getattr(gear, "mode", "cascade") == "ensemble"


def majority_vote(n_correct_votes: int, n_members: int) -> bool:
    """Ensemble decision (Cocktail+): strict majority of member votes."""
    return n_correct_votes * 2 > n_members


# ---------------------------------------------------------------------------
# Continuous batching (token-level serving, DESIGN.md §13)
# ---------------------------------------------------------------------------

class ContinuousBatcher:
    """Token-boundary decisions for a slot-based decode batch.

    Token-level serving replaces "fire one batch, run it to completion"
    with a *running* decode batch: requests occupy KV-cache slots, every
    decode step advances all resident requests by one token, and membership
    changes only at token boundaries. This class owns the two decisions
    that membership turns on, as pure functions over explicit state, so the
    real ``TokenEngine`` and the virtual-time token DES cannot diverge
    (the token extension of the SchedulerCore contract, §2):

    * ``admit(n_active, n_waiting)`` — how many waiting requests join the
      batch at this boundary (FIFO; as many as there are free slots).
    * ``boundary_hop(...)`` — per resident request, after its newest token:
      keep decoding (``None``), resolve, or escalate. End-of-stream uses
      the ordinary ``next_hop`` rule on the streamed certainty. MID-stream,
      a request whose streaming certainty has settled clearly below the
      gear's threshold (below ``early_margin * threshold``, after at least
      ``min_tokens`` tokens) escalates immediately — the small model is out
      of its depth and every further token it streams is wasted device
      time. The hop carries the PROMPT, not the KV cache: the next model
      re-prefills (caches are architecture-shaped and unshareable).
    """

    __slots__ = ("core", "n_slots", "min_tokens", "early_margin")

    def __init__(self, core: "SchedulerCore", n_slots: int,
                 min_tokens: int = 4, early_margin: float = 0.5):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if min_tokens < 1:
            raise ValueError(f"min_tokens must be >= 1, got {min_tokens}")
        if not 0.0 <= early_margin <= 1.0:
            raise ValueError(
                f"early_margin must be in [0, 1], got {early_margin}")
        self.core = core
        self.n_slots = n_slots
        self.min_tokens = min_tokens
        self.early_margin = early_margin

    def admit(self, n_active: int, n_waiting: int) -> int:
        """Number of waiting requests that join at this token boundary."""
        free = self.n_slots - n_active
        if free <= 0 or n_waiting <= 0:
            return 0
        return min(free, n_waiting, self.core.cfg.max_batch)

    def boundary_hop(self, stage: int, cert_value: float, pos: int,
                     gen_len: int, gear: Gear) -> Optional[Hop]:
        """Decision for one resident request after its ``pos``-th token
        (1-based): ``None`` keeps decoding; ``Resolved``/``CascadeHop``
        leave the batch at this boundary."""
        if pos >= gen_len:
            # end of stream: the standard cascade rule on the streamed
            # certainty (recorded in the DecisionTrace like any hop)
            return self.core.next_hop(stage, cert_value, gear)
        if pos >= self.min_tokens:
            casc = gear.cascade
            if stage < len(casc.thresholds) and \
                    cert_value < casc.thresholds[stage] * self.early_margin:
                return self.core.next_hop(stage, cert_value, gear)
        return None

    def stream_trace_hop(self, stage: int, cert: "object",
                         gaps: Sequence[float], start_pos: int,
                         gen_len: int, gear: Gear
                         ) -> Tuple[int, Optional[Hop]]:
        """Boundary decisions over a returned gap trace (fused loop,
        DESIGN.md §14).

        The device-resident loop runs K decode steps per executable call
        and hands back the per-token gap trace; this method replays the
        EXACT per-boundary rule over it: fold each gap into ``cert`` (a
        ``StreamingCertainty`` — the same float64 fold every executor
        uses, so decisions stay bit-identical to the K=1 path and the
        token DES), consult ``boundary_hop`` at the same token counts a
        single-step loop would have, and STOP at the first decision —
        tokens past it are speculative and the caller discards them.

        Returns (n_consumed, hop): ``n_consumed`` gaps were folded (the
        row's real tokens); ``hop`` is None if the row decodes on.
        """
        for j, g in enumerate(gaps):
            v = cert.update(float(g))
            hop = self.boundary_hop(stage, v, start_pos + j + 1, gen_len,
                                    gear)
            if hop is not None:
                return j + 1, hop
        return len(gaps), None

    def near_boundary(self, stage: int, cert_value: float, pos: int,
                      gen_len: int, gear: Gear, slack: float = 1.5) -> bool:
        """Speculation guard: is this row close enough to an escalation
        boundary that a multi-token scan would likely waste tokens?

        The fused engine collapses K to 1 whenever any row answers True
        (and whenever any request is waiting — see ``TokenEngine``), so
        speculative scans only run deep inside a stream's steady state.
        ``slack`` widens the mid-stream escalation band: a row whose
        streaming certainty sits below ``slack x`` the escalation
        threshold is treated as near. End-of-stream nearness is handled
        separately by capping K at the tokens remaining. Purely a
        performance heuristic — a wrong answer costs discarded
        speculative tokens, never a decision (decisions are re-derived
        from the gap trace at the same token counts)."""
        casc = gear.cascade
        if stage >= len(casc.thresholds):
            return False            # terminal stage never escalates
        return cert_value < casc.thresholds[stage] * self.early_margin \
            * slack


# ---------------------------------------------------------------------------
# Deterministic routing randomness (shared so executors can be compared)
# ---------------------------------------------------------------------------

class RoutePool:
    """Pre-drawn pool of uniforms consumed one per routing decision.

    Both executors draw from the same construction so a parity test can give
    them literally the same stream (pool size changes the wrap-around, hence
    the sequence — use ``for_arrivals`` to match the simulator's sizing).

    ``key`` derives an independent KEYED substream (stable hash of the key
    folded into the seed) instead of the positional default stream. The
    multi-tenant path keys one pool per tenant, so inserting or removing a
    tenant can never shift another tenant's draw sequence — with a single
    positional stream, every routing decision of every tenant would consume
    from one shared cursor and any new tenant would perturb all of them.
    ``key=None`` is bit-identical to the pre-keying construction.
    """
    __slots__ = ("_pool", "_ptr", "_n")

    def __init__(self, seed: int, size: int = 4096,
                 key: Optional[str] = None):
        if key is None:
            rng = np.random.default_rng(seed)
        else:
            # zlib.crc32 is stable across processes and platforms (unlike
            # hash()), so keyed streams are reproducible everywhere
            import zlib
            rng = np.random.default_rng(
                [int(seed), zlib.crc32(str(key).encode("utf-8"))])
        self._pool = rng.random(max(size, 1)).tolist()
        self._n = len(self._pool)
        self._ptr = 0

    @classmethod
    def for_arrivals(cls, seed: int, n_arrivals: int,
                     key: Optional[str] = None) -> "RoutePool":
        return cls(seed, n_arrivals * 4 + 16, key=key)

    def next(self) -> float:
        ptr = self._ptr
        if ptr >= self._n:
            ptr = ptr % self._n
        self._ptr = ptr + 1
        return self._pool[ptr]


# ---------------------------------------------------------------------------
# Decision trace (parity checking)
# ---------------------------------------------------------------------------

@dataclass
class DecisionTrace:
    """Append-only record of the core's decisions, in call order.

    Routing, gear switches and cascade hops are recorded by the core itself;
    batch firings are recorded by the driver at queue-pop time (the core's
    ``should_fire`` is consulted arbitrarily often by polling drivers, so the
    *positive* decision — which samples were batched on which replica — is
    the comparable event).
    """
    routes: List[Tuple[str, int]] = field(default_factory=list)
    gear_switches: List[Tuple[int, int]] = field(default_factory=list)
    fires: List[Tuple[int, Tuple[int, ...]]] = field(default_factory=list)
    hops: List[Tuple[int, float, str]] = field(default_factory=list)
    # plan hot-swaps (core/adaption.py): (new epoch, old gear, remapped
    # gear). Swaps interleave with the other decisions in call order, so
    # two executors must agree not only on WHETHER they swapped but on the
    # epoch sequence and the QPS-range remap.
    swaps: List[Tuple[int, int, int]] = field(default_factory=list)

    def record_fire(self, ridx: int, sample_ids: Sequence[int]) -> None:
        self.fires.append((int(ridx), tuple(int(s) for s in sample_ids)))

    def record_swap(self, epoch: int, old_gear: int, new_gear: int) -> None:
        self.swaps.append((int(epoch), int(old_gear), int(new_gear)))

    def summary(self) -> Dict[str, int]:
        return {"routes": len(self.routes),
                "gear_switches": len(self.gear_switches),
                "fires": len(self.fires), "hops": len(self.hops),
                "swaps": len(self.swaps)}


# ---------------------------------------------------------------------------
# The core
# ---------------------------------------------------------------------------

class SchedulerCore:
    """Pure, side-effect-free serving decisions over explicit state.

    Holds only immutable context: the fixed replica placement (replicas never
    move at runtime — no model loading on the critical path), the shared
    config, and the gear-selection policy. All mutable serving state (queues,
    clocks, device status) lives in the driver and is passed in as plain
    arguments, so one core instance can serve any number of runs and the
    same instance can be shared across executors.
    """

    def __init__(self, replicas: Sequence[Replica],
                 cfg: SchedulerConfig = SchedulerConfig(),
                 selector: Optional[GearSelector] = None,
                 trace: Optional[DecisionTrace] = None):
        self.replicas = list(replicas)
        self.cfg = cfg
        self.selector: GearSelector = selector or (lambda t, q, g, q0: g)
        self.trace = trace
        # optional PlanMonitor (core/adaption.py): observes the certainty
        # stream at the single point every executor's cascade decision
        # passes through, so drift detection cannot diverge across drivers
        self.monitor = None
        self.reps_of: Dict[str, List[int]] = {}
        self.reps_on_dev: Dict[int, List[int]] = {}
        for i, r in enumerate(self.replicas):
            self.reps_of.setdefault(r.model, []).append(i)
            self.reps_on_dev.setdefault(r.device, []).append(i)
        # per-(gear, stage) hop memo: the two possible outcomes of next_hop
        # are fixed per gear+stage, only the cert comparison varies — caching
        # them keeps the hot completion path allocation-free. The strong ref
        # to the gear object in the entry pins its id, so id-keyed entries
        # can never alias a new gear, and identity is re-checked on hit.
        # _route_memo does the same for the per-(gear, model) cumulative
        # routing table.
        self._hop_memo: Dict[Tuple[int, int], tuple] = {}
        self._route_memo: Dict[Tuple[int, str], tuple] = {}
        # exact timeout comparison — no epsilon fudge; drivers compute the
        # wait via ``head_of_line_wait`` so their scheduled timeout events
        # meet it despite ulp undershoot in (t + max_wait) - t
        self._fire_wait = cfg.max_wait

    # ----------------------------------------------------------- routing
    def route(self, model: str, gear: Gear, u: float) -> int:
        """Pick the replica for one sample of ``model`` under ``gear``'s LP
        load fractions, using the uniform draw ``u`` in [0, 1)."""
        ent = self._route_memo.get((id(gear), model))
        if ent is None or ent[0] is not gear:
            fracs = gear.load_fractions.get(model)
            idxs = self.reps_of.get(model, [])
            if not idxs:
                raise RuntimeError(f"no replica for model {model}")
            if not fracs:
                ent = (gear, None, idxs)
            else:
                cum, acc = [], 0.0
                for rj, frac in fracs.items():
                    acc += frac
                    cum.append((acc + 1e-12, rj))
                ent = (gear, cum, next(iter(fracs)))
            self._route_memo[(id(gear), model)] = ent
        if ent[1] is None:
            idxs = ent[2]
            ridx = idxs[int(u * len(idxs)) % len(idxs)]
        else:
            ridx = ent[2]
            for acc, rj in ent[1]:
                if u <= acc:
                    ridx = rj
                    break
        if self.trace is not None:
            self.trace.routes.append((model, ridx))
        return ridx

    # ---------------------------------------------------- gear selection
    def select_gear(self, t: float, measured_qps: float, cur_gear: int,
                    first_queue_len: int, n_gears: int) -> int:
        """One producer measurement tick: apply the selection policy
        (α-hysteresis included when composed via ``with_hysteresis``) and
        clamp to the gear table."""
        new = int(self.selector(t, measured_qps, cur_gear, first_queue_len))
        new = min(max(new, 0), n_gears - 1)
        if self.trace is not None and new != cur_gear:
            self.trace.gear_switches.append((cur_gear, new))
        return new

    # ------------------------------------------------------ batch trigger
    def should_fire(self, queue_len: int, head_wait: float, model: str,
                    gear: Gear) -> bool:
        """Fire when the queue reaches the gear's min-queue-length (§4.5) or
        the head-of-line sample has waited ``max_wait``."""
        return self.fire_at(queue_len, head_wait,
                            gear.min_queue_lens.get(model, 1))

    def fire_at(self, queue_len: int, head_wait: float,
                trigger: int) -> bool:
        """``should_fire`` against an explicit trigger value. Multi-tenant
        drivers resolve the trigger across the tenants sharing a replica
        queue (``repro.core.tenancy.effective_trigger``) and call this —
        the fire rule itself stays in one place."""
        if queue_len <= 0:
            return False
        return queue_len >= trigger or head_wait >= self._fire_wait

    def batch_size(self, queue_len: int) -> int:
        return min(queue_len, self.cfg.max_batch)

    # ------------------------------------------------ cascade continuation
    def next_hop(self, stage: int, cert: float, gear: Gear) -> Hop:
        """Resolve or forward one sample completing cascade ``stage``."""
        ent = self._hop_memo.get((id(gear), stage))
        if ent is None or ent[0] is not gear:
            casc = gear.cascade
            if stage < len(casc.thresholds):
                thr: Optional[float] = casc.thresholds[stage]
                fwd: Optional[CascadeHop] = CascadeHop(
                    next_model=casc.models[stage + 1], next_stage=stage + 1)
            else:
                thr, fwd = None, None
            ent = (gear, thr, fwd, Resolved(stage=stage),
                   casc.models[stage] if stage < len(casc.models) else "")
            self._hop_memo[(id(gear), stage)] = ent
        if self.monitor is not None:
            self.monitor.observe_cert(ent[4], cert)
        thr = ent[1]
        hop: Hop = ent[2] if (thr is not None and cert < thr) else ent[3]
        if self.trace is not None:
            out = "resolve" if isinstance(hop, Resolved) else hop.next_model
            self.trace.hops.append((stage, float(cert), out))
        return hop
