"""Verbatim copy of ``repro/core/telemetry.py``,
imports rewritten to ``repro_torch``.

Unified telemetry: request spans, a deterministic metrics registry, and
latency attribution across all three drivers (DESIGN.md §16).

Three pieces, all pure observers — nothing in here feeds a scheduling
decision, holds a wall clock, or draws randomness, so enabling telemetry
cannot move the golden behavior fingerprint or the cross-driver decision
parity by a single bit:

* ``Telemetry``        — request spans. Drivers append flat event tuples to
                         ``Telemetry.raw`` (one list append on the hot
                         path; the bound method is hoisted by the drivers);
                         ``finalize()`` folds the log into per-request
                         ``Span`` objects, checks span-close conservation,
                         and emits registry metrics. Every admitted request
                         closes exactly one span: completed, shed, or
                         revoked.
* ``MetricsRegistry``  — counters, gauges, deterministic fixed-bucket log2
                         histograms (exact quantile readback at bucket
                         resolution), and bounded ``WindowSeries`` (what
                         the ``PlanMonitor``'s exact windowed-percentile
                         checks consume). JSONL export is byte-identical
                         for identical observation sequences; a
                         Prometheus-style text dump serves scrape-shaped
                         consumers (``launch/serve.py --metrics-out``).
* ``attribution()``    — decomposes every span's end-to-end latency into
                         telescoping components (queue wait, execute,
                         hedge wait, escalation handoff) per gear, tenant,
                         and admit-time window. The intervals partition
                         ``[t_admit, t_close]`` exactly, so per-component
                         sums reconcile with measured end-to-end latency
                         by construction (bench_telemetry certifies it).

Event-tuple vocabulary (first element is the kind):

    ("admit",  t, sid, gear, epoch, tenant)  # admit AND queue-enter, stage 0
    ("fire",   t, stage, sids)           # one batch launch (seq of sids)
    ("escalate", t, sid, from_stage)     # hop continues; implies queue-enter
    ("hedge",  t, sid, stage)            # straggler duplicate issued
    ("reissue", t, sid, stage)           # device-death re-queue (queue-enter)
    ("queue",  t, sid, stage)            # bare queue-enter (cold-path API)
    ("drain",  t, device)                # preemption drain notice
    ("close",  t, sid, state)            # state: completed | shed | revoked
    ("closeb", t, sids)                  # batch of completed closes
    ("escb",   t, sids, stages)          # batch of escalations (one batch)

Hot-path economy: events that ALWAYS travel with a queue-enter at the same
instant (admit, escalate, reissue) carry it implicitly — one append instead
of two — and per-batch outcomes travel as one ``closeb``/``escb`` (like
``fire``, the per-sid cost is a list element, not an event). A driver
whose admit stream is reconstructible from state it already keeps can
defer it entirely: register a closure on ``Telemetry.deferred`` and
``finalize()`` runs it off the decision clock, folding admits in a first
pass so their raw-log position is irrelevant. Span components are named
by the event that OPENS each interval: admit/escalate/reissue/queue ->
queue_wait, ``fire`` -> execute, ``hedge`` -> hedge_wait.
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Log2Histogram", "WindowSeries",
           "MetricsRegistry", "Span", "Telemetry"]


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

class Counter:
    """Monotone float counter."""
    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins value; ``None`` until first set (consumers that need
    unset-detection — e.g. the device-loss check — read ``.value`` raw)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict:
        return {"type": "gauge",
                "value": 0.0 if self.value is None else self.value}


class Log2Histogram:
    """Deterministic fixed-bucket base-2 histogram.

    Buckets are defined purely by arithmetic on the observed value — no
    wall clock, no RNG, no adaptive resizing — so two runs observing the
    same sequence produce bit-identical state. Each octave ``[2^(e-1),
    2^e)`` splits into ``subs`` equal sub-buckets: for ``v = m * 2^e``
    (``math.frexp``, ``m in [0.5, 1)``) the bucket index is
    ``e * subs + floor((2m - 1) * subs)``. Relative bucket width is
    ``<= 1/subs`` of the value, so quantile readback is exact to one
    bucket.

    ``quantile(q)`` uses the nearest-rank-up convention (numpy's
    ``method='higher'``): the order statistic ``ceil(q * (n - 1))``
    (0-indexed) selects the bucket, and the bucket's upper edge is
    returned — guaranteed within one bucket width of
    ``np.percentile(data, 100q, method='higher')``.
    """
    __slots__ = ("subs", "counts", "n", "total", "zero_neg")

    def __init__(self, subs: int = 8):
        if subs < 1:
            raise ValueError(f"subs must be >= 1, got {subs}")
        self.subs = subs
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0      # exact running sum (mean readback)
        self.zero_neg = 0     # observations <= 0 (their own bucket)

    def _index(self, v: float) -> int:
        m, e = math.frexp(v)                   # v = m * 2^e, m in [.5, 1)
        return e * self.subs + int((2.0 * m - 1.0) * self.subs)

    def observe(self, v: float) -> None:
        self.n += 1
        self.total += v
        if v <= 0.0:
            self.zero_neg += 1
            return
        i = self._index(v)
        self.counts[i] = self.counts.get(i, 0) + 1

    def bucket_bounds(self, i: int) -> Tuple[float, float]:
        """[lo, hi) covered by bucket index ``i``."""
        e, sub = divmod(i, self.subs)
        lo = math.ldexp(1.0 + sub / self.subs, e - 1)
        return lo, lo + math.ldexp(1.0 / self.subs, e - 1)

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile observation
        (nearest-rank-up); 0.0 for an empty histogram."""
        if self.n == 0:
            return 0.0
        k = min(self.n - 1, max(0, math.ceil(q * (self.n - 1))))
        if k < self.zero_neg:                  # <=0 observations sort first
            return 0.0
        need = k - self.zero_neg + 1
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= need:
                return self.bucket_bounds(i)[1]
        return self.bucket_bounds(max(self.counts))[1]

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def snapshot(self) -> Dict:
        return {"type": "histogram", "subs": self.subs, "n": self.n,
                "sum": self.total, "zero_neg": self.zero_neg,
                "counts": {str(i): self.counts[i]
                           for i in sorted(self.counts)},
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class WindowSeries:
    """Bounded window of raw observations with a monotone total count.

    This is the registry's escape hatch for consumers whose pinned
    numerics need EXACT values, not bucketed ones: the ``PlanMonitor``'s
    p95 drift check runs ``np.percentile`` over the live window, and the
    TV-distance check needs the raw QPS ticks. ``since(count0)`` returns
    the observations recorded after an earlier ``.count`` snapshot (up to
    the window bound) — how the monitor scopes a shared series to the
    currently-watched plan without resetting other consumers' view.
    """
    __slots__ = ("_win", "count", "maxlen", "_lock")

    def __init__(self, maxlen: int, lock: threading.Lock):
        self._win: deque = deque(maxlen=maxlen)
        self.maxlen = maxlen
        self.count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._win.append(float(v))
            self.count += 1

    def n_since(self, count0: int) -> int:
        return min(self.count - count0, len(self._win))

    def since(self, count0: int) -> Tuple[float, ...]:
        """Values observed after the ``count0`` snapshot, oldest first."""
        with self._lock:
            k = min(self.count - count0, len(self._win))
            if k <= 0:
                return ()
            win = tuple(self._win)
        return win[len(win) - k:]

    def snapshot(self) -> Dict:
        return {"type": "series", "count": self.count,
                "maxlen": self.maxlen, "window": list(self._win)}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _key(name: str, labels: Dict[str, str]) -> Tuple:
    return (name, tuple(sorted(labels.items())))


class MetricsRegistry:
    """Named metrics with optional labels, get-or-create access, and two
    deterministic exporters. One shared lock serializes counter/series
    mutation (the threaded server's consumer threads all feed the cert
    stream); the single-threaded drivers pay only an uncontended acquire,
    same as the monitor's old bespoke lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self._metrics: Dict[Tuple, object] = {}

    def _get(self, name: str, labels: Dict[str, str], factory, kind):
        k = _key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            m = factory()
            self._metrics[k] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name}{labels} is {type(m).__name__}, "
                            f"not {kind.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, lambda: Counter(self.lock), Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge, Gauge)

    def histogram(self, name: str, subs: int = 8, **labels) -> Log2Histogram:
        return self._get(name, labels, lambda: Log2Histogram(subs),
                         Log2Histogram)

    def series(self, name: str, maxlen: int = 4096, **labels) -> WindowSeries:
        return self._get(name, labels,
                         lambda: WindowSeries(maxlen, self.lock),
                         WindowSeries)

    def family(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], object]:
        """All metrics sharing ``name``, keyed by their label tuples."""
        return {k[1]: m for k, m in self._metrics.items() if k[0] == name}

    # ---------------------------------------------------------- exporters

    def export_jsonl(self) -> str:
        """One JSON object per metric, sorted by (name, labels), keys
        sorted — byte-identical across runs that observed the same
        sequences."""
        lines = []
        for k in sorted(self._metrics, key=lambda k: (k[0], k[1])):
            row = {"name": k[0], "labels": dict(k[1])}
            row.update(self._metrics[k].snapshot())
            lines.append(json.dumps(row, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def prometheus_text(self) -> str:
        """Prometheus exposition-format dump (counters/gauges as-is,
        histograms as cumulative ``_bucket`` lines with ``le`` upper
        edges, series as count + last value)."""
        out: List[str] = []
        seen_types = set()

        def header(name, mtype):
            if name not in seen_types:
                seen_types.add(name)
                out.append(f"# TYPE {name} {mtype}")

        def fmt_labels(labels, extra=()):
            items = list(labels) + list(extra)
            if not items:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in items)
            return "{" + inner + "}"

        for k in sorted(self._metrics, key=lambda k: (k[0], k[1])):
            name, labels = k
            m = self._metrics[k]
            if isinstance(m, Counter):
                header(name, "counter")
                out.append(f"{name}{fmt_labels(labels)} {m.value:g}")
            elif isinstance(m, Gauge):
                header(name, "gauge")
                v = 0.0 if m.value is None else m.value
                out.append(f"{name}{fmt_labels(labels)} {v:g}")
            elif isinstance(m, Log2Histogram):
                header(name, "histogram")
                cum = m.zero_neg
                for i in sorted(m.counts):
                    cum += m.counts[i]
                    le = m.bucket_bounds(i)[1]
                    out.append(f"{name}_bucket"
                               f"{fmt_labels(labels, [('le', f'{le:g}')])}"
                               f" {cum}")
                out.append(f"{name}_bucket"
                           f"{fmt_labels(labels, [('le', '+Inf')])} {m.n}")
                out.append(f"{name}_sum{fmt_labels(labels)} {m.total:g}")
                out.append(f"{name}_count{fmt_labels(labels)} {m.n}")
            elif isinstance(m, WindowSeries):
                header(name, "gauge")
                last = m._win[-1] if m._win else 0.0
                out.append(f"{name}{fmt_labels(labels)} {last:g}")
                out.append(f"{name}_count{fmt_labels(labels)} {m.count}")
        return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# Request spans
# ---------------------------------------------------------------------------

_COMPONENT = {"queue": "queue_wait", "fire": "execute",
              "hedge": "hedge_wait", "escalate": "queue_wait",
              "reissue": "queue_wait", "admit": "queue_wait"}

CLOSE_STATES = ("completed", "shed", "revoked")


def _evkey(e):
    """Canonical span-event order: by time, queue-class events before a
    fire at the same instant (a sample queues before it fires — drivers
    that batch their raw emission may log the two out of order)."""
    return (e[1], 1 if e[0] == "fire" else 0)


class Span:
    """One request's recorded lifetime: admit -> per-hop events -> close."""
    __slots__ = ("sid", "gear", "epoch", "tenant", "t_admit", "t_close",
                 "state", "events")

    def __init__(self, sid: int, t_admit: float, gear: int, epoch: int,
                 tenant: str):
        self.sid = sid
        self.gear = gear
        self.epoch = epoch
        self.tenant = tenant
        self.t_admit = t_admit
        self.t_close: Optional[float] = None
        self.state: Optional[str] = None          # one of CLOSE_STATES
        self.events: List[Tuple[str, float, int]] = []  # (kind, t, stage)

    @property
    def latency(self) -> float:
        return (self.t_close - self.t_admit) if self.t_close is not None \
            else 0.0

    def components(self) -> Dict[str, float]:
        """Telescoping decomposition of ``[t_admit, t_close]``: each
        interval is attributed to the event kind that opens it, so the
        component sums reconcile with end-to-end latency exactly."""
        if self.t_close is None:
            return {}
        out: Dict[str, float] = {}
        evs = sorted(self.events, key=_evkey)
        prev_t, prev_kind = self.t_admit, "admit"
        for kind, t, _stage in evs:
            dt = t - prev_t
            if dt > 0:
                comp = _COMPONENT.get(prev_kind, prev_kind)
                out[comp] = out.get(comp, 0.0) + dt
            prev_t, prev_kind = t, kind
        dt = self.t_close - prev_t
        if dt > 0:
            comp = _COMPONENT.get(prev_kind, prev_kind)
            out[comp] = out.get(comp, 0.0) + dt
        return out

    def to_dict(self) -> Dict:
        return {"sid": self.sid, "gear": self.gear, "epoch": self.epoch,
                "tenant": self.tenant, "t_admit": self.t_admit,
                "t_close": self.t_close, "state": self.state,
                "events": [[k, t, s] for k, t, s in self.events]}


class SpanAccountingError(AssertionError):
    """A span was closed twice, closed without being admitted, or closed
    with an unknown state — accounting bugs the conservation tests exist
    to catch."""


class Telemetry:
    """Flat event log + span fold + attribution, sharing one registry.

    Hot-path contract: drivers append tuples to ``self.raw`` (hoist
    ``telem.raw.append`` into a local). Everything else — span
    construction, conservation, attribution, registry histograms — runs
    in ``finalize()``, off the decision loop.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.raw: List[Tuple] = []
        self.spans: Dict[int, Span] = {}
        # deferred event providers: a driver whose admit stream is fully
        # reconstructible from state it already keeps (arrival times +
        # switch timelines) registers a closure here instead of paying a
        # per-admit append on the hot loop; finalize() runs them first
        self.deferred: List = []
        self._finalized = False

    # ----------------------------------------------------- cold-path API
    # (convenience wrappers; hot loops append tuples directly)

    def admit(self, t: float, sid: int, gear: int = -1, epoch: int = 0,
              tenant: str = "") -> None:
        self.raw.append(("admit", t, sid, gear, epoch, tenant))

    def event(self, kind: str, t: float, sid: int, stage: int = -1) -> None:
        self.raw.append((kind, t, sid, stage))

    def close(self, t: float, sid: int, state: str) -> None:
        self.raw.append(("close", t, sid, state))

    # ------------------------------------------------------------ folding

    def finalize(self) -> "Telemetry":
        """Fold the raw log into spans (idempotent: new raw events since
        the last call are folded in).

        Two passes: admits first, then everything else. A driver may
        emit its admits out of line — the scalar DES rebuilds the whole
        admit stream post-run from the arrival and switch timelines and
        appends it after every other event — so span creation must not
        depend on raw-log position. Within each pass, log order is
        preserved, which keeps span-dict insertion order (and therefore
        the JSONL export bytes) identical across drivers that admit in
        sample-id order.
        """
        if self.deferred:
            for fn in self.deferred:
                fn(self.raw.append)
            self.deferred = []
        spans = self.spans
        raw = self.raw
        for ev in raw:
            if ev[0] == "admit":
                _, t, sid, gear, epoch, tenant = ev
                if sid in spans:
                    raise SpanAccountingError(f"sid {sid} admitted twice")
                spans[sid] = Span(sid, t, gear, epoch, tenant)
        for ev in raw:
            kind = ev[0]
            if kind == "admit":
                pass
            elif kind == "fire":
                _, t, stage, sids = ev
                for sid in sids:
                    sp = spans.get(sid)
                    if sp is not None and sp.state is None:
                        sp.events.append(("fire", t, stage))
            elif kind == "close":
                _, t, sid, state = ev
                if state not in CLOSE_STATES:
                    raise SpanAccountingError(
                        f"sid {sid}: unknown close state {state!r}")
                sp = spans.get(sid)
                if sp is None:
                    raise SpanAccountingError(
                        f"sid {sid} closed but never admitted")
                if sp.state is not None:
                    raise SpanAccountingError(
                        f"sid {sid} closed twice "
                        f"({sp.state} then {state})")
                sp.state = state
                sp.t_close = t
            elif kind == "closeb":
                _, t, sids = ev
                for sid in sids:
                    sp = spans.get(sid)
                    if sp is None:
                        raise SpanAccountingError(
                            f"sid {sid} closed but never admitted")
                    if sp.state is not None:
                        raise SpanAccountingError(
                            f"sid {sid} closed twice "
                            f"({sp.state} then completed)")
                    sp.state = "completed"
                    sp.t_close = t
            elif kind == "escb":
                _, t, sids, stages = ev
                for sid, stage in zip(sids, stages):
                    sp = spans.get(sid)
                    if sp is not None and sp.state is None:
                        sp.events.append(("escalate", t, stage))
            elif kind in ("drain", "revoke_device"):
                pass                      # fleet-level markers, span-less
            else:
                _, t, sid, stage = ev[:4]
                sp = spans.get(sid)
                # post-close events (a hedge duplicate racing after the
                # primary resolved) are dropped: intervals must not extend
                # past t_close or the telescoping sum breaks
                if sp is not None and sp.state is None:
                    sp.events.append((kind, t, stage))
        # canonical event order per span: batched raw emission (escb vs an
        # immediate same-instant fire) may fold out of causal order — sort
        # so exports and span comparisons are driver-independent
        for sp in spans.values():
            sp.events.sort(key=_evkey)
        self.raw = []
        self._emit_metrics()
        self._finalized = True
        return self

    def _emit_metrics(self) -> None:
        reg = self.registry
        for sp in self.spans.values():
            if sp.state is None:
                continue
            reg.counter("requests_closed", state=sp.state).inc()
            if sp.state == "completed":
                reg.histogram("request_latency",
                              gear=str(sp.gear),
                              tenant=sp.tenant).observe(sp.latency)
                for comp, v in sp.components().items():
                    reg.counter("latency_component_seconds",
                                component=comp).inc(v)

    # ------------------------------------------------------ conservation

    def conservation(self) -> Dict[str, int]:
        """Span-close accounting: every admitted request must close at
        most once, and at end-of-run ``closed == completed + shed`` with
        the remainder still open (the driver's backlog)."""
        if not self._finalized:
            self.finalize()
        out = {"opened": len(self.spans), "closed": 0, "completed": 0,
               "shed": 0, "revoked": 0, "open": 0}
        for sp in self.spans.values():
            if sp.state is None:
                out["open"] += 1
            else:
                out["closed"] += 1
                out[sp.state] += 1
        return out

    # ------------------------------------------------------- attribution

    def attribution(self, window_s: Optional[float] = None) -> Dict:
        """Latency attribution over completed spans.

        Returns per-gear, per-tenant and (optionally) per-admit-window
        component sums plus end-to-end totals. ``sum(components) ==
        end_to_end`` holds exactly per group — the telescoping invariant
        bench_telemetry certifies to <1%.
        """
        if not self._finalized:
            self.finalize()

        def new_group():
            return {"count": 0, "end_to_end": 0.0, "components": {}}

        def add(group, sp):
            group["count"] += 1
            group["end_to_end"] += sp.latency
            for comp, v in sp.components().items():
                group["components"][comp] = \
                    group["components"].get(comp, 0.0) + v

        total = new_group()
        by_gear: Dict[str, Dict] = {}
        by_tenant: Dict[str, Dict] = {}
        by_window: Dict[str, Dict] = {}
        for sp in self.spans.values():
            if sp.state != "completed":
                continue
            add(total, sp)
            add(by_gear.setdefault(str(sp.gear), new_group()), sp)
            add(by_tenant.setdefault(sp.tenant or "-", new_group()), sp)
            if window_s:
                wk = str(int(sp.t_admit // window_s))
                add(by_window.setdefault(wk, new_group()), sp)
        out = {"total": total, "by_gear": by_gear, "by_tenant": by_tenant}
        if window_s:
            out["by_window"] = by_window
        return out

    @staticmethod
    def render_attribution(attr: Dict, unit: float = 1e3,
                           unit_name: str = "ms") -> str:
        """Human-readable attribution table (examples/telemetry_demo.py,
        benchmarks/render_experiments.py)."""
        comps = sorted({c for g in attr["by_gear"].values()
                        for c in g["components"]}
                       | set(attr["total"]["components"]))
        rows = [("group", "n", f"end_to_end_{unit_name}",
                 *[f"{c}_{unit_name}" for c in comps])]

        def fmt(group, name):
            return (name, str(group["count"]),
                    f"{group['end_to_end'] * unit:.1f}",
                    *[f"{group['components'].get(c, 0.0) * unit:.1f}"
                      for c in comps])

        rows.append(fmt(attr["total"], "TOTAL"))
        for name in sorted(attr["by_gear"]):
            rows.append(fmt(attr["by_gear"][name], f"gear={name}"))
        for name in sorted(attr["by_tenant"]):
            if name != "-" or len(attr["by_tenant"]) > 1:
                rows.append(fmt(attr["by_tenant"][name], f"tenant={name}"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = ["  ".join(c.rjust(w) for c, w in zip(r, widths))
                 for r in rows]
        lines.insert(1, "  ".join("-" * w for w in widths))
        return "\n".join(lines)

    # ------------------------------------------------------------ export

    def export_spans_jsonl(self, limit: Optional[int] = None) -> str:
        if not self._finalized:
            self.finalize()
        sids = sorted(self.spans)
        if limit is not None:
            sids = sids[:limit]
        return "".join(json.dumps(self.spans[s].to_dict(), sort_keys=True)
                       + "\n" for s in sids)
