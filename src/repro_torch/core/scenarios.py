"""Verbatim copy of ``repro/core/scenarios.py``,
imports rewritten to ``repro_torch``.

Declarative scenario lab: traffic models + timed injected events.

A ``Scenario`` is the single description of "what the world does to the
fleet" during a run: a traffic model (spike, ramp, flash crowd,
diurnal+noise — thin declarative wrappers over the generators in
``core/traces.py``) combined with timed events — device failure/recovery/
slow-down, spot preemption *with a warning lead time*, network/dispatch
degradation, tenant onboarding, and capacity grant/revoke.

``Scenario.device_events()`` lowers the device-level events into the one
``DeviceEvent`` stream format every driver already speaks
(``(time, device, kind, factor)``, time-sorted, validated at driver entry
by ``repro.core.simulator.validate_device_events``), so the scalar
``ServingSimulator``, the lane-batched ``VecSim``, and the virtual-time
``CascadeServer.run_virtual`` consume one scenario identically — the
scenario-determinism regression (tests/test_scenarios.py) pins their
decision traces to each other bit for bit. A ``SpotPreemption`` lowers to
a ``drain`` notice followed by a ``revoke`` at ``t + lead``: the revoke
tears the device down like a hard fail, but sheds (rather than replays)
whatever was still resident on the machine (the drain-window state machine
lives in the drivers; the survivor-plan precompute in
``repro.distributed.fault_tolerance``). Fleet-level events (grant/revoke)
are consumed by the ``FleetController``; tenant onboarding renders into
the per-tenant trace dict ``run_multi_tenant`` already accepts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core.traces import (diurnal_noise_trace, flash_crowd_trace,
                               ramp_trace, spiky_trace)

__all__ = [
    "Traffic", "constant", "spike", "ramp", "flash_crowd", "diurnal_noise",
    "custom_traffic",
    "DeviceFail", "DeviceRecover", "DeviceSlowdown", "SpotPreemption",
    "NetworkDegradation", "TenantOnboard", "CapacityGrant", "CapacityRevoke",
    "Scenario",
]


# ---------------------------------------------------------------------------
# Traffic models (declarative wrappers over core/traces.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Traffic:
    """One declarative traffic model; ``render()`` yields per-second QPS.

    Kept declarative (kind + params, not an array) so scenarios serialize
    naturally and two drivers rendering the same spec get bit-identical
    arrays. ``custom_traffic`` escapes the hatch for measured traces."""
    kind: str
    seconds: int
    params: Tuple[Tuple[str, float], ...] = ()
    array: Optional[np.ndarray] = None   # custom_traffic only

    def _p(self, key: str, default: float) -> float:
        for k, v in self.params:
            if k == key:
                return v
        return default

    def render(self) -> np.ndarray:
        if self.kind == "custom":
            assert self.array is not None
            return np.asarray(self.array, np.float64)
        if self.kind == "constant":
            return np.full(self.seconds, self._p("qps", 100.0), np.float64)
        if self.kind == "spike":
            return spiky_trace(
                self.seconds, base_qps=self._p("base_qps", 400.0),
                spike_qps=self._p("spike_qps", 4000.0),
                spike_at=[int(self._p("at", self.seconds // 3))],
                spike_len=int(self._p("length", 10)))
        if self.kind == "ramp":
            return ramp_trace(self.seconds,
                              start_qps=self._p("start_qps", 100.0),
                              end_qps=self._p("end_qps", 1000.0))
        if self.kind == "flash_crowd":
            return flash_crowd_trace(
                self.seconds, base_qps=self._p("base_qps", 200.0),
                peak_qps=self._p("peak_qps", 2000.0),
                at=int(self._p("at", self.seconds // 3)),
                rise=int(self._p("rise", 10)), fall=int(self._p("fall", 60)))
        if self.kind == "diurnal_noise":
            return diurnal_noise_trace(
                days=int(self._p("days", 7)),
                day_seconds=int(self._p("day_seconds", 600)),
                peak_qps=self._p("peak_qps", 2000.0),
                trough_frac=self._p("trough_frac", 0.25),
                noise=self._p("noise", 0.15),
                seed=int(self._p("seed", 0)))
        raise ValueError(f"unknown traffic kind {self.kind!r}")

    def scaled(self, factor: float) -> "Traffic":
        """Same shape at ``factor``x the rate (composition helper)."""
        if factor <= 0:
            raise ValueError(f"scale factor must be positive, got {factor}")
        return custom_traffic(self.render() * factor)

    def __add__(self, other: "Traffic") -> "Traffic":
        """Superpose two traffic models (shorter one zero-padded)."""
        a, b = self.render(), other.render()
        n = max(len(a), len(b))
        out = np.zeros(n, np.float64)
        out[:len(a)] += a
        out[:len(b)] += b
        return custom_traffic(out)


def _traffic(kind: str, seconds: int, **params: float) -> Traffic:
    if seconds < 1:
        raise ValueError(f"traffic length must be >= 1 second, got {seconds}")
    return Traffic(kind=kind, seconds=int(seconds),
                   params=tuple(sorted((k, float(v))
                                       for k, v in params.items())))


def constant(seconds: int, qps: float) -> Traffic:
    return _traffic("constant", seconds, qps=qps)


def spike(seconds: int, base_qps: float, spike_qps: float,
          at: Optional[int] = None, length: int = 10) -> Traffic:
    return _traffic("spike", seconds, base_qps=base_qps,
                    spike_qps=spike_qps,
                    at=seconds // 3 if at is None else at, length=length)


def ramp(seconds: int, start_qps: float, end_qps: float) -> Traffic:
    return _traffic("ramp", seconds, start_qps=start_qps, end_qps=end_qps)


def flash_crowd(seconds: int, base_qps: float, peak_qps: float,
                at: Optional[int] = None, rise: int = 10,
                fall: int = 60) -> Traffic:
    return _traffic("flash_crowd", seconds, base_qps=base_qps,
                    peak_qps=peak_qps,
                    at=seconds // 3 if at is None else at,
                    rise=rise, fall=fall)


def diurnal_noise(days: int = 7, day_seconds: int = 600,
                  peak_qps: float = 2000.0, trough_frac: float = 0.25,
                  noise: float = 0.15, seed: int = 0) -> Traffic:
    return _traffic("diurnal_noise", days * day_seconds, days=days,
                    day_seconds=day_seconds, peak_qps=peak_qps,
                    trough_frac=trough_frac, noise=noise, seed=seed)


def custom_traffic(qps_per_sec: np.ndarray) -> Traffic:
    arr = np.asarray(qps_per_sec, np.float64)
    if arr.ndim != 1 or not len(arr):
        raise ValueError("custom traffic must be a non-empty 1-D array")
    return Traffic(kind="custom", seconds=len(arr), array=arr)


# ---------------------------------------------------------------------------
# Injected events
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceFail:
    t: float
    device: int


@dataclass(frozen=True)
class DeviceRecover:
    t: float
    device: int


@dataclass(frozen=True)
class DeviceSlowdown:
    t: float
    device: int
    factor: float           # runtime multiplier; > 1 = slower


@dataclass(frozen=True)
class SpotPreemption:
    """Spot revoke with a warning: notice at ``t`` opens a drain window of
    ``lead`` seconds (new routing moves off the device while it keeps
    serving its queue, racing the deadline), then the machine is revoked
    at ``t + lead`` — whatever is still resident on it (queued samples,
    the in-flight batch) is lost with the machine, not replayed. ``lead
    == 0`` skips the notice: a hard preemption that sheds everything the
    device held."""
    t: float
    device: int
    lead: float = 10.0


@dataclass(frozen=True)
class NetworkDegradation:
    """Fleet-wide dispatch degradation: every batch runtime is multiplied
    by ``factor`` from ``t`` until ``until`` (congested interconnect /
    dispatch path, not one slow device)."""
    t: float
    factor: float
    until: float


@dataclass(frozen=True)
class TenantOnboard:
    """A new tenant's traffic joins the fleet at ``t`` (rendered into the
    per-tenant trace dict ``run_multi_tenant`` consumes)."""
    t: float
    name: str
    traffic: Traffic


@dataclass(frozen=True)
class CapacityGrant:
    t: float
    devices: int            # extra devices the fleet may scale into


@dataclass(frozen=True)
class CapacityRevoke:
    t: float
    devices: int            # devices withdrawn from the allowed maximum


_DEVICE_EVENTS = (DeviceFail, DeviceRecover, DeviceSlowdown, SpotPreemption,
                  NetworkDegradation)
_FLEET_EVENTS = (CapacityGrant, CapacityRevoke)
Event = Union[DeviceFail, DeviceRecover, DeviceSlowdown, SpotPreemption,
              NetworkDegradation, TenantOnboard, CapacityGrant,
              CapacityRevoke]


# ---------------------------------------------------------------------------
# The scenario
# ---------------------------------------------------------------------------

@dataclass
class Scenario:
    """One complete what-if: traffic + events + drain, ready for any driver.

    ``device_events()`` is the compiled low-level stream (time-sorted
    ``DeviceEvent`` tuples) every driver consumes through its existing
    ``device_events=`` plumbing; drivers also accept ``scenario=`` directly
    and derive trace + events + drain from it, which is the preferred
    spelling. Event validation happens twice: structurally here (at
    compile) and again at driver entry (``validate_device_events``)."""
    traffic: Traffic
    events: Tuple[Event, ...] = ()
    drain: float = 2.0
    name: str = ""
    tenants: Tuple[Tuple[str, Traffic], ...] = ()
    _qps_cache: Optional[np.ndarray] = field(default=None, repr=False,
                                             compare=False)

    def __post_init__(self) -> None:
        self.events = tuple(self.events)
        self.tenants = tuple(self.tenants)
        if self.drain < 0:
            raise ValueError(f"drain must be >= 0, got {self.drain}")
        for ev in self.events:
            if not isinstance(ev, _DEVICE_EVENTS + _FLEET_EVENTS
                              + (TenantOnboard,)):
                raise ValueError(f"unknown scenario event {ev!r}")
            if ev.t < 0:
                raise ValueError(f"event time must be >= 0: {ev!r}")
            if isinstance(ev, (DeviceFail, DeviceRecover, DeviceSlowdown,
                               SpotPreemption)) and ev.device < 0:
                raise ValueError(f"device must be >= 0: {ev!r}")
            if isinstance(ev, DeviceSlowdown) and ev.factor <= 0:
                raise ValueError(f"slow-down factor must be > 0: {ev!r}")
            if isinstance(ev, SpotPreemption) and ev.lead < 0:
                raise ValueError(f"preemption lead must be >= 0: {ev!r}")
            if isinstance(ev, NetworkDegradation) and (
                    ev.factor <= 0 or ev.until < ev.t):
                raise ValueError(f"bad degradation window: {ev!r}")
            if isinstance(ev, _FLEET_EVENTS) and ev.devices < 1:
                raise ValueError(f"capacity delta must be >= 1: {ev!r}")

    # ------------------------------------------------------------ rendering
    @property
    def seconds(self) -> int:
        return len(self.qps())

    @property
    def horizon(self) -> float:
        return float(self.seconds) + self.drain

    def qps(self) -> np.ndarray:
        if self._qps_cache is None:
            self._qps_cache = self.traffic.render()
        return self._qps_cache

    def device_events(self) -> List[Tuple[float, int, str, float]]:
        """Lower to the driver-level ``DeviceEvent`` stream, time-sorted.

        A ``SpotPreemption`` becomes a ``drain`` notice (factor = lead, for
        observability) plus a ``revoke`` at ``t + lead`` — the revoke uses
        the hard-fail teardown machinery, but work still resident on the
        machine is shed, not replayed (the machine is gone). Zero-lead
        preemptions skip the notice — that IS the hard-fail degradation
        path: everything the device held is lost. A ``NetworkDegradation``
        brackets its window with two fleet-wide ``netdeg`` events
        (device -1)."""
        out: List[Tuple[float, int, str, float]] = []
        for ev in self.events:
            if isinstance(ev, DeviceFail):
                out.append((ev.t, ev.device, "fail", 0.0))
            elif isinstance(ev, DeviceRecover):
                out.append((ev.t, ev.device, "recover", 1.0))
            elif isinstance(ev, DeviceSlowdown):
                out.append((ev.t, ev.device, "slow", ev.factor))
            elif isinstance(ev, SpotPreemption):
                if ev.lead > 0:
                    out.append((ev.t, ev.device, "drain", ev.lead))
                out.append((ev.t + ev.lead, ev.device, "revoke", 0.0))
            elif isinstance(ev, NetworkDegradation):
                out.append((ev.t, -1, "netdeg", ev.factor))
                out.append((ev.until, -1, "netdeg", 1.0))
        out.sort(key=lambda e: e[0])    # stable: ties keep declaration order
        return out

    def fleet_events(self) -> List[Tuple[float, str, int]]:
        """(t, 'grant'|'revoke', devices), time-sorted — consumed by the
        FleetController (capacity the autoscaler may scale into)."""
        out: List[Tuple[float, str, int]] = []
        for ev in self.events:
            if isinstance(ev, CapacityGrant):
                out.append((ev.t, "grant", ev.devices))
            elif isinstance(ev, CapacityRevoke):
                out.append((ev.t, "revoke", ev.devices))
        out.sort(key=lambda e: e[0])
        return out

    def tenant_traces(self) -> Dict[str, np.ndarray]:
        """Per-tenant QPS traces over the scenario window: base ``tenants``
        start at 0, ``TenantOnboard`` events join zero-padded at their
        onboarding second — directly consumable by ``run_multi_tenant``."""
        seconds = self.seconds
        out: Dict[str, np.ndarray] = {}

        def place(name: str, traffic: Traffic, start: int) -> None:
            if name in out:
                raise ValueError(f"duplicate tenant {name!r}")
            tr = traffic.render()
            padded = np.zeros(seconds, np.float64)
            end = min(seconds, start + len(tr))
            if end > start:
                padded[start:end] = tr[:end - start]
            out[name] = padded

        for name, traffic in self.tenants:
            place(name, traffic, 0)
        for ev in self.events:
            if isinstance(ev, TenantOnboard):
                place(ev.name, ev.traffic, int(ev.t))
        return out

    def preempted_devices(self) -> List[Tuple[float, int, float]]:
        """(notice_t, device, lead) per SpotPreemption, in time order."""
        return sorted((ev.t, ev.device, ev.lead) for ev in self.events
                      if isinstance(ev, SpotPreemption))

    def hard_fail_variant(self) -> "Scenario":
        """The same scenario with every preemption's warning withheld
        (lead = 0): the control arm of the drained-vs-hard-fail shed
        comparison in bench_elastic."""
        evs = tuple(
            SpotPreemption(t=ev.t + ev.lead, device=ev.device, lead=0.0)
            if isinstance(ev, SpotPreemption) else ev
            for ev in self.events)
        return Scenario(traffic=self.traffic, events=evs, drain=self.drain,
                        name=(self.name + "+hard-fail") if self.name
                        else "hard-fail", tenants=self.tenants)
