"""The profiler's view of a traced run: short slices spread over the window.

A cell's device runs thousands of kernels a logical step, so a trace of a
whole window holds millions of events. A ``--trace 1`` run traces two kinds
of slice instead, each reduced as soon as it stops:

* ``SLICES`` slices at fixed times, each from the first logical step
  boundary at or after (i + 1/2) / SLICES of ``--seconds`` to the first
  boundary at least ``SLICE_SECONDS`` later (or the end of its burst):
  whatever the window does then, so that their idle share, kernel times
  and breakdown stand for the window (``TraceResult`` ``steps``);
* ``PREFILL_SLICES`` slices of one prefill call each, the first call that
  starts at or after (i + 1/2) / PREFILL_SLICES of ``--seconds`` outside a
  fixed slice, for the kernels that only a prefill runs
  (``TraceResult`` ``prefills``).

From a slice's raw events: its window, the host annotation that brackets
it; the union of its device operations (kernels, copies, sets): busy time;
the device time of each operation name, and its count; every idle interval
of the device, labelled by the stage call the host was in at its midpoint
(the recorder annotates each call), else ``engine loop``.

Logical steps in which a slice starts or stops, or that it covers, are
marked traced: the host-clock readers leave them out.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

__all__ = ["SLICES", "SLICE_SECONDS", "PREFILL_SLICES", "Slicer",
           "Slices", "TraceResult"]

SLICES = 6
SLICE_SECONDS = 0.5
PREFILL_SLICES = 12
_OURS = "portbench "
_WINDOW = _OURS + "slice"
_CALL = _OURS + "call: "
_LOOP = "engine loop"


@dataclass
class Slices:
    """What slices of one kind saw, added up."""
    window_s: float = 0.0
    busy_s: float = 0.0
    by_name: Dict[str, List[float]] = field(default_factory=dict)
    idle_by_label: Dict[str, float] = field(default_factory=dict)
    slices: int = 0

    def device_seconds(self, needle: str) -> float:
        """Device seconds of the operations whose name holds ``needle``."""
        return sum(v[0] for k, v in self.by_name.items() if needle in k)

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps[:10]]}


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.profiler.ProfilerActivity.CUDA in \
            torch.profiler.supported_activities():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _annotation(e) -> bool:
    """A host annotation, or its mirror on the device's timeline."""
    flag = getattr(e, "is_user_annotation", None)
    return (flag is not None and flag()) or e.name().startswith(_OURS)


@dataclass
class TraceResult:
    """The fixed-time slices (``steps``) and the prefill slices
    (``prefills``) of a traced run."""
    steps: Slices = field(default_factory=Slices)
    prefills: Slices = field(default_factory=Slices)

    @property
    def window_s(self) -> float:
        return self.steps.window_s

    @property
    def busy_s(self) -> float:
        return self.steps.busy_s

    def breakdown(self) -> dict:
        return self.steps.breakdown()


def reduce_events(events, result: Slices) -> None:
    """Add one slice's raw profiler events to ``result``."""
    win = None
    dev: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    for e in events:
        on_device = str(e.device_type()).endswith("CUDA")
        start = e.start_ns()
        end = start + e.duration_ns()
        if _annotation(e):
            if not on_device and e.name() == _WINDOW:
                win = (start, end)
            elif not on_device and e.name().startswith(_CALL):
                spans.append((start, end, e.name()[len(_CALL):]))
            continue
        if on_device and end > start:
            dev.append((start, end, e.name()))
    if win is None:
        return
    ws, we = win
    busy = _union([(max(s, ws), min(e, we)) for s, e, _ in dev
                   if e > ws and s < we])
    for s, e, name in dev:
        v = result.by_name.setdefault(name, [0.0, 0])
        v[0] += (e - s) / 1e9
        v[1] += 1
    result.window_s += (we - ws) / 1e9
    result.busy_s += sum(e - s for s, e in busy) / 1e9
    result.slices += 1
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    spans.sort()
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = (gs + ge) / 2
        label = next((n for s, e, n in spans if s <= mid <= e), _LOOP)
        result.idle_by_label[label] = \
            result.idle_by_label.get(label, 0.0) + (ge - gs) / 1e9


class Slicer:
    """Starts and stops the profiler (see the module docstring): at logical
    step boundaries for the fixed-time slices, around single calls for the
    prefill slices."""

    def __init__(self, seconds: float):
        self.starts = [(i + 0.5) * seconds / SLICES for i in range(SLICES)]
        self.prefill_starts = [(i + 0.5) * seconds / PREFILL_SLICES
                               for i in range(PREFILL_SLICES)]
        self.result = TraceResult()
        self.active = False
        self.t0 = 0.0
        self._next = 0
        self._next_prefill = 0
        self._prof = None
        self._window = None
        self._since = 0.0
        self.overhead_s = 0.0     # host seconds starting, stopping, reducing

    @staticmethod
    def prime() -> None:
        """One empty profile, so that the profiler's first start (which
        loads CUPTI) falls in set-up."""
        with torch.profiler.profile(activities=_activities()):
            torch.zeros(1).add_(1)

    def start_window(self, t0: float) -> None:
        self.t0 = t0

    def span(self, name: str):
        """A host annotation around one stage call, named ``name``."""
        return torch.profiler.record_function(_CALL + name)

    def boundary(self, end: bool = False) -> bool:
        """At a logical step boundary: stop the fixed-time slice that has
        run long enough (or whose burst ends), or start the next one that
        is due. Returns whether the profiler was started or stopped."""
        now = time.perf_counter()
        if self.active:
            if end or now - self._since >= SLICE_SECONDS:
                self._stop(self.result.steps)
                return True
        elif (not end and self._next < len(self.starts)
              and now - self.t0 >= self.starts[self._next]):
            self._next += 1
            self._start()
            return True
        return False

    def prefill_due(self) -> bool:
        """Whether the prefill call about to start is the next one to be
        traced alone: one is due and no fixed-time slice runs."""
        if self.active or self._next_prefill >= len(self.prefill_starts):
            return False
        return time.perf_counter() - self.t0 >= \
            self.prefill_starts[self._next_prefill]

    @contextlib.contextmanager
    def prefill_slice(self):
        """A slice around one prefill call (``prefill_due``)."""
        self._next_prefill += 1
        self._start()
        try:
            yield
        finally:
            self._stop(self.result.prefills)

    def finish(self) -> TraceResult:
        if self.active:
            self._stop(self.result.steps)
        return self.result

    def _start(self) -> None:
        t0 = time.perf_counter()
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.start()
        self._window = torch.profiler.record_function(_WINDOW)
        self._window.__enter__()
        self._since = time.perf_counter()
        self.active = True
        self.overhead_s += self._since - t0

    def _stop(self, into: Slices) -> None:
        t0 = time.perf_counter()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        reduce_events(self._prof.profiler.kineto_results.events(), into)
        self._prof = None
        self.active = False
        self.overhead_s += time.perf_counter() - t0
