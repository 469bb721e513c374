"""What a run hands to the metric readers: the window's bursts, calls and
logical steps, the stages' models, the traffic, the trace, and helpers
that the readers share."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from portbench import counting
from portbench.recorder import Burst, Call, Recorder
from portbench.trace import TraceResult

__all__ = ["Record"]


@dataclass
class Record:
    models: List[dict]            # each stage's model fields
    names: List[str]              # each stage's name
    traffic: dict
    recorder: Recorder
    setup_s: float
    build_s: float
    trace: Optional[TraceResult] = None
    _times: Dict[int, Tuple[float, float]] = field(default_factory=dict)

    @property
    def bursts(self) -> List[Burst]:
        return self.recorder.bursts

    @property
    def window_s(self) -> float:
        """From the first burst's submission to the last one's end."""
        return self.bursts[-1].t_end - self.bursts[0].t_sub

    def requests(self) -> Iterator[Tuple[Burst, object, object]]:
        """(burst, request, result) of every request in the window."""
        for b in self.bursts:
            for r in b.requests:
                yield b, r, b.results[r.rid]

    def token_times(self) -> Dict[int, Tuple[float, float]]:
        """{rid: (first token, last token)} at the resolving stage."""
        if not self._times:
            for b in self.bursts:
                self._times.update(self.recorder.request_times(b))
        return self._times

    def steps(self, traced: Optional[bool] = None
              ) -> Iterator[Tuple[float, float, List[Call]]]:
        """(start, end, calls) of every logical step of the window; with
        ``traced`` given, only the steps a profiler slice touched (True) or
        did not touch (False)."""
        for bi, b in enumerate(self.bursts):
            for si, span in enumerate(self.recorder.step_spans(b)):
                step = span[2][0].step
                hit = (bi, step) in self.recorder.steps_traced
                if traced is None or hit == traced:
                    yield span

    def calls(self, traced: Optional[bool] = None) -> Iterator[Call]:
        for _, _, calls in self.steps(traced):
            yield from calls

    def call_bound_s(self, c: Call) -> float:
        """The least time the chip could take for call ``c``."""
        m = self.models[c.stage]
        if c.kind == "prefill":
            if m["family"] == "ssm":    # one batch-1 call a prompt
                return sum(counting.bound_s(*counting.prefill_call(m, [n]))
                           for n in c.lens)
            return counting.bound_s(*counting.prefill_call(m, c.lens))
        return counting.bound_s(
            *counting.decode_call(m, c.pos[c.active], c.k))

    def decode_valid(self, c: Call) -> Iterator[np.ndarray]:
        """Each step of decode call ``c``: the decode kernel's valid length
        of every slot (an idle slot decodes at position 0: one key)."""
        for j in range(c.k):
            yield np.where(c.active, c.pos + j + 1, 1)
