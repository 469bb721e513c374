"""Spans around the port's stage calls, and the logical steps they make.

``TokenEngine.serve`` drives each ``SlotEngine`` through two public calls
in fused mode: ``prefill_batch`` (the joiners of a token boundary) and
``decode_fused`` (k decode steps over the resident rows), and frees a slot
with ``release``. The recorder wraps the three on each stage: host clock
stamps around every call (each call ends in a device-to-host copy, so its
end is the device's end too), the shapes the counting functions need (the
prompts' lengths; the slots' depths and active mask before a decode), and
what each call returned for which request, so that every stage's stream of
tokens and gaps can be compared with what the engine reported.

``TokenResult`` counts logical steps, not time. In one logical step each
stage, in order, may prefill its joiners and then decodes once if it holds
rows, so the calls of a step run in the order (stage, prefill before
decode), and a call that is not later in that order than the call before
it starts a new step. A request's first token is the end of its resolving
stage's prefill call in its ``first_token_step``; its last token the end of
that stage's decode call in its ``done_step``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Call", "Burst", "Recorder", "StepError"]


class StepError(RuntimeError):
    """The calls do not make the logical steps the results name."""


@dataclass
class Call:
    stage: int
    kind: str                 # "prefill" | "decode"
    t0: float
    t1: float
    burst: int
    step: int                 # logical step within its burst
    lens: Tuple[int, ...] = ()            # prefill: prompt lengths
    k: int = 0                            # decode: steps in the call
    pos: Optional[np.ndarray] = None      # decode: slot depths before
    active: Optional[np.ndarray] = None   # decode: active slots before
    traced: str = ""          # "steps" | "prefill": the slice it ran in


@dataclass
class Burst:
    t_sub: float
    t_end: float
    requests: list            # TokenRequest
    results: dict             # rid -> TokenResult
    spec_discarded: int = 0
    thresholds: List[float] = field(default_factory=list)   # the gear's
    calls: List[Call] = field(default_factory=list)


_ORDER = {"prefill": 0, "decode": 1}


class Recorder:
    """Wraps the stages of a ``TokenEngine`` (see the module docstring).

    ``slicer`` (``trace.Slicer`` or None) is told of every new logical step
    and of every call, and may trace them: a step at a time, or one
    prefill call alone."""

    def __init__(self, stages, slicer=None):
        self.stages = stages
        self.slicer = slicer
        self.calls: List[Call] = []
        self.bursts: List[Burst] = []
        self.streams: Dict[Tuple[int, int], Tuple[list, list]] = {}
        self._rid: Dict[int, int] = {}
        self._owner: List[Dict[int, int]] = [dict() for _ in stages]
        self._burst = -1
        self._step = -1
        self._last: Optional[Tuple[int, int]] = None
        self.steps_traced: set = set()
        for si, eng in enumerate(stages):
            self._wrap(si, eng)

    # -------------------------------------------------------------- bursts

    def begin_burst(self, requests) -> None:
        self._burst += 1
        self._step = -1
        self._last = None
        self._rid = {id(r.prompt): r.rid for r in requests}

    def end_burst(self, burst: Burst) -> None:
        if self.slicer is not None:
            self.slicer.boundary(end=True)
        burst.calls = [c for c in self.calls if c.burst == self._burst]
        self.bursts.append(burst)

    # --------------------------------------------------------------- calls

    def _begin(self, si: int, kind: str) -> Tuple[int, str]:
        key = (si, _ORDER[kind])
        toggled = False
        if self._last is None or key <= self._last:
            self._step += 1
            if self.slicer is not None:
                toggled = self.slicer.boundary()
        self._last = key
        traced = "steps" if self.slicer is not None and self.slicer.active \
            else ""
        if traced or toggled:
            self.steps_traced.add((self._burst, self._step))
        return self._step, traced

    def _span(self, traced: str, kind: str, si: int):
        if traced:
            return self.slicer.span(f"{kind} call {self.stages[si].name}")
        return contextlib.nullcontext()

    def _wrap(self, si: int, eng) -> None:
        prefill_batch = eng.prefill_batch
        decode_fused = eng.decode_fused
        release = eng.release

        def prefill_batch_rec(prompts):
            rids = [self._rid.get(id(p)) for p in prompts]
            lens = tuple(int(len(p)) for p in prompts)
            step, traced = self._begin(si, "prefill")
            alone = contextlib.nullcontext()
            if not traced and self.slicer is not None \
                    and self.slicer.prefill_due():
                traced = "prefill"
                self.steps_traced.add((self._burst, step))
                alone = self.slicer.prefill_slice()
            with alone, self._span(traced, "prefill", si):
                t0 = time.perf_counter()
                out = prefill_batch(prompts)
                t1 = time.perf_counter()
            self.calls.append(Call(si, "prefill", t0, t1, self._burst, step,
                                   lens=lens, traced=traced))
            slots, toks, gaps = out
            for rid, slot, tok, gap in zip(rids, slots, toks, gaps):
                self._owner[si][int(slot)] = rid
                self.streams[(rid, si)] = ([int(tok)], [float(gap)])
            return out

        def decode_fused_rec(k=1, mode="ewma", beta=0.35):
            pos, active = eng.pos.copy(), eng.active.copy()
            step, traced = self._begin(si, "decode")
            with self._span(traced, "decode", si):
                t0 = time.perf_counter()
                out = decode_fused(k, mode=mode, beta=beta)
                t1 = time.perf_counter()
            self.calls.append(Call(si, "decode", t0, t1, self._burst, step,
                                   k=int(k), pos=pos, active=active,
                                   traced=traced))
            tt, gt, _ = out
            for slot, rid in self._owner[si].items():
                toks, gaps = self.streams[(rid, si)]
                toks.extend(int(t) for t in tt[:, slot])
                gaps.extend(float(g) for g in gt[:, slot])
            return out

        def release_rec(slot):
            self._owner[si].pop(int(slot), None)
            return release(slot)

        eng.prefill_batch = prefill_batch_rec
        eng.decode_fused = decode_fused_rec
        eng.release = release_rec

    def detach(self) -> None:
        """Let go of the stages, so that freeing them frees their memory
        (the wrappers stay on them, recording nothing further)."""
        self.stages = []

    # ------------------------------------------------------------ readings

    def request_times(self, burst: Burst) -> Dict[int, Tuple[float, float]]:
        """{rid: (time of the first token, time of the last token)} at the
        resolving stage, from the logical steps the result names."""
        by = {(c.step, c.stage, c.kind): c for c in burst.calls}
        if len(by) != len(burst.calls):
            raise StepError("two calls of one stage and kind in one step")
        out = {}
        for rid, res in burst.results.items():
            first = by.get((res.first_token_step, res.resolver, "prefill"))
            last = by.get((res.done_step, res.resolver, "decode"))
            if first is None or last is None:
                raise StepError(
                    f"request {rid}: no prefill call of stage "
                    f"{res.resolver} in step {res.first_token_step} or no "
                    f"decode call in step {res.done_step}")
            out[rid] = (first.t1, last.t1)
        return out

    def step_spans(self, burst: Burst) -> List[Tuple[float, float, list]]:
        """Each logical step of the burst as (start, end, calls): from the
        end of the step before (the submission, for the first) to the end
        of its last call, the last step to the end of ``serve``."""
        steps: Dict[int, list] = {}
        for c in burst.calls:
            steps.setdefault(c.step, []).append(c)
        out = []
        t = burst.t_sub
        for s in sorted(steps):
            end = max(c.t1 for c in steps[s])
            out.append((t, end, steps[s]))
            t = end
        if out:
            out[-1] = (out[-1][0], burst.t_end, out[-1][2])
        return out
