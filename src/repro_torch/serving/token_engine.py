"""Token-level serving engine: continuous batching over the model's
``prefill``/``decode_step``, with a device-resident fused decode loop
(port of ``repro/serving/token_engine.py:78-696``).

* ``SlotEngine`` — one model's resident decode batch: a fixed pool of
  ``n_slots`` KV-cache slots (one ``init_cache`` allocation, batch axis 1
  of the rep-stacked cache tensors) updated IN PLACE by every decode step,
  with a per-slot ``(B,)`` ``cache_index`` (the ragged-decode path).
  Requests join by prefilling and scattering their cache into free slots;
  rows are independent under the per-row masks.
* ``TokenEngine`` — a cascade of SlotEngines driven by the same
  ``ContinuousBatcher`` decisions as the JAX engine and the token DES:
  admission at token boundaries and mid-stream escalation from a float64
  ``StreamingCertainty`` fold of per-token top-2 gaps. Escalation carries
  the PROMPT to the next model, never the cache.

Two execution modes, as in the JAX engine:

* ``fused`` (default) — greedy argmax, the top-2-gap reduction and the
  certainty fold run on the device (``models.model.decode_fused_steps``),
  so each step ships (B,) tokens, gaps and certainties to the host; with
  ``spec_k`` > 1, K steps run per call when nothing waits and no row is
  near a decision boundary, and the host replays the boundary decisions
  over the (K, B) traces. Joiners prefill in ONE right-padded call per
  boundary, padded to power-of-two (length, batch) buckets, where padding
  is exact; otherwise (SSM state, a sliding-window ring at or below the
  length bucket) each joiner gets an exact-length batch-1 prefill.
* ``reference`` — one decode call per step and per-joiner batch-1
  prefills; the host folds each step's gaps. Unlike the JAX engine, which
  ships the full (B, V) logits to the host, the argmax and top-2 gap run
  on the device (the top2gap kernel) and only (B,) tokens and gaps come
  back.

Compiled steps, as in the JAX engine: on the card every fixed-shape entry
point runs from a CUDA graph captured at its first call and replayed at
every later one (``serving/graphs.py``), one graph per key of the JAX
engine's executable caches, all of one engine's graphs in one memory pool:
the fused decode per ``(mode, beta, k)``, the reference decode at
``(n_slots, 1)``, the bucketed prefill per (batch, length) bucket, each
also keyed by the dtypes of the pool it reads (the JAX executables are
keyed by their operands' dtypes, and an f32 SSM pool widens its conv state
at its first decode). The exact-length batch-1 prefill
(``prefill_into_slot``: the SSM path, the sliding-window ring, reference
mode) runs eagerly; ``compile_counts`` counts its distinct lengths, as the
JAX engine compiles one executable per length. For the graphs the
device-resident state (pool, tokens, positions, active mask, certainty
fold) is allocated once and only ever written in place. On the CPU the
same entry points run eagerly and ``compile_counts`` counts the same keys.

What the engines record, in place of the JAX engine's telemetry hooks (which
record logical-step events): every public ``SlotEngine`` call appends a
``CallSpan`` to ``SlotEngineStats.spans``, a bounded log of when the call
prepared, launched, waited on its read-backs and did its bookkeeping; every
``TokenResult`` carries wall stamps beside its logical steps (when it was
queued and joined at each stage it visited, its first and last token), on
``time.perf_counter()``, which no decision reads. While a torch profiler
runs, each phase of a call is also a ``record_function`` annotation named
``repro_torch.<stage>.<kind>.<phase>``, on the device trace's clock.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Deque, Dict, List, NamedTuple, Optional, Sequence, Set,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.certainty import (StreamingCertainty, device_fold_init,
                                        device_fold_set_rows)
from repro_torch.core.gears import Gear
from repro_torch.core.scheduling import (ContinuousBatcher, SchedulerConfig,
                                         SchedulerCore)
from repro_torch.kernels.top2gap import argmax_gap
from repro_torch.models import model as model_lib
from repro_torch.serving.graphs import GraphCache

__all__ = ["SlotEngine", "TokenEngine", "TokenRequest", "TokenResult",
           "SlotEngineStats", "CallSpan", "CALL_LOG_LEN", "greedy_generate"]

# entries of a SlotEngineStats.spans log: set-up and a serving window of
# minutes at a call every millisecond or more
CALL_LOG_LEN = 1 << 16


def greedy_generate(params, cfg, prompt: np.ndarray, max_new: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference single-request greedy decode: prefill + N x decode_step.

    prompt (L,) int32 -> (tokens (max_new,), per-token top-2 gaps
    (max_new,)), on the device the params live on; each step's argmax and
    gap run there too."""
    toks = np.asarray(prompt, np.int32)[None, :]
    dev = params["embed"]["embedding"].device
    logits, cache = model_lib.prefill(params, cfg, {"tokens": toks},
                                      cache_len=toks.shape[1] + max_new)
    out, gaps = [], []
    pos = toks.shape[1]
    for _ in range(max_new):
        tok_d, gap_d = argmax_gap(logits)
        nxt = int(tok_d[0])
        gaps.append(float(gap_d[0]))
        out.append(nxt)
        step = torch.full((1, 1), nxt, dtype=torch.int64, device=dev)
        logits, cache = model_lib.decode_step(
            params, cfg, step, cache,
            torch.tensor([pos], dtype=torch.int32, device=dev))
        pos += 1
    return np.asarray(out, np.int32), np.asarray(gaps, np.float64)


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    """Powers of two in [lo, hi), then hi itself as the clamp bucket."""
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


class CallSpan(NamedTuple):
    """One public ``SlotEngine`` call on ``time.perf_counter()``: prep and
    launch from ``t_enter`` to ``t_launched`` (checks, the graph key, the
    host inputs, then ``GraphCache.run``: the static-input copies and the
    replay; on the eager paths the launches), wait to ``t_synced`` (the
    blocking read-backs) and post to ``t_exit`` (the bookkeeping after
    them). An eager batch-1 prefill of several prompts is one span, its
    phases summed over the prompts."""
    kind: str            # "prefill" | "decode"
    t_enter: float
    t_launched: float
    t_synced: float
    t_exit: float
    rows: int            # prompts prefilled, or active rows decoded
    k: int               # decode steps (0 for a prefill)


@dataclass
class SlotEngineStats:
    """Hot-loop instrumentation: prefill and decode calls, prompts and
    decode steps, the prefill shapes, and ``spans``, the ``CallSpan`` of
    each of the latest ``CALL_LOG_LEN`` public calls."""
    prefill_calls: int = 0          # prefill invocations
    prefill_prompts: int = 0        # prompts prefilled across those calls
    decode_calls: int = 0           # decode invocations
    decode_steps: int = 0           # decode steps executed (sum of K)
    prefill_shapes: Set[Tuple[int, int]] = field(default_factory=set)
    spans: Deque[CallSpan] = field(
        default_factory=lambda: deque(maxlen=CALL_LOG_LEN))


class _Phases:
    """While a torch profiler runs, the phases of one public ``SlotEngine``
    call as ``record_function`` annotations named
    ``repro_torch.<stage>.<kind>.<phase>`` (prep, launch, wait, post), one
    open at a time; nothing otherwise."""
    __slots__ = ("_prefix", "_rf")

    def __init__(self, engine: SlotEngine, kind: str):
        self._prefix = (f"repro_torch.{engine.name}.{kind}."
                        if torch.autograd._profiler_enabled() else None)
        self._rf = None

    def __enter__(self) -> _Phases:
        self.to("prep")
        return self

    def to(self, phase: str) -> None:
        if self._prefix is None:
            return
        self.__exit__()
        self._rf = torch.profiler.record_function(self._prefix + phase)
        self._rf.__enter__()

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None


class SlotEngine:
    """One model's resident decode batch over a fixed KV-slot pool."""

    def __init__(self, name: str, params, cfg, n_slots: int, max_len: int,
                 min_len_bucket: int = 8,
                 device: Union[str, torch.device] = "cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.device = resolve_device(device)
        if params["embed"]["embedding"].device != self.device:
            raise ValueError(
                f"{name}: params live on "
                f"{params['embed']['embedding'].device}, engine on "
                f"{self.device}")
        self.name = name
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        # a bf16 pool whatever the params' dtype, as the JAX engine's
        # init_cache default: f32 runs attend over bf16-rounded K/V
        self.cache = model_lib.init_cache(cfg, n_slots, max_len,
                                          device=self.device)
        self.free: List[int] = list(range(n_slots - 1, -1, -1))  # pop -> 0
        # per-slot context depth (tokens already in cache); 0 = idle slot
        self.pos = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.stats = SlotEngineStats()
        # --- fused-loop state (device-resident) --------------------------
        self.dev_pos = torch.zeros(n_slots, dtype=torch.int32,
                                   device=self.device)
        self.dev_tok = torch.zeros(n_slots, dtype=torch.int32,
                                   device=self.device)
        self.dev_active = torch.zeros(n_slots, dtype=torch.bool,
                                      device=self.device)
        self._active_dirty = False
        self._fold = device_fold_init(n_slots, self.device)
        self.len_buckets = _pow2_buckets(min(min_len_bucket, max_len),
                                         max_len)
        self.batch_buckets = _pow2_buckets(1, n_slots)
        self.graphs = GraphCache(self.device)
        self._prefill_lengths: Set[int] = set()

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self.free)

    def compile_counts(self) -> Dict[str, int]:
        """Graphs per entry point, with the keys and meaning of the JAX
        engine's executable-cache sizes: the bucketed prefill stays bounded
        by the bucket grid, while ``reference_prefill`` counts the distinct
        prompt lengths of the exact-length prefills, which run eagerly and
        capture no graph."""
        out = {"reference_prefill": len(self._prefill_lengths),
               **{e: self.graphs.count(e) for e in (
                   "reference_decode", "bucketed_prefill", "fused_decode")}}
        out["total"] = sum(out.values())
        return out

    def _pool_dtypes(self) -> Tuple[torch.dtype, ...]:
        return tuple(leaf.dtype for blk in self.cache["blocks"]
                     for leaf in blk.values())

    def _widen_pool(self) -> Tuple[torch.dtype, ...]:
        """The pool's dtypes as a decode call finds them (part of its
        graph key), after widening the SSM conv state eagerly where the
        params are wider, so that no captured graph ever sees it change."""
        dtypes = self._pool_dtypes()
        model_lib.widen_ssm_cache(self.cache,
                                  self.params["embed"]["embedding"].dtype)
        return dtypes

    def _scatter(self, rows: torch.Tensor, new_cache, n: int) -> None:
        """Write the first ``n`` batch rows of a prefill cache into the
        pool lanes ``rows`` (batch axis 1), every leaf (K/V, or the SSM's
        conv and state), overwriting whole lanes so a previous occupant's
        contents cannot leak."""
        for pool, new in zip(self.cache["blocks"], new_cache["blocks"]):
            for name, leaf in pool.items():
                leaf[:, rows] = new[name][:, :n].to(leaf.dtype)

    # ------------------------------------------------------------- joins

    def _check_prompt(self, prompt: np.ndarray) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"prompt ({prompt.size} tokens) leaves no decode headroom "
                f"in a {self.max_len}-token slot")
        return prompt

    def prefill_into_slot(self, prompt: np.ndarray
                          ) -> Tuple[int, int, float]:
        """Prefill one prompt and scatter its cache into a free slot
        (reference path). Returns (slot index, first token, its top-2 gap);
        the argmax and gap run on the device."""
        t_enter = time.perf_counter()
        with _Phases(self, "prefill") as ph:
            if not self.free:
                raise RuntimeError(f"{self.name}: no free decode slot")
            prompt = self._check_prompt(prompt)
            ph.to("launch")
            logits, cache1 = model_lib.prefill(
                self.params, self.cfg, {"tokens": prompt[None, :]},
                cache_len=self.max_len)
            tok_d, gap_d = argmax_gap(logits)
            slot = self.free.pop()
            self._scatter(torch.tensor([slot], device=self.device), cache1,
                          1)
            t_launched = time.perf_counter()
            ph.to("wait")
            tok, gap = int(tok_d[0]), float(gap_d[0])
            t_synced = time.perf_counter()
            ph.to("post")
            self.pos[slot] = prompt.size
            self.active[slot] = True
            self._active_dirty = True
            self._prefill_lengths.add(int(prompt.size))
            self.stats.prefill_calls += 1
            self.stats.prefill_prompts += 1
            self.stats.prefill_shapes.add((1, int(prompt.size)))
        self.stats.spans.append(CallSpan("prefill", t_enter, t_launched,
                                         t_synced, time.perf_counter(), 1, 0))
        return slot, tok, gap

    def _len_bucket(self, n: int) -> int:
        for b in self.len_buckets:
            if n <= b:
                return b
        return self.len_buckets[-1]

    def _batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _join_rows(self, slots: Sequence[int], plens: np.ndarray,
                   toks: np.ndarray, gaps: np.ndarray) -> None:
        """Sync the fused loop's device-resident rows for new joiners:
        positions, next-token feeds, and the certainty fold re-seeded with
        each request's first (prefill) gap."""
        rows = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        self.dev_pos[rows] = torch.as_tensor(plens.astype(np.int32),
                                             device=self.device)
        self.dev_tok[rows] = torch.as_tensor(toks.astype(np.int32),
                                             device=self.device)
        device_fold_set_rows(
            self._fold, rows,
            torch.as_tensor(np.asarray(gaps, np.float32), device=self.device))
        self._active_dirty = True

    def prefill_batch(self, prompts: Sequence[np.ndarray]
                      ) -> Tuple[List[int], np.ndarray, np.ndarray]:
        """Prefill all of a boundary's joiners (fused path): one
        right-padded call, prompts padded to the smallest power-of-two
        length bucket covering the longest joiner and the batch to a batch
        bucket; the argmax/top-2-gap reduction runs on the device. Where
        padding is not exact (SSM state, MoE routing, or a sliding-window
        ring at or below the length bucket) each prompt gets an
        exact-length batch-1 prefill (``prefill_into_slot``), as in the
        JAX engine.

        Returns (slots, first tokens (n,), first gaps (n,))."""
        t_enter = time.perf_counter()
        prompts = [self._check_prompt(p) for p in prompts]
        n = len(prompts)
        if n == 0:
            return [], np.zeros(0, np.int32), np.zeros(0, np.float32)
        if n > len(self.free):
            raise RuntimeError(
                f"{self.name}: {n} joiners for {len(self.free)} free slots")
        lb = self._len_bucket(max(p.size for p in prompts))
        if not model_lib.bucketed_prefill_supported(self.cfg) or (
                self.cfg.sliding_window > 0
                and lb >= min(self.cfg.sliding_window, self.max_len)):
            joined = [self.prefill_into_slot(p) for p in prompts]
            slots = [j[0] for j in joined]
            toks = np.asarray([j[1] for j in joined], np.int32)
            gaps = np.asarray([j[2] for j in joined], np.float32)
            self._join_rows(slots, np.asarray([p.size for p in prompts]),
                            toks, gaps)
            # the prompts' own spans fold into this call's, their phases
            # summed; the time between them is prep, after them post
            t_exit, spans, inner = time.perf_counter(), self.stats.spans, []
            while spans and spans[-1].t_enter >= t_enter:
                inner.append(spans.pop())
            wait = sum(c.t_synced - c.t_launched for c in inner)
            post = t_exit - inner[0].t_exit + sum(
                c.t_exit - c.t_synced for c in inner)
            spans.append(CallSpan("prefill", t_enter, t_exit - post - wait,
                                  t_exit - post, t_exit, n, 0))
            return slots, toks, gaps
        with _Phases(self, "prefill") as ph:
            bb = self._batch_bucket(n)
            arr = np.zeros((bb, lb), np.int32)
            lens = np.ones((bb,), np.int32)
            for i, p in enumerate(prompts):
                arr[i, :p.size] = p
                lens[i] = p.size
            slots = [self.free.pop() for _ in range(n)]
            # prefill row -> pool lane; pad rows repeat the first real row
            # into its own lane, so the scatter writes one value wherever it
            # writes
            src = np.zeros(bb, np.int64)
            src[:n] = np.arange(n)
            dst = np.full(bb, slots[0], np.int64)
            dst[:n] = slots
            key = ("bucketed_prefill", bb, lb, self._pool_dtypes())
            ph.to("launch")
            tok_d, gap_d = self.graphs.run(key, self._bucketed_body, arr,
                                           lens, src, dst)
            t_launched = time.perf_counter()
            ph.to("wait")
            toks = tok_d[:n].cpu().numpy()
            gaps = gap_d[:n].cpu().numpy()
            t_synced = time.perf_counter()
            ph.to("post")
            plens = lens[:n]
            for slot, plen in zip(slots, plens):
                self.pos[slot] = plen
                self.active[slot] = True
            self._join_rows(slots, plens, toks, gaps)
            self.stats.prefill_calls += 1
            self.stats.prefill_prompts += n
            self.stats.prefill_shapes.add((bb, lb))
        self.stats.spans.append(CallSpan("prefill", t_enter, t_launched,
                                         t_synced, time.perf_counter(), n, 0))
        return slots, toks, gaps

    def _bucketed_body(self, tokens, true_lens, src, dst):
        """Padded prefill, the argmax/top-2-gap reduction, and the
        scatter into the pool lanes, layer by layer (no per-bucket cache
        outlives the call): the captured bucketed prefill."""
        logits, _ = model_lib.prefill_bucketed(
            self.params, self.cfg, tokens, true_lens,
            cache_len=self.max_len, into=(self.cache, src, dst))
        return argmax_gap(logits)

    # ----------------------------------------------------------- leaves

    def release(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.pos[slot] = 0
        self.free.append(slot)
        self._active_dirty = True

    # ------------------------------------------------------ decode steps

    def decode(self, tokens_by_slot: Dict[int, int]
               ) -> Dict[int, Tuple[int, float]]:
        """One ragged decode step over the resident batch (reference path).

        tokens_by_slot: {slot: next input token} for every ACTIVE slot.
        Idle slots ride along at position 0 with a zero token. Returns
        {slot: (greedy token, top-2 gap)}, reduced on the device, and
        advances each active slot's depth."""
        t_enter = time.perf_counter()
        with _Phases(self, "decode") as ph:
            if set(tokens_by_slot) != set(np.flatnonzero(self.active)):
                raise ValueError("decode needs exactly the active slots")
            slots = np.fromiter(tokens_by_slot.keys(), np.int64,
                                len(tokens_by_slot))
            vals = np.fromiter(tokens_by_slot.values(), np.int64, len(slots))
            if (self.pos[slots] >= self.max_len).any():
                full = int(slots[np.argmax(self.pos[slots] >= self.max_len)])
                raise ValueError(
                    f"slot {full} is full ({self.max_len} tokens)")
            toks = np.zeros((self.n_slots, 1), np.int32)
            toks[slots, 0] = vals
            key = ("reference_decode", self._widen_pool())
            ph.to("launch")
            tok_d, gap_d = self.graphs.run(key, self._reference_body, toks,
                                           self.pos.copy())
            t_launched = time.perf_counter()
            ph.to("wait")
            toks_h, gaps_h = tok_d.cpu().numpy(), gap_d.cpu().numpy()
            t_synced = time.perf_counter()
            ph.to("post")
            self.pos[slots] += 1
            self.stats.decode_calls += 1
            self.stats.decode_steps += 1
            out = {int(s): (int(toks_h[s]), float(gaps_h[s])) for s in slots}
        self.stats.spans.append(CallSpan("decode", t_enter, t_launched,
                                         t_synced, time.perf_counter(),
                                         len(slots), 1))
        return out

    def _reference_body(self, tokens, positions):
        """One decode step and its argmax/top-2-gap reduction: the
        captured reference decode."""
        logits, _ = model_lib.decode_step(self.params, self.cfg, tokens,
                                          self.cache, positions)
        return argmax_gap(logits)

    def _fused_body(self, k: int, mode: str, beta: float):
        """``k`` fused steps whose carried state is written back into
        the engine's fixed buffers: the captured fused decode."""
        tt, gt, ct, tok, _, pos, fold = model_lib.decode_fused_steps(
            self.params, self.cfg, self.dev_tok, self.cache, self.dev_pos,
            self.dev_active, self._fold, k=k, beta=beta, mode=mode)
        self.dev_tok.copy_(tok)
        self.dev_pos.copy_(pos)
        for name, t in fold.items():
            self._fold[name].copy_(t)
        return tt, gt, ct

    def decode_fused(self, k: int = 1, mode: str = "ewma",
                     beta: float = 0.35
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``k`` fused decode steps over the resident batch (device loop).

        Returns (token trace (k, B) i32, gap trace (k, B) f32, certainty
        trace (k, B) f32); input tokens, positions and the certainty fold
        stay on the device between calls. Advances every active slot's
        depth by ``k``."""
        t_enter = time.perf_counter()
        with _Phases(self, "decode") as ph:
            if self.n_active == 0:
                raise RuntimeError(f"{self.name}: no active slots to decode")
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            if int(self.pos[self.active].max()) + k > self.max_len:
                raise ValueError(
                    f"{self.name}: a {k}-step scan overruns a "
                    f"{self.max_len}-token slot")
            if self._active_dirty:
                self.dev_active.copy_(torch.from_numpy(self.active))
                self._active_dirty = False
            key = ("fused_decode", mode, float(beta), k, self._widen_pool())
            ph.to("launch")
            tt, gt, ct = self.graphs.run(
                key, lambda: self._fused_body(k, mode, float(beta)))
            t_launched = time.perf_counter()
            ph.to("wait")
            out = tt.cpu().numpy(), gt.cpu().numpy(), ct.cpu().numpy()
            t_synced = time.perf_counter()
            ph.to("post")
            rows = self.n_active
            self.pos[self.active] += k
            self.stats.decode_calls += 1
            self.stats.decode_steps += k
        self.stats.spans.append(CallSpan("decode", t_enter, t_launched,
                                         t_synced, time.perf_counter(),
                                         rows, k))
        return out


@dataclass
class TokenRequest:
    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new: int


@dataclass
class TokenResult:
    rid: int
    tokens: List[int] = field(default_factory=list)
    gaps: List[float] = field(default_factory=list)
    resolver: int = -1            # cascade stage that resolved the request
    hops: int = 0                 # mid-stream / end-of-stream escalations
    first_token_step: int = -1    # logical step of the first decode output
    done_step: int = -1
    # per-visited-stage gap stream (the tokens the request REALLY consumed
    # there — speculative tokens never enter); keyed by stage index
    stage_gaps: Dict[int, List[float]] = field(default_factory=dict)
    # wall stamps (time.perf_counter(); no decision reads them): per visited
    # stage (queued, joined), queued at ``serve``'s entry or the escalation,
    # joined at the entry of the prefill call that admitted it (its
    # ``CallSpan.t_enter``); a token's time is the exit of the stage call
    # that produced it, the first re-stamped at escalation like
    # ``first_token_step``
    stage_times: Dict[int, Tuple[float, float]] = field(
        default_factory=dict, compare=False)
    first_token_t: Optional[float] = field(default=None, compare=False)
    done_t: Optional[float] = field(default=None, compare=False)


@dataclass
class _Active:
    req: TokenRequest
    slot: int
    next_token: int               # greedy argmax fed to the next step
    cert: StreamingCertainty
    res: TokenResult


class TokenEngine:
    """Continuous-batching cascade over per-model ``SlotEngine`` pools.

    Decisions (admission, escalation, resolution) are delegated to the
    ``ContinuousBatcher``/``SchedulerCore`` copies shared with the JAX
    engine; this class owns only the real-model execution state. ``serve``
    runs the request set to completion in deterministic logical steps: one
    step = (admit + prefill joiners) then one decode phase per stage.
    ``spec_k`` > 1 runs up to K decode steps per call whenever no request
    waits at ANY stage and no resident row is near a decision boundary;
    every decision is re-derived from the returned gap trace at the same
    token counts as a K=1 run.
    """

    def __init__(self, stages: Sequence[SlotEngine], gear: Gear,
                 cfg: SchedulerConfig = SchedulerConfig(),
                 min_tokens: int = 4, early_margin: float = 0.5,
                 stream_mode: str = "ewma", beta: float = 0.35,
                 mode: str = "fused", spec_k: int = 1,
                 k_guard_slack: float = 1.5):
        if not stages:
            raise ValueError("TokenEngine needs at least one SlotEngine")
        if tuple(e.name for e in stages) != tuple(gear.cascade.models):
            raise ValueError(
                f"stage engines {[e.name for e in stages]} do not match "
                f"the gear cascade {list(gear.cascade.models)}")
        vocabs = {e.cfg.vocab_size for e in stages}
        if len(vocabs) > 1:
            # an escalation replays stage i's tokens into stage i + 1; the
            # JAX engine would clamp out-of-range ids, the torch embedding
            # would fault on the card
            raise ValueError(
                f"stages must share one vocabulary, got vocab_size "
                f"{[e.cfg.vocab_size for e in stages]} for "
                f"{[e.name for e in stages]}")
        if mode not in ("fused", "reference"):
            raise ValueError(f"mode must be fused|reference, got {mode!r}")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if mode == "reference" and spec_k != 1:
            raise ValueError("speculative scans need mode='fused'")
        self.stages = list(stages)
        self.gear = gear
        self.core = SchedulerCore([], cfg)
        self.batchers = [
            ContinuousBatcher(self.core, e.n_slots, min_tokens=min_tokens,
                              early_margin=early_margin) for e in stages]
        self.stream_mode = stream_mode
        self.beta = beta
        self.mode = mode
        self.spec_k = spec_k
        self.k_guard_slack = k_guard_slack
        self.spec_discarded = 0       # speculative tokens thrown away

    # ------------------------------------------------------------- serve

    def serve(self, requests: Sequence[TokenRequest]
              ) -> Dict[int, TokenResult]:
        """Run all requests through the cascade; returns {rid: result}."""
        queued = time.perf_counter()
        # (request, result, when it was queued)
        waiting: List[Deque[Tuple[TokenRequest, TokenResult, float]]] = [
            deque() for _ in self.stages]
        act: List[List[_Active]] = [[] for _ in self.stages]
        results: Dict[int, TokenResult] = {}
        for r in requests:
            res = TokenResult(rid=r.rid)
            results[r.rid] = res
            waiting[0].append((r, res, queued))

        step = 0
        while any(waiting) or any(act):
            for si, eng in enumerate(self.stages):
                # admission at the token boundary: prefill phase first
                self._admit(si, eng, waiting, act, step)
                if not act[si]:
                    continue
                if self.mode == "reference":
                    self._step_reference(si, eng, waiting, act, step)
                else:
                    self._step_fused(si, eng, waiting, act, step)
            step += 1
        return results

    # ------------------------------------------------------ admit phase

    def _admit(self, si: int, eng: SlotEngine, waiting, act, step: int
               ) -> None:
        k = self.batchers[si].admit(eng.n_active, len(waiting[si]))
        if not k:
            return
        entries = [waiting[si].popleft() for _ in range(k)]
        if self.mode == "reference":
            joined = []
            for req, res, queued in entries:
                slot, tok, gap = eng.prefill_into_slot(req.prompt)
                joined.append((req, res, queued, slot, tok, gap,
                               eng.stats.spans[-1]))
        else:
            slots, toks, gaps = eng.prefill_batch(
                [req.prompt for req, _, _ in entries])
            span = eng.stats.spans[-1]
            joined = [(req, res, queued, slot, int(tok), float(gap), span)
                      for (req, res, queued), slot, tok, gap
                      in zip(entries, slots, toks, gaps)]
        for req, res, queued, slot, tok, gap, span in joined:
            cert = StreamingCertainty(mode=self.stream_mode, beta=self.beta)
            cert.update(gap)
            res.tokens.append(tok)
            res.gaps.append(gap)
            res.stage_times[si] = (queued, span.t_enter)
            if res.first_token_step < 0:
                res.first_token_step = step
                res.first_token_t = span.t_exit
            act[si].append(_Active(req, slot, tok, cert, res))

    # ----------------------------------------------------- decode phase

    def _leave(self, si: int, eng: SlotEngine, a: _Active, hop, waiting,
               act, step: int) -> None:
        eng.release(a.slot)
        act[si].remove(a)
        a.res.stage_gaps[si] = list(a.res.gaps)
        if getattr(hop, "next_stage", None) is not None:
            # escalate: the prompt (never the cache) goes to the next model
            a.res.hops += 1
            a.res.tokens.clear()
            a.res.gaps.clear()
            # TTFT re-stamps at the resolving stage: the stream restarts
            a.res.first_token_step = -1
            a.res.first_token_t = None
            waiting[hop.next_stage].append(
                (a.req, a.res, time.perf_counter()))
        else:
            a.res.resolver = si
            a.res.done_step = step
            # the decode call that made its last token
            a.res.done_t = eng.stats.spans[-1].t_exit

    def _step_reference(self, si: int, eng: SlotEngine, waiting, act,
                        step: int) -> None:
        """One decode call and one host round-trip of (B,) tokens and gaps
        per step."""
        out = eng.decode({a.slot: a.next_token for a in act[si]})
        for a in act[si]:
            a.next_token, gap = out[a.slot]
            a.cert.update(gap)
            a.res.tokens.append(a.next_token)
            a.res.gaps.append(gap)
        # token-boundary decisions (iterate over a copy: leaves mutate
        # the active list)
        for a in list(act[si]):
            hop = self.batchers[si].boundary_hop(
                si, a.cert.value, len(a.res.tokens), a.req.max_new,
                self.gear)
            if hop is not None:
                self._leave(si, eng, a, hop, waiting, act, step)

    def _choose_k(self, si: int, eng: SlotEngine, waiting, act) -> int:
        """The K-collapse rule: K > 1 only when nothing waits at any stage
        and no resident row is near a decision boundary; K is capped so no
        row crosses its generation end or its slot capacity."""
        if self.spec_k <= 1:
            return 1
        if any(len(w) for w in waiting):
            return 1
        k = self.spec_k
        for a in act[si]:
            k = min(k, a.req.max_new - len(a.res.tokens),
                    eng.max_len - int(eng.pos[a.slot]))
            if k <= 1:
                return 1
        for a in act[si]:
            if self.batchers[si].near_boundary(
                    si, a.cert.value, len(a.res.tokens), a.req.max_new,
                    self.gear, self.k_guard_slack):
                return 1
        return k

    def _step_fused(self, si: int, eng: SlotEngine, waiting, act,
                    step: int) -> None:
        """One device call covers K decode steps; the host sees (K, B)
        token/gap traces and replays boundary decisions over them at the
        same token counts."""
        k = self._choose_k(si, eng, waiting, act)
        tok_t, gap_t, _cert_t = eng.decode_fused(
            k, mode=self.stream_mode, beta=self.beta)
        leaves: List[Tuple[int, int, _Active, object]] = []
        for order, a in enumerate(act[si]):
            start = len(a.res.tokens)
            used, hop = self.batchers[si].stream_trace_hop(
                si, a.cert, gap_t[:, a.slot], start, a.req.max_new,
                self.gear)
            for j in range(used):
                a.res.tokens.append(int(tok_t[j, a.slot]))
                a.res.gaps.append(float(gap_t[j, a.slot]))
            a.next_token = int(tok_t[used - 1, a.slot])
            if hop is not None:
                leaves.append((used, order, a, hop))
                self.spec_discarded += k - used
        # apply leaves in (token count, row) order — the order a
        # single-step loop would have produced them in
        leaves.sort(key=lambda e: (e[0], e[1]))
        for _, _, a, hop in leaves:
            self._leave(si, eng, a, hop, waiting, act, step)

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, object]:
        """Aggregated hot-loop instrumentation across all stages."""
        agg = {"prefill_calls": 0, "prefill_prompts": 0, "decode_calls": 0,
               "decode_steps": 0}
        for eng in self.stages:
            for key in agg:
                agg[key] += getattr(eng.stats, key)
        agg["spec_discarded"] = self.spec_discarded
        agg["prefill_shapes"] = {e.name: sorted(e.stats.prefill_shapes)
                                 for e in self.stages}
        agg["compiles"] = {e.name: e.compile_counts() for e in self.stages}
        return agg
