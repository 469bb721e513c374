"""What the port's serving engine records about time, on the CPU: the wall
stamps of every ``TokenResult``, the ``CallSpan`` log of every
``SlotEngine`` call, the ``record_function`` annotations of each call's
phases under a profiler.

Tiny models: the smoke configs of qwen2-0.5b (bucketed prefills) and
falcon-mamba-7b (eager batch-1 prefills), float32 weights from the port's
own ``init_params``. The stamps are held against the benchmark's recorder
(``portbench.recorder.Recorder``), which stamps the host clock around each
call from outside the program: these tests read its ``Call`` records and
``request_times``, so a change to those is made here too.
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.cascade import Cascade
from repro_torch.core.certainty import StreamingCertainty
from repro_torch.core.gears import Gear
from repro_torch.models import model as model_lib
from repro_torch.serving import token_engine as TT

# the benchmark's package sits at the repository root, beside ``src``
_ROOT = str(Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench.recorder import Burst, Recorder  # noqa: E402

torch.set_num_threads(1)

PHASES = ("prep", "launch", "wait", "post")
# (arch, mode, spec_k): bucketed prefills at K 1 and 4, reference mode,
# and the SSM's eager batch-1 prefills
RUNS = [("qwen2-0.5b", "fused", 1), ("qwen2-0.5b", "fused", 4),
        ("qwen2-0.5b", "reference", 1), ("falcon-mamba-7b", "fused", 4)]
RUN_IDS = ["dense-k1", "dense-k4", "dense-reference", "ssm-k4"]
# the runs the recorder can follow: it wraps the fused entry points only
FUSED = [r for r in RUNS if r[1] == "fused"]
FUSED_IDS = [i for r, i in zip(RUNS, RUN_IDS) if r[1] == "fused"]
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen2-0.5b", "falcon-mamba-7b"):
        cfg = get_smoke_config(arch)
        params = {name: model_lib.init_params(cfg, seed, torch.float32,
                                              "cpu")
                  for name, seed in (("a", 0), ("b", 7))}
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, 5 + 3 * i)
                   .astype(np.int32) for i in range(6)]
        out[arch] = (cfg, params, prompts, _midrange(cfg, params, prompts))
    return out


def _midrange(cfg, params, prompts):
    """A stage-a threshold between two neighbouring end-of-stream folds
    around the median, so that some requests escalate and some do not."""
    finals = []
    for p in prompts:
        _, gaps = TT.greedy_generate(params["a"], cfg, p, MAX_NEW)
        c = StreamingCertainty()
        for g in gaps:
            c.update(float(g))
        finals.append(c.value)
    s = np.sort(finals)
    return float(0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2]))


def _cascade(models, arch, mode, spec_k):
    cfg, params, prompts, thr = models[arch]
    stages = [TT.SlotEngine(n, params[n], cfg, n_slots=3, max_len=40,
                            device="cpu") for n in ("a", "b")]
    gear = Gear(cascade=Cascade(("a", "b"), (thr,)),
                min_queue_lens={"a": 1, "b": 1},
                load_fractions={"a": {0: 1.0}, "b": {1: 1.0}})
    te = TT.TokenEngine(stages, gear, min_tokens=2, mode=mode,
                        spec_k=spec_k)
    reqs = [TT.TokenRequest(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    return stages, te, reqs


def _recorded(models, arch, mode, spec_k):
    """One burst served under the benchmark's recorder."""
    stages, te, reqs = _cascade(models, arch, mode, spec_k)
    rec = Recorder(stages)
    rec.begin_burst(reqs)
    t_sub = time.perf_counter()
    res = te.serve(reqs)
    rec.end_burst(Burst(t_sub, time.perf_counter(), reqs, res))
    return stages, rec, res


# ------------------------------------------------------------ requests

@pytest.mark.parametrize("arch,mode,spec_k", RUNS, ids=RUN_IDS)
def test_request_stamps_are_ordered(models, arch, mode, spec_k):
    stages, te, reqs = _cascade(models, arch, mode, spec_k)
    t0 = time.perf_counter()
    res = te.serve(reqs)
    t1 = time.perf_counter()
    assert {r.hops for r in res.values()} == {0, 1}
    for r in res.values():
        assert sorted(r.stage_times) == list(range(r.hops + 1))
        last = t0
        for si in sorted(r.stage_times):
            queued, joined = r.stage_times[si]
            assert last <= queued <= joined
            last = joined
        assert last <= r.first_token_t <= r.done_t <= t1
        if r.hops:      # stage b queued it after stage a admitted it
            assert r.stage_times[0][1] < r.stage_times[1][0]


@pytest.mark.parametrize("arch,mode,spec_k", RUNS, ids=RUN_IDS)
def test_stamps_take_no_part_in_results(models, arch, mode, spec_k):
    """Two serves of the same requests give equal results, stamps apart,
    and the stamps do differ."""
    _, te, reqs = _cascade(models, arch, mode, spec_k)
    first = te.serve(reqs)
    _, te, reqs = _cascade(models, arch, mode, spec_k)
    second = te.serve(reqs)
    assert first == second
    assert all(first[r].done_t != second[r].done_t for r in first)


@pytest.mark.parametrize("arch,mode,spec_k", FUSED, ids=FUSED_IDS)
def test_first_and_last_token_within_the_recorders_calls(models, arch, mode,
                                                         spec_k):
    """``Recorder.request_times`` takes the end of the call it maps a
    token to; the program's stamps lie inside that very call."""
    stages, rec, res = _recorded(models, arch, mode, spec_k)
    burst = rec.bursts[0]
    by = {(c.step, c.stage, c.kind): c for c in burst.calls}
    times = rec.request_times(burst)
    for rid, r in res.items():
        first = by[(r.first_token_step, r.resolver, "prefill")]
        last = by[(r.done_step, r.resolver, "decode")]
        assert first.t0 <= r.first_token_t <= first.t1 == times[rid][0]
        assert last.t0 <= r.done_t <= last.t1 == times[rid][1]


# --------------------------------------------------------------- spans

@pytest.mark.parametrize("arch,mode,spec_k", FUSED, ids=FUSED_IDS)
def test_spans_add_up_and_nest_in_the_recorders_calls(models, arch, mode,
                                                      spec_k):
    """One span a call, inside the recorder's outer stamps, its phases in
    order and adding up to it, its rows and steps those of the call."""
    stages, rec, _ = _recorded(models, arch, mode, spec_k)
    for si, eng in enumerate(stages):
        calls = [c for c in rec.calls if c.stage == si]
        spans = list(eng.stats.spans)
        assert len(spans) == len(calls) > 0
        for c, s in zip(calls, spans):
            assert s.kind == c.kind
            stamps = [s.t_enter, s.t_launched, s.t_synced, s.t_exit]
            assert c.t0 <= s.t_enter and s.t_exit <= c.t1
            assert stamps == sorted(stamps)
            phases = np.diff(stamps)
            assert phases.sum() == pytest.approx(s.t_exit - s.t_enter,
                                                 abs=1e-9)
            if c.kind == "prefill":
                assert (s.rows, s.k) == (len(c.lens), 0)
            else:
                assert (s.rows, s.k) == (int(c.active.sum()), c.k)
                assert phases[0] > 0   # the graph run launched something


def test_reference_calls_are_spanned(models):
    stages, te, reqs = _cascade(models, "qwen2-0.5b", "reference", 1)
    te.serve(reqs)
    for eng in stages:
        kinds = [s.kind for s in eng.stats.spans]
        assert kinds.count("prefill") == eng.stats.prefill_calls
        assert kinds.count("decode") == eng.stats.decode_calls
        assert all(s.rows == 1 for s in eng.stats.spans
                   if s.kind == "prefill")


def test_eager_prefill_batch_is_one_span(models):
    """The SSM's batch-1 prefills of one ``prefill_batch`` call make one
    span of all its prompts."""
    cfg, params, prompts, _ = models["falcon-mamba-7b"]
    eng = TT.SlotEngine("a", params["a"], cfg, n_slots=3, max_len=40,
                        device="cpu")
    t0 = time.perf_counter()
    eng.prefill_batch(prompts[:3])
    t1 = time.perf_counter()
    (s,) = eng.stats.spans
    assert eng.stats.prefill_calls == 3
    assert (s.kind, s.rows, s.k) == ("prefill", 3, 0)
    assert t0 <= s.t_enter < s.t_launched < s.t_synced < s.t_exit <= t1


def test_eager_prefill_batch_goes_through_prefill_into_slot(models):
    """Each prompt of an eager ``prefill_batch`` is a call of the public
    ``prefill_into_slot``, so a wrapper set on the instance sees every
    one; the log still holds one span of the whole call, whose wait is
    the sum of the prompts' waits."""
    cfg, params, prompts, _ = models["falcon-mamba-7b"]
    eng = TT.SlotEngine("a", params["a"], cfg, n_slots=3, max_len=40,
                        device="cpu")
    seen, inner = [], []
    real = eng.prefill_into_slot

    def wrapped(prompt):
        seen.append(len(prompt))
        out = real(prompt)
        inner.append(eng.stats.spans[-1])
        return out
    eng.prefill_into_slot = wrapped
    slots, _, _ = eng.prefill_batch(prompts[:3])
    assert seen == [len(p) for p in prompts[:3]] and len(slots) == 3
    (s,) = eng.stats.spans
    assert s.t_enter <= inner[0].t_enter and inner[-1].t_exit <= s.t_exit
    assert s.t_synced - s.t_launched == pytest.approx(
        sum(c.t_synced - c.t_launched for c in inner), abs=1e-9)


def test_a_call_that_raises_logs_nothing(models):
    cfg, params, _, _ = models["qwen2-0.5b"]
    eng = TT.SlotEngine("a", params["a"], cfg, n_slots=2, max_len=40,
                        device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            eng.decode_fused(1)
    assert len(eng.stats.spans) == 0
    names = [e.name for e in prof.events()]
    assert "repro_torch.a.decode.prep" in names


def test_the_log_stays_bounded(models, monkeypatch):
    monkeypatch.setattr(TT, "CALL_LOG_LEN", 5)
    cfg, params, prompts, _ = models["qwen2-0.5b"]
    eng = TT.SlotEngine("a", params["a"], cfg, n_slots=2, max_len=40,
                        device="cpu")
    eng.prefill_batch(prompts[:1])
    for _ in range(8):
        eng.decode_fused(1)
    spans = list(eng.stats.spans)
    assert eng.stats.spans.maxlen == 5 and len(spans) == 5
    assert [s.kind for s in spans] == ["decode"] * 5
    assert [s.t_enter for s in spans] == sorted(s.t_enter for s in spans)
    assert eng.stats.decode_calls == 8


def test_stats_report_calls_and_steps(models):
    stages, te, reqs = _cascade(models, "qwen2-0.5b", "fused", 4)
    te.serve(reqs)
    st = te.stats()
    assert {"prefill_calls", "prefill_prompts", "decode_calls",
            "decode_steps"} <= set(st)
    assert st["decode_steps"] == sum(s.k for e in stages
                                     for s in e.stats.spans)


# --------------------------------------------------------- annotations

def _annotations(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("repro_torch.")]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_phases_are_annotated_under_a_profiler(models, arch):
    stages, te, reqs = _cascade(models, arch, "fused", 4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            te.serve(reqs)
    events = prof.profiler.kineto_results.events()
    (outer,) = [e for e in events if e.name() == "outer"]
    o0, o1 = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    ours = _annotations(prof)
    assert {e.name() for e in ours} == {
        f"repro_torch.{s}.{k}.{p}" for s in ("a", "b")
        for k in ("prefill", "decode") for p in PHASES}
    for e in ours:
        assert e.is_user_annotation()
        assert o0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= o1
    # each call's phases follow each other in order, one span of the log
    # apiece (the SSM's eager prefills: prep to post once a prompt)
    for eng in stages:
        for kind in ("prefill", "decode"):
            seq = [e.name().rsplit(".", 1)[1] for e in sorted(
                ours, key=lambda e: e.start_ns())
                if e.name().startswith(f"repro_torch.{eng.name}.{kind}.")]
            calls = sum(s.kind == kind for s in eng.stats.spans)
            rows = sum(s.rows for s in eng.stats.spans if s.kind == kind)
            per = rows if (kind == "prefill"
                           and arch == "falcon-mamba-7b") else calls
            assert seq == list(PHASES) * per


def test_no_annotation_without_a_profiler(models, monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    stages, te, reqs = _cascade(models, "qwen2-0.5b", "fused", 4)
    te.serve(reqs)
    assert made == [] and all(len(e.stats.spans) for e in stages)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        stages, te, reqs = _cascade(models, "qwen2-0.5b", "fused", 4)
        te.serve(reqs)
    assert made and all(n.startswith("repro_torch.") for n in made)
