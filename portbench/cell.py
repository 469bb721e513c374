"""One run of one cell: the port's token cascade built from the cell's files,
warmed up, driven by bursts for the window, read, checked.

The system under test is ``repro_torch.serving.token_engine.TokenEngine``
in fused mode over one ``SlotEngine`` a stage, each stage's model a
``repro_torch.configs.base.ModelConfig`` built from the configuration file,
its weights drawn by ``weights.draw``. Set-up warms exactly the shapes the
cell's traffic can reach: every (batch, length) bucket of a bucketed
prefill that some set of the traffic's prompt lengths falls into (within a
stage's slots), the fused decode at every k up to ``spec_k``, and for an
exact-length prefill the longest and shortest prompt.

Then set-up calibrates the cascade, as CascadeServe calibrates a gear's
thresholds for the models at hand, on the window's own bursts: the first
``calibrated_bursts`` bursts of the seed's stream (the traffic file) served
by stage a alone, and for each burst the threshold under which the
cascade's rule, replayed over its gap streams (``check.replay``), escalates
the share ``escalate_share`` of it. The window serves each burst under its
own threshold (a burst past those under their median), so every burst
escalates the same share. A threshold calibrated once for all bursts
escalated 40-59 % of a window from seed to seed, and the seed's share set
how long the window's bursts took.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import bench, check, traffic as traffic_lib, weights
from portbench.record import Record
from portbench.recorder import Burst, Recorder
from portbench.trace import Slicer

__all__ = ["System", "run", "serve_window", "reachable_buckets"]


def _port():
    """The port's modules, imported from the checkout's ``src``."""
    src = str(bench.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.configs.base import ModelConfig, SSMConfig
    from repro_torch.core.cascade import Cascade
    from repro_torch.core.gears import Gear
    from repro_torch.models import model as model_lib
    from repro_torch.serving.token_engine import (SlotEngine, TokenEngine,
                                                  TokenRequest)
    return dict(ModelConfig=ModelConfig, SSMConfig=SSMConfig,
                Cascade=Cascade, Gear=Gear, model_lib=model_lib,
                SlotEngine=SlotEngine, TokenEngine=TokenEngine,
                TokenRequest=TokenRequest)


def model_config(m: dict):
    port = _port()
    fields = dict(m)
    ssm = fields.pop("ssm", None)
    return port["ModelConfig"](
        **fields, ssm=port["SSMConfig"](**ssm) if ssm else None)


def reachable_buckets(len_buckets: List[int], batch_buckets: List[int],
                      prompt_lens: np.ndarray, slots: int) -> List[tuple]:
    """(batch, length) buckets that some set of joiners drawn from
    ``prompt_lens`` reaches: a length bucket that holds the longest of them
    and a batch bucket that holds how many they are (at most ``slots``)."""
    out = []
    prev = 0
    for lb in len_buckets:
        fits = int((prompt_lens <= lb).sum())
        tops = ((prompt_lens > prev) & (prompt_lens <= lb)).any()
        prev = lb
        if not tops:
            continue
        lo = 1
        for bb in batch_buckets:
            if lo <= min(fits, slots):
                out.append((bb, lb))
            lo = bb + 1
    return out


def threshold_for(streams, share: float, traffic: dict) -> float:
    """The threshold under which the share of the (gaps, max_new) stage-a
    streams that escalates is closest to ``share``."""
    def escalated(t):
        return sum(check.replay(g, n, t, traffic["min_tokens"],
                                traffic["early_margin"],
                                traffic["beta"])[1] == "escalate"
                   for g, n in streams) / len(streams)
    lo, hi = 0.0, max(max(g) for g, _ in streams) * 2 + 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if escalated(mid) < share:
            lo = mid
        else:
            hi = mid
    return hi if abs(escalated(hi) - share) <= abs(escalated(lo) - share) \
        else lo


class System:
    """The cascade of one cell (see the module docstring)."""

    def __init__(self, cell: bench.Cell, seed: int, device):
        port = _port()
        self.port = port
        self.cell = cell
        self.device = device
        tr = cell.traffic
        stages = cell.config["stages"]
        self.names = [s["name"] for s in stages]
        self.models = [s["model"] for s in stages]
        self.params = weights.draw(
            self.models, cell.config["init"], seed, device)
        self.cfgs = [model_config(m) for m in self.models]
        self.engines = [
            port["SlotEngine"](n, p, c, tr["slots"][n], tr["max_len"],
                               device=device)
            for n, p, c in zip(self.names, self.params, self.cfgs)]
        self.thresholds: List[float] = []

    def token_engine(self, thresholds: List[float]):
        port, tr = self.port, self.cell.traffic
        gear = port["Gear"](
            cascade=port["Cascade"](tuple(self.names), tuple(thresholds)),
            min_queue_lens={n: 1 for n in self.names},
            load_fractions={n: {0: 1.0} for n in self.names})
        return port["TokenEngine"](
            self.engines, gear, min_tokens=tr["min_tokens"],
            early_margin=tr["early_margin"], stream_mode=tr["stream_mode"],
            beta=tr["beta"], mode="fused", spec_k=tr["spec_k"])

    def warm(self, seed: int) -> None:
        """Run every shape the traffic can reach once (see the module
        docstring): the largest model first and, within a stage, the
        largest bucket first, so that each engine's graph pool is carved
        from its largest capture."""
        tr = self.cell.traffic
        lens = traffic_lib.lengths(tr["prompt"], tr["burst"])
        r = traffic_lib.rng(seed, 2)
        order = sorted(range(len(self.engines)),
                       key=lambda i: -weights.param_bytes(self.models[i]))
        for i in order:
            eng, m = self.engines[i], self.models[i]

            def prompts(n, length):
                length = min(int(length), eng.max_len - 1)
                return [r.integers(0, m["vocab_size"], length)
                        .astype(np.int32) for _ in range(n)]
            if self.port["model_lib"].bucketed_prefill_supported(eng.cfg):
                shapes = sorted(reachable_buckets(
                    eng.len_buckets, eng.batch_buckets, lens, eng.n_slots),
                    key=lambda s: -s[0] * s[1])
            else:
                shapes = [(1, int(lens.max())), (1, int(lens.min()))]
            for n, length in shapes:
                for s in eng.prefill_batch(prompts(n, length))[0]:
                    eng.release(s)
            slots = eng.prefill_batch(prompts(1, lens.min()))[0]
            for k in range(1, tr["spec_k"] + 1):
                eng.decode_fused(k, mode=tr["stream_mode"], beta=tr["beta"])
            for s in slots:
                eng.release(s)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def calibrate(self, seed: int) -> None:
        """Set stage a's threshold for each of the window's first bursts
        (module docstring)."""
        tr = self.cell.traffic
        gen = traffic_lib.bursts(tr, seed, self.models[0]["vocab_size"])
        bursts = [next(gen) for _ in range(tr["calibrated_bursts"])]
        reqs = [[self.port["TokenRequest"](i * len(b) + j, p, m)
                 for j, (p, m) in enumerate(b)] for i, b in enumerate(bursts)]
        res = self.token_engine([0.0]).serve([r for b in reqs for r in b])
        self.thresholds = [
            threshold_for([(res[r.rid].stage_gaps[0], r.max_new) for r in b],
                          tr["escalate_share"], tr) for b in reqs]

    def threshold(self, burst: int) -> float:
        """Stage a's threshold for the window's burst ``burst``."""
        if burst < len(self.thresholds):
            return self.thresholds[burst]
        return float(np.median(self.thresholds))

    def free(self) -> None:
        """Drop the port's state (engines, caches, graphs); the weights,
        the benchmark's own, stay."""
        self.engines = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def serve_window(system: System, seed: int, seconds: float,
                 recorder: Recorder) -> None:
    """Bursts, each submitted when the one before it is served, as long as
    ``seconds`` have not passed since the first."""
    tr = system.cell.traffic
    gen = traffic_lib.bursts(tr, seed, system.models[0]["vocab_size"])
    req_cls = system.port["TokenRequest"]
    rid = 0
    t0 = time.perf_counter()
    if recorder.slicer is not None:
        recorder.slicer.start_window(t0)
    while rid == 0 or time.perf_counter() - t0 < seconds:
        threshold = system.threshold(len(recorder.bursts))
        te = system.token_engine([threshold])
        reqs = [req_cls(rid + i, p, m) for i, (p, m) in enumerate(next(gen))]
        rid += len(reqs)
        recorder.begin_burst(reqs)
        ts = time.perf_counter()
        res = te.serve(reqs)
        te_end = time.perf_counter()
        recorder.end_burst(Burst(ts, te_end, reqs, res, te.spec_discarded,
                                 thresholds=[threshold]))


def correctness(system: System, rec: Record, seed: int,
                control: bool = False) -> Dict[str, float]:
    """Every number ``check`` compares (the port's state must be freed
    before, where memory is short: see ``run``)."""
    tr = system.cell.traffic
    out = {"unfinished": check.unfinished(rec.bursts),
           "stream_mismatch": check.stream_mismatch(
               rec.bursts, rec.recorder.streams),
           "decision_mismatch": check.decision_mismatch(rec.bursts, tr)}
    picked = check.sample(rec.bursts, traffic_lib.rng(seed, 3),
                          tr["check"]["sample"])
    refs = [bench.reference(s["reference"], system.cell.root)
            for s in system.cell.config["stages"]]
    with torch.no_grad():
        out.update(check.readings(picked, rec.recorder.streams,
                                  system.models, system.params, refs,
                                  system.device, control=control))
    return out


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Tuple[dict, dict]:
    """One run (see the module docstring). Returns (the result line, what
    else the run saw, for its log)."""
    build_s = 0.0
    if device.type == "cuda":
        _port()
        from repro_torch.kernels import build
        tb = time.perf_counter()
        build.build_all()
        build_s = time.perf_counter() - tb
    system = System(cell, seed, device)
    system.warm(seed)
    system.calibrate(seed)
    slicer = None
    if trace:
        Slicer.prime()
        slicer = Slicer(seconds)
    recorder = Recorder(system.engines, slicer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    serve_window(system, seed, seconds, recorder)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rec = Record(system.models, system.names, cell.traffic, recorder,
                 setup_s, build_s,
                 trace=slicer.finish() if slicer is not None else None)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        value = bench.reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    requests = list(rec.requests())
    recorder.detach()
    system.free()
    numbers = correctness(system, rec, seed)
    limits = cell.traffic["check"]["limits"]
    ok, shown = check.verdict(numbers, limits)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok), "attempted": len(requests),
            "failed": numbers["unfinished"], "metrics": metrics,
            "device": device_info}
    if trace:
        t = rec.trace
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        line["breakdown"] = t.breakdown()
    info = {"build_s": build_s, "bursts": len(rec.bursts),
            "window_s": rec.window_s,
            "escalated": sum(1 for _, _, res in requests if res.hops > 0),
            "thresholds": [b.thresholds[0] for b in rec.bursts],
            "sample_positions": numbers["positions"],
            "trace_overhead_s": slicer.overhead_s if slicer else 0.0}
    line["checks"] = shown
    return line, info
