"""Serving driver: profile, plan a gear plan offline, then serve online
(port of ``repro/launch/serve.py``; the paper's Fig. 3 lifecycle).

``python -m repro_torch.launch.serve --workload tiny --real``

* ``--workload tiny`` — the trained tiny-classifier family behind the
  port's ``EngineBackend`` on the card (trained there when ``--artifact``
  does not exist yet, then saved to it); profiles are measured through the
  same backend via ``profile_backend`` and the gear planner (Algorithm 1)
  plans over them.
* default — the arrival trace is served on the discrete-event simulator
  over those measured profiles.
* ``--real`` — the threaded producer/consumer ``CascadeServer`` serves the
  trace on the wall clock; every batch's certainties and predictions come
  from one top2gap kernel launch. The simulator's p95 for the same plan and
  trace is printed beside the served one: the plan's logical devices share
  one card here, which the simulator does not model.
* ``--stress-replay`` — the threaded wall-clock runtime over a
  ``ReplayBackend`` (no model compute).

``--device`` (default ``cuda``) selects where the models train and run;
the CPU only when asked. ``--mem-per-device`` defaults to the device's
memory divided among ``--devices``. Not ported yet, and refused with the
ROADMAP.md queue 1 item that brings them: ``--workload qwen`` (item 10,
``CostModelBackend`` on H100 constants), ``--tenants`` (item 12,
multi-tenant serving) and ``--metrics-out`` (item 13, telemetry).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.execution import EngineBackend, ReplayBackend
from repro_torch.core.gears import SLO, GearPlan
from repro_torch.core.plan_state import HardwareSpec
from repro_torch.core.planner import optimize_gear_plan
from repro_torch.core.profiles import ProfileSet
from repro_torch.core.scheduling import DecisionTrace
from repro_torch.core.simulator import (ServingSimulator, SimResult,
                                        trace_to_arrivals)
from repro_torch.core.traces import azure_like_trace, diurnal_like_trace

DEFAULT_ARTIFACT = "build/repro_torch_artifacts/tiny_family.npz"


def parse_slo(text: str) -> SLO:
    kind, value = text.split(":")
    if kind == "latency":
        return SLO(kind="latency", latency_p95=float(value))
    return SLO(kind="accuracy", min_accuracy=float(value))


def device_memory(device: torch.device) -> Tuple[str, float]:
    """(name, bytes) of the memory the models live in: the card's, or on
    the CPU the host's."""
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return props.name, float(props.total_memory)
    return "cpu", float(os.sysconf("SC_PAGE_SIZE")
                        * os.sysconf("SC_PHYS_PAGES"))


def tiny_backend(artifact: str, device="cuda") -> EngineBackend:
    """EngineBackend over the trained tiny family on ``device`` (token and
    label pools attached so any driver can execute from sample ids alone;
    profiles measured via the unified entry point in
    ``make_engine_backend``). Trains the family when ``artifact`` is empty
    or missing, and saves it there when a path is given."""
    from repro_torch.serving.tinymodels import (make_engine_backend,
                                                train_tiny_family)
    return make_engine_backend(*train_tiny_family(cache_path=artifact,
                                                  device=device))


def make_trace(kind: str, seconds: int, qps_max: float) -> np.ndarray:
    trace_fn = diurnal_like_trace if kind == "diurnal" else azure_like_trace
    return trace_fn(seconds=seconds, peak_qps=qps_max)


def serve_des(plan: GearPlan, profiles: ProfileSet, trace: np.ndarray
              ) -> SimResult:
    """The trace on the discrete-event simulator over replayed profiles."""
    sim = ServingSimulator(profiles, plan.replicas, plan.num_devices,
                           backend=ReplayBackend(profiles))
    return sim.run_trace(plan, trace)


def serve_real(plan: GearPlan, backend: EngineBackend, trace: np.ndarray,
               seed: int = 7, decision_trace: Optional[DecisionTrace] = None
               ) -> Tuple[object, List, np.ndarray, int]:
    """The trace on the threaded wall-clock ``CascadeServer`` over real
    models: requests from the synthetic task (``seed``), open loop.
    Engines are warmed and the top2gap kernel built and loaded before the
    consumer threads start. Returns (server, completed requests, labels by
    rid, arrivals offered)."""
    from repro_torch.serving.runtime import CascadeServer, Request
    from repro_torch.serving.tinymodels import synthetic_classification_data
    for e in backend.engines.values():
        e.warmup(32)
    if any(e.device.type == "cuda" for e in backend.engines.values()):
        from repro_torch.kernels import top2gap
        top2gap.load()
    n_req = int(trace.sum()) + 8
    toks, labels, _ = synthetic_classification_data(n_req, seed=seed)
    reqs = [Request(rid=i, tokens=toks[i]) for i in range(n_req)]
    server = CascadeServer(plan, backend=backend,
                           decision_trace=decision_trace)
    done = server.run_trace(reqs, trace)
    return server, done, labels, len(trace_to_arrivals(trace))


def summarize(done: Sequence, labels: np.ndarray) -> Dict[str, float]:
    """p50/p95 latency (ms) and accuracy of the completed requests."""
    lats = np.array([r.latency for r in done])
    return {"p50_ms": float(np.quantile(lats, .5) * 1e3),
            "p95_ms": float(np.quantile(lats, .95) * 1e3),
            "accuracy": float(np.mean([int(r.pred == labels[r.rid])
                                       for r in done]))}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="tiny", choices=["tiny", "qwen"])
    ap.add_argument("--slo", default="latency:0.3",
                    help="latency:<p95 s> | accuracy:<min>")
    ap.add_argument("--devices", type=int, default=4,
                    help="logical devices of the plan")
    ap.add_argument("--mem-per-device", type=float, default=0.0,
                    help="bytes (default: the device's memory / --devices)")
    ap.add_argument("--qps-max", type=float, default=0.0)
    ap.add_argument("--n-ranges", type=int, default=8)
    ap.add_argument("--trace", default="diurnal",
                    choices=["diurnal", "azure"])
    ap.add_argument("--trace-seconds", type=int, default=60)
    ap.add_argument("--real", action="store_true",
                    help="tiny workload: threaded runtime, wall clock")
    ap.add_argument("--stress-replay", action="store_true",
                    help="threaded wall-clock runtime over a ReplayBackend "
                         "(no model compute: pure scheduler/queue stress)")
    ap.add_argument("--artifact", default=DEFAULT_ARTIFACT,
                    help="trained family (.npz); trained and saved here "
                         "when missing")
    ap.add_argument("--plan-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--tenants", default="")
    args = ap.parse_args(argv)

    if args.workload == "qwen":
        raise NotImplementedError(
            "--workload qwen needs CostModelBackend on H100 constants and "
            "profiling/cost_model.py (ROADMAP.md queue 1 item 10)")
    if args.tenants:
        raise NotImplementedError(
            "--tenants needs MultiTenantServer, core/tenancy.py and "
            "core/admission.py (ROADMAP.md queue 1 item 12)")
    if args.metrics_out:
        raise NotImplementedError(
            "--metrics-out needs core/telemetry.py (ROADMAP.md queue 1 "
            "item 13)")

    device = resolve_device(args.device)
    backend = tiny_backend(args.artifact, device)
    profiles = backend.profiles
    qps_max = args.qps_max or 2000.0
    for name, p in profiles.items():
        print(f"  {name:14s} acc={p.accuracy:.3f} "
              f"rt(1)={p.runtime(1) * 1e3:.2f}ms "
              f"slice={p.devices_per_replica}")

    mem_name, mem_bytes = device_memory(device)
    mem_per_device = args.mem_per_device or mem_bytes / args.devices
    print(f"memory per logical device: {mem_per_device / 1e9:.2f} GB "
          f"({args.devices} on {mem_name})")
    slo = parse_slo(args.slo)
    hw = HardwareSpec(num_devices=args.devices,
                      mem_per_device=mem_per_device)
    report = optimize_gear_plan(profiles, hw, slo, qps_max=qps_max,
                                n_ranges=args.n_ranges)
    plan = report.plan
    print(f"\ngear plan: {report.submodule_calls} submodule calls, "
          f"{report.errors_resolved} errors resolved, "
          f"{report.wall_seconds:.1f}s")
    for sub, secs in sorted(report.submodule_seconds.items()):
        print(f"  {sub:22s} {secs:7.2f}s")
    for r, g in enumerate(plan.gears):
        print(f"  range {r} (<= {plan.range_width * (r + 1):.0f} qps): "
              f"{' -> '.join(g.cascade.models)} "
              f"acc={g.expected_accuracy:.3f} "
              f"p95={g.expected_p95 * 1e3:.0f}ms")
    if args.plan_out:
        with open(args.plan_out, "w") as f:
            f.write(plan.to_json())
        print(f"plan written to {args.plan_out}")

    trace = make_trace(args.trace, args.trace_seconds, qps_max)
    if args.stress_replay:
        # real threaded machinery, replayed physics: sleeps for the
        # profiled batch runtime instead of running model compute
        from repro_torch.serving.runtime import CascadeServer, Request
        replay = ReplayBackend(profiles, sleep=True)
        n_req = int(trace.sum()) + 8
        reqs = [Request(rid=i, tokens=np.zeros(1, np.int32))
                for i in range(n_req)]
        server = CascadeServer(plan, backend=replay)
        done = server.run_trace(reqs, trace)
        lats = np.array([r.latency for r in done])
        print(f"\nREPLAY stress (wall clock): {len(done)}/{n_req} done "
              f"p50={np.quantile(lats, .5) * 1e3:.1f}ms "
              f"p95={np.quantile(lats, .95) * 1e3:.1f}ms "
              f"switches={len(server.gear_switches)}")
        return
    res = serve_des(plan, profiles, trace)
    des = (f"{res.completed}/{res.offered} done p95={res.p95 * 1e3:.0f}ms "
           f"acc={res.accuracy:.4f} util={res.utilization:.2f} "
           f"switches={len(res.gear_switches)}")
    if args.real:
        server, done, labels, offered = serve_real(plan, backend, trace)
        s = summarize(done, labels)
        print(f"\nREAL runtime ({device}): {len(done)}/{offered} done "
              f"p50={s['p50_ms']:.1f}ms p95={s['p95_ms']:.1f}ms "
              f"acc={s['accuracy']:.4f} "
              f"switches={len(server.gear_switches)}")
        print(f"simulated, same plan and trace: {des}")
    else:
        print(f"\nsimulated (replay backend): {des}")


if __name__ == "__main__":
    main()
