"""Serving driver: profile, plan a gear plan offline, then serve online
(port of ``repro/launch/serve.py``; the paper's Fig. 3 lifecycle).

``python -m repro_torch.launch.serve --workload tiny --real``

* ``--workload tiny`` — the trained tiny-classifier family behind the
  port's ``EngineBackend`` on the card (trained there when ``--artifact``
  does not exist yet, then saved to it); profiles are measured through the
  same backend via ``profile_backend`` and the gear planner (Algorithm 1)
  plans over them.
* ``--workload qwen`` — the assigned-architecture family (qwen2-0.5b ->
  qwen3-32b) behind a ``CostModelBackend``: latency and memory from the
  analytic roofline on H100 constants (``profiling/hw.py``), certainty
  structure synthesised. Its logical devices are modelled H100s, so
  ``--mem-per-device`` defaults to one card's HBM there.
* default — the arrival trace is served on the discrete-event simulator
  over those profiles.
* ``--real`` (tiny only) — the threaded producer/consumer ``CascadeServer``
  serves the trace on the wall clock; every batch's certainties and
  predictions come from one top2gap kernel launch. The simulator's p95 for
  the same plan and trace is printed beside the served one: the plan's
  logical devices share one card here, which the simulator does not model.
* ``--stress-replay`` — the threaded wall-clock runtime over a
  ``ReplayBackend`` (no model compute).
* ``--tenants name:slokind:value:qps_max[:weight],...`` — multi-tenant
  mode: one joint plan (``plan_multi_tenant``) over the shared devices,
  each tenant's trace superposed, an ``AdmissionController`` in front; on
  the simulator, or under ``--stress-replay`` on the threaded
  ``MultiTenantServer`` over a ``ReplayBackend``. Not with ``--real``, as
  in the reference.
* ``--metrics-out PATH`` — the run's telemetry: metrics JSONL at PATH, a
  Prometheus-style dump at ``PATH.prom`` and the latency attribution at
  ``PATH.attr.json`` (``dump_metrics``), in every mode above. Under
  ``--real`` it records the served run, not the simulator's beside it.

``--device`` (default ``cuda``) selects where the models train and run;
the CPU only when asked. For ``tiny``, ``--mem-per-device`` defaults to
the device's memory divided among ``--devices``.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.execution import (CostModelBackend, EngineBackend,
                                        ReplayBackend, profile_backend)
from repro_torch.core.gears import SLO, GearPlan
from repro_torch.core.plan_state import HardwareSpec
from repro_torch.core.planner import optimize_gear_plan
from repro_torch.core.profiles import ProfileSet
from repro_torch.core.scheduling import DecisionTrace
from repro_torch.core.simulator import (ServingSimulator, SimResult,
                                        trace_to_arrivals)
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.traces import azure_like_trace, diurnal_like_trace
from repro_torch.profiling import hw as hw_consts

DEFAULT_ARTIFACT = "build/repro_torch_artifacts/tiny_family.npz"


def dump_metrics(telem: Telemetry, path: str) -> None:
    """Write the run's telemetry next to ``path``: metrics JSONL at
    ``path``, a Prometheus-style text dump at ``path + '.prom'``, and the
    latency-attribution report at ``path + '.attr.json'``."""
    import json
    telem.finalize()
    with open(path, "w") as f:
        f.write(telem.registry.export_jsonl())
    with open(path + ".prom", "w") as f:
        f.write(telem.registry.prometheus_text())
    with open(path + ".attr.json", "w") as f:
        json.dump(telem.attribution(window_s=10.0), f, sort_keys=True,
                  indent=1)
    cons = telem.conservation()
    print(f"\nmetrics written to {path} (+.prom, +.attr.json): "
          f"spans opened={cons['opened']} completed={cons['completed']} "
          f"shed={cons['shed']} revoked={cons['revoked']} "
          f"open={cons['open']}")
    attr = telem.attribution()
    if attr["total"]["count"]:
        print(Telemetry.render_attribution(attr))


def parse_slo(text: str) -> SLO:
    kind, value = text.split(":")
    if kind == "latency":
        return SLO(kind="latency", latency_p95=float(value))
    return SLO(kind="accuracy", min_accuracy=float(value))


def parse_tenants(text: str):
    """``name:slokind:value:qps_max[:weight]``, comma-separated — e.g.
    ``interactive:latency:0.3:600:2,batch:latency:1.0:600:1``."""
    from repro_torch.core import TenantSpec
    out = []
    for part in text.split(","):
        fields = part.split(":")
        if len(fields) not in (4, 5):
            raise ValueError(f"bad tenant spec {part!r} (want "
                             f"name:slokind:value:qps_max[:weight])")
        name, kind, value, qps_max = fields[:4]
        weight = float(fields[4]) if len(fields) == 5 else 1.0
        out.append(TenantSpec(name, parse_slo(f"{kind}:{value}"),
                              qps_max=float(qps_max), weight=weight,
                              n_ranges=4))
    return out


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


def qwen_backend() -> CostModelBackend:
    """CostModelBackend for the assigned big architectures: accuracy/
    certainty structure synthesised, latency/memory analytic (H100)."""
    from repro_torch.core.profiles import synthetic_family
    names = ["qwen2-0.5b", "internvl2-1b", "qwen2-moe-a2.7b", "qwen3-32b"]
    synth = synthetic_family(names, base_acc=0.55, acc_gain=0.05, seed=11)
    return CostModelBackend(
        {n: n for n in names}, context=2048, kind="decode",
        validation={n: synth[n].validation for n in names})


def qwen_profiles() -> ProfileSet:
    return profile_backend(qwen_backend())


def make_trace(kind: str, seconds: int, qps_max: float) -> np.ndarray:
    trace_fn = diurnal_like_trace if kind == "diurnal" else azure_like_trace
    return trace_fn(seconds=seconds, peak_qps=qps_max)


def serve_des(plan: GearPlan, profiles: ProfileSet, trace: np.ndarray,
              telemetry: Optional[Telemetry] = None) -> SimResult:
    """The trace on the discrete-event simulator over replayed profiles."""
    sim = ServingSimulator(profiles, plan.replicas, plan.num_devices,
                           backend=ReplayBackend(profiles),
                           telemetry=telemetry)
    return sim.run_trace(plan, trace)


def prepare_engines(backend: EngineBackend) -> None:
    """Warm every engine (on the card: capture its bucket graphs) and
    build and load the top2gap kernel, so that no served batch pays for
    either."""
    for e in backend.engines.values():
        e.warmup(32)
    if any(e.device.type == "cuda" for e in backend.engines.values()):
        from repro_torch.kernels import top2gap
        top2gap.load()


def serve_real(plan: GearPlan, backend: EngineBackend, trace: np.ndarray,
               seed: int = 7, decision_trace: Optional[DecisionTrace] = None,
               selector=None, telemetry: Optional[Telemetry] = None
               ) -> Tuple[object, List, np.ndarray, int]:
    """The trace on the threaded wall-clock ``CascadeServer`` over real
    models: requests from the synthetic task (``seed``), open loop, under
    the plan's own policy or ``selector`` (a baseline's, from
    ``serving/baselines.py`` ``build_plan``). Engines are prepared before
    the consumer threads start. Returns (server, completed requests,
    labels by rid, arrivals offered)."""
    from repro_torch.serving.runtime import CascadeServer, Request
    from repro_torch.serving.tinymodels import synthetic_classification_data
    prepare_engines(backend)
    n_req = int(trace.sum()) + 8
    toks, labels, _ = synthetic_classification_data(n_req, seed=seed)
    reqs = [Request(rid=i, tokens=toks[i]) for i in range(n_req)]
    server = CascadeServer(plan, backend=backend, selector=selector,
                           decision_trace=decision_trace,
                           telemetry=telemetry)
    done = server.run_trace(reqs, trace)
    return server, done, labels, len(trace_to_arrivals(trace))


def serve_multitenant(args, profiles: ProfileSet, hw: HardwareSpec,
                      telem: Optional[Telemetry] = None) -> None:
    """Multi-tenant mode (DESIGN.md §11): joint plan, per-tenant ladders,
    superposed traces with admission control — on the DES by default, on
    the threaded ``MultiTenantServer`` under ``--stress-replay``."""
    from repro_torch.core.admission import (AdmissionConfig,
                                            AdmissionController)
    from repro_torch.core.tenancy import plan_multi_tenant
    tenants = parse_tenants(args.tenants)
    report = plan_multi_tenant(profiles, hw, tenants)
    mt = report.plan
    print(f"\nmulti-tenant plan over {hw.num_devices} shared devices "
          f"({report.wall_seconds:.1f}s):")
    for spec in tenants:
        plan = mt.plans[spec.name]
        print(f"  {spec.name}: qps_max={spec.qps_max:.0f} w={spec.weight} "
              f"top gear {' -> '.join(plan.gears[-1].cascade.models)}")
    traces = {spec.name: make_trace(args.trace, args.trace_seconds,
                                    spec.qps_max)
              for spec in tenants}
    admission = AdmissionController(
        mt, AdmissionConfig(utilization_cap=0.75),
        registry=telem.registry if telem is not None else None)
    if args.stress_replay:
        from repro_torch.serving.runtime import MultiTenantServer, Request
        replay = ReplayBackend(profiles, sleep=True)
        reqs = {n: [Request(rid=i, tokens=np.zeros(1, np.int32), tenant=n)
                    for i in range(int(traces[n].sum()) + 8)]
                for n in mt.names}
        server = MultiTenantServer(mt, backend=replay, admission=admission,
                                   telemetry=telem)
        done = server.run_trace(reqs, traces)
        print("\nREPLAY stress (wall clock, shared fleet):")
        for n in mt.names:
            lats = np.array([r.latency for r in done[n]]) \
                if done[n] else np.zeros(0)
            p95 = np.quantile(lats, .95) * 1e3 if len(lats) else float("nan")
            print(f"  {n}: {len(done[n])} done shed={server.shed_counts[n]} "
                  f"p95={p95:.1f}ms "
                  f"switches={len(server.gear_switches[n])}")
    else:
        sim = ServingSimulator(profiles, mt.replicas, hw.num_devices,
                               backend=ReplayBackend(profiles),
                               telemetry=telem)
        results = sim.run_multi_tenant(mt, traces, admission=admission)
        print("\nsimulated (shared fleet):")
        for spec in tenants:
            r = results[spec.name]
            print(f"  {spec.name}: {r.result.completed}/{r.offered} done "
                  f"shed={r.shed} ({100 * r.shed_rate:.1f}%) "
                  f"p95={r.p95 * 1e3:.0f}ms acc={r.accuracy:.4f} "
                  f"switches={len(r.result.gear_switches)}")
    if telem is not None:
        dump_metrics(telem, args.metrics_out)


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
                    help="bytes (default: tiny, the device's memory / "
                         "--devices; qwen, one modelled H100's HBM)")
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
    ap.add_argument("--metrics-out", default="",
                    help="write metrics JSONL here (plus .prom Prometheus "
                         "dump and .attr.json latency attribution)")
    ap.add_argument("--tenants", default="",
                    help="multi-tenant mode (DESIGN.md §11): comma-"
                         "separated name:slokind:value:qps_max[:weight]")
    args = ap.parse_args(argv)

    if args.real and args.workload != "tiny":
        ap.error("--real serves the tiny workload only")
    if args.real and args.tenants:
        ap.error("--tenants serves on the simulator or under "
                 "--stress-replay, not with --real")

    device = resolve_device(args.device)
    if args.workload == "tiny":
        backend = tiny_backend(args.artifact, device)
        qps_max = args.qps_max or 2000.0
        mem_name, mem_bytes = device_memory(device)
        mem_per_device = args.mem_per_device or mem_bytes / args.devices
        where = f"{args.devices} on {mem_name}"
    else:
        backend = qwen_backend()
        qps_max = args.qps_max or 60.0
        # the plan's devices are modelled H100s, not slices of this one
        mem_per_device = args.mem_per_device or hw_consts.HBM_BYTES
        where = f"{args.devices} modelled H100s"
    profiles = backend.profiles
    for name, p in profiles.items():
        print(f"  {name:14s} acc={p.accuracy:.3f} "
              f"rt(1)={p.runtime(1) * 1e3:.2f}ms "
              f"slice={p.devices_per_replica}")
    print(f"memory per logical device: {mem_per_device / 1e9:.2f} GB "
          f"({where})")
    slo = parse_slo(args.slo)
    hw = HardwareSpec(num_devices=args.devices,
                      mem_per_device=mem_per_device)
    telem = Telemetry() if args.metrics_out else None
    if args.tenants:
        serve_multitenant(args, profiles, hw, telem=telem)
        return
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
        server = CascadeServer(plan, backend=replay, telemetry=telem)
        done = server.run_trace(reqs, trace)
        lats = np.array([r.latency for r in done])
        print(f"\nREPLAY stress (wall clock): {len(done)}/{n_req} done "
              f"p50={np.quantile(lats, .5) * 1e3:.1f}ms "
              f"p95={np.quantile(lats, .95) * 1e3:.1f}ms "
              f"switches={len(server.gear_switches)}")
    else:
        # under --real the telemetry records the served run only
        res = serve_des(plan, profiles, trace,
                        telemetry=None if args.real else telem)
        des = (f"{res.completed}/{res.offered} done "
               f"p95={res.p95 * 1e3:.0f}ms acc={res.accuracy:.4f} "
               f"util={res.utilization:.2f} "
               f"switches={len(res.gear_switches)}")
        if args.real:
            server, done, labels, offered = serve_real(plan, backend, trace,
                                                       telemetry=telem)
            s = summarize(done, labels)
            print(f"\nREAL runtime ({device}): {len(done)}/{offered} done "
                  f"p50={s['p50_ms']:.1f}ms p95={s['p95_ms']:.1f}ms "
                  f"acc={s['accuracy']:.4f} "
                  f"switches={len(server.gear_switches)}")
            print(f"simulated, same plan and trace: {des}")
        else:
            print(f"\nsimulated (replay backend): {des}")
    if telem is not None:
        dump_metrics(telem, args.metrics_out)


if __name__ == "__main__":
    main()
