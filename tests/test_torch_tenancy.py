"""The port's multi-tenant server and serve CLI against the JAX package,
on the CPU.

* ``MultiTenantServer.run_virtual`` over the numpy replay engines of
  ``tests/test_tenancy.py``, with an ``AdmissionController``: the same
  joint plan, and per tenant the same routes, gear switches and hops, the
  same fleet-level batch firings, completions and sheds as the reference's
  ``ServingSimulator.run_multi_tenant`` and as the reference's own
  ``MultiTenantServer.run_virtual`` (exact: both replay the same recorded
  certainties).
* ``MultiTenantServer.run_virtual`` over torch tiny engines against the
  reference's over JAX tiny engines with the same JAX-trained weights,
  two tenants sharing one two-stage cascade: decisions equal, each hop's
  certainty within 1e-5. Guarded as the other decision-parity tests are:
  the stage-0 threshold sits across the widest gap of the requests'
  reference certainties, and the test asserts none lies within 1e-4 of it.
* ``python -m repro_torch.launch.serve --device cpu`` with ``--tenants``
  (the simulator and ``--stress-replay``) and with ``--metrics-out`` (the
  simulator and ``--real``): the three metrics files are written, every
  span opened is closed (completed, shed or revoked, none open). The CLI
  runs in a process of its own, as in ``tests/test_torch_runtime.py``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdmissionController as JAdmissionController
from repro.core.cascade import Cascade as JCascade
from repro.core.gears import SLO as JSLO
from repro.core.gears import GearPlan as JGearPlan
from repro.core.lp import Replica as JReplica
from repro.core.profiles import synthetic_family as j_synthetic_family
from repro.core.scheduling import DecisionTrace as JDecisionTrace
from repro.core.scheduling import RoutePool as JRoutePool
from repro.core.simulator import ServingSimulator as JServingSimulator
from repro.core.simulator import SimConfig as JSimConfig
from repro.core.simulator import make_gear as j_make_gear
from repro.core import tenancy as JTN
from repro.core.plan_state import HardwareSpec as JHardwareSpec
from repro.serving import tinymodels as JT
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro.serving.runtime import MultiTenantServer as JMultiTenantServer
from repro.serving.runtime import Request as JRequest
from repro_torch.convert import tiny_params_from_numpy
from repro_torch.core.admission import \
    AdmissionController as TAdmissionController
from repro_torch.core.cascade import Cascade as TCascade
from repro_torch.core.gears import SLO as TSLO
from repro_torch.core.gears import GearPlan as TGearPlan
from repro_torch.core.lp import Replica as TReplica
from repro_torch.core.plan_state import HardwareSpec as THardwareSpec
from repro_torch.core.profiles import synthetic_family as t_synthetic_family
from repro_torch.core.scheduling import DecisionTrace as TDecisionTrace
from repro_torch.core.scheduling import RoutePool as TRoutePool
from repro_torch.core.simulator import make_gear as t_make_gear
from repro_torch.core.simulator import trace_to_arrivals
from repro_torch.core import tenancy as TTN
from repro_torch.serving import tinymodels as TT
from repro_torch.serving.engine import InferenceEngine as TInferenceEngine
from repro_torch.serving.runtime import MultiTenantServer as \
    TMultiTenantServer
from repro_torch.serving.runtime import Request as TRequest

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CERT_TOL = 1e-5
NEAR = 1e-4


def _family(synthetic_family):
    # the arguments of tests/test_tenancy.py's ``small_family``
    return synthetic_family(["tiny", "small", "base"], base_runtime=2e-4,
                            runtime_ratio=2.4, base_acc=0.70,
                            acc_gain=0.06, mem_base=0.4e9, seed=3)


def _mt_report(TN, synthetic_family, HardwareSpec, SLO):
    # tests/test_tenancy.py's ``two_tenants`` over ``mt_report``'s fleet
    fam = _family(synthetic_family)
    tenants = [
        TN.TenantSpec("interactive", SLO(kind="latency", latency_p95=0.5),
                      qps_max=400.0, weight=2.0, n_ranges=2),
        TN.TenantSpec("analytics", SLO(kind="latency", latency_p95=1.0),
                      qps_max=200.0, weight=1.0, n_ranges=2)]
    hw = HardwareSpec(num_devices=2, mem_per_device=16e9)
    return fam, TN.plan_multi_tenant(fam, hw, tenants).plan, hw


class _ReplayEngine:
    """``tests/test_tenancy.py``'s engine: the request's recorded
    certainty in scores[:, 0] (tokens[0] indexes the validation set)."""

    def __init__(self, certs):
        self.certs = np.asarray(certs, np.float64)

    def infer(self, tokens):
        vi = np.asarray(tokens)[:, 0] % len(self.certs)
        out = np.zeros((len(vi), 2))
        out[:, 0] = self.certs[vi]
        return out


def _cert_estimator(scores):
    return scores[:, 0]


def _requests(Request, names, traces, TN):
    times, tidx, lidx = TN.merge_tenant_arrivals(traces, names)
    reqs = {n: [None] * int((tidx == i).sum()) for i, n in enumerate(names)}
    for g in range(len(times)):
        n = names[int(tidx[g])]
        reqs[n][int(lidx[g])] = Request(
            rid=g, tokens=np.array([int(lidx[g])], np.int64))
    return reqs


def _serve_virtual(Server, Request, RoutePool, DecisionTrace, Admission, TN,
                   mt, profiles, traces):
    reqs = _requests(Request, mt.names, traces, TN)
    pools = {n: RoutePool.for_arrivals(0, len(reqs[n]), key=n)
             for n in mt.names}
    tr = {n: DecisionTrace() for n in mt.names}
    fleet = DecisionTrace()
    engines = {m: _ReplayEngine(profiles[m].validation.certs)
               for m in profiles}
    srv = Server(mt, engines, estimator=_cert_estimator, max_batch=128,
                 admission=Admission(mt), decision_traces=tr,
                 fleet_trace=fleet, route_pools=pools)
    done = srv.run_virtual(reqs, traces,
                           batch_runtime=lambda m, b: profiles[m].runtime(b))
    return srv, done, tr, fleet


# a flash crowd on the interactive tenant, steady analytics traffic: both
# tenants switch gears and admission engages (tests/test_tenancy.py's mix)
TRACES = {
    "base": {"interactive": np.concatenate([np.full(3, 100.0),
                                            np.full(3, 900.0),
                                            np.full(3, 100.0)]),
             "analytics": np.full(9, 150.0)},
    # past the fleet's capacity (about 8,000 qps at the cheapest gears):
    # admission sheds
    "overload": {"interactive": np.concatenate([np.full(2, 200.0),
                                                np.full(2, 12000.0),
                                                np.full(2, 200.0)]),
                 "analytics": np.concatenate([np.full(3, 150.0),
                                              np.full(3, 600.0)])},
}


@pytest.mark.parametrize("reference", ["simulator", "runtime"])
@pytest.mark.parametrize("mix", sorted(TRACES))
def test_multitenant_server_decides_as_reference(reference, mix):
    traces = TRACES[mix]
    jfam, jmt, jhw = _mt_report(JTN, j_synthetic_family, JHardwareSpec,
                                JSLO)
    tfam, tmt, thw = _mt_report(TTN, t_synthetic_family, THardwareSpec,
                                TSLO)
    assert tmt.to_json() == jmt.to_json()
    if reference == "simulator":
        jtr = {n: JDecisionTrace() for n in jmt.names}
        jfleet = JDecisionTrace()
        out = JServingSimulator(
            jfam, jmt.replicas, jhw.num_devices,
            JSimConfig(max_batch=128)).run_multi_tenant(
                jmt, traces, admission=JAdmissionController(jmt),
                decision_traces=jtr, fleet_trace=jfleet)
        jdone = {n: out[n].result.completed for n in jmt.names}
        jshed = {n: out[n].shed for n in jmt.names}
        jswitch = None
    else:
        jsrv, jd, jtr, jfleet = _serve_virtual(
            JMultiTenantServer, JRequest, JRoutePool, JDecisionTrace,
            JAdmissionController, JTN, jmt, jfam, traces)
        jdone = {n: len(v) for n, v in jd.items()}
        jshed = dict(jsrv.shed_counts)
        jswitch = jsrv.gear_switches
    tsrv, tdone, ttr, tfleet = _serve_virtual(
        TMultiTenantServer, TRequest, TRoutePool, TDecisionTrace,
        TAdmissionController, TTN, tmt, tfam, traces)

    # the scenario exercises every decision type
    assert len(jtr["interactive"].gear_switches) >= 2
    assert len(jfleet.fires) > 10
    assert any(h[2] != "resolve" for h in jtr["interactive"].hops)
    if mix == "overload":
        assert jshed["interactive"] > 0
    for n in jmt.names:
        assert ttr[n].routes == jtr[n].routes
        assert ttr[n].gear_switches == jtr[n].gear_switches
        assert ttr[n].hops == jtr[n].hops
        assert len(tdone[n]) == jdone[n]
        assert tsrv.shed_counts[n] == jshed[n]
        assert tsrv.offered_counts[n] == len(trace_to_arrivals(traces[n]))
    assert tfleet.fires == jfleet.fires
    if jswitch is not None:
        assert tsrv.gear_switches == jswitch


# ---------------------------------------------------------------------------
# torch tiny engines against JAX tiny engines
# ---------------------------------------------------------------------------

FAM = (JT.TINY_FAMILY[0], JT.TINY_FAMILY[2])
MODELS = tuple(cfg.name for cfg in FAM)


def _tiny_mt(pkg, thr):
    """Two tenants over one placement (each model on both devices): the
    same two-stage cascade, with different batch triggers and ranges."""
    if pkg == "jax":
        SLO, Replica, GearPlan, Cascade, make_gear, TN = (
            JSLO, JReplica, JGearPlan, JCascade, j_make_gear, JTN)
    else:
        SLO, Replica, GearPlan, Cascade, make_gear, TN = (
            TSLO, TReplica, TGearPlan, TCascade, t_make_gear, TTN)
    reps = [Replica(m, d, 1e-3 * (1 + 2 * i))
            for d in range(2) for i, m in enumerate(MODELS)]

    def plan(qps_max, trig):
        g0 = make_gear(Cascade(MODELS, (thr,)), reps, {MODELS[0]: trig})
        g1 = make_gear(Cascade(MODELS[:1], ()), reps, {MODELS[0]: 4})
        return GearPlan(qps_max=qps_max, gears=[g0, g1], replicas=reps,
                        num_devices=2,
                        slo=SLO(kind="latency", latency_p95=1.0))

    slo = SLO(kind="latency", latency_p95=1.0)
    specs = [TN.TenantSpec("interactive", slo, 400.0, weight=2.0,
                           n_ranges=2),
             TN.TenantSpec("batch", slo, 200.0, weight=1.0, n_ranges=2)]
    return TN.MultiTenantPlan(
        tenants=specs, plans={"interactive": plan(400.0, 2),
                              "batch": plan(200.0, 8)})


def _tiny_runtime(model, b):
    return (2e-3 if model == MODELS[0] else 6e-3) * (1.0 + 0.05 * (b - 1))


@pytest.fixture(scope="module")
def trained():
    return JT.train_tiny_family(n_train=768, n_val=256, steps_scale=0.15,
                                family=FAM)


def test_multitenant_server_on_tiny_engines_decides_as_jax(trained):
    params_by = trained[0]
    traces = {"interactive": np.concatenate([np.full(3, 40.0),
                                             np.full(3, 300.0),
                                             np.full(3, 40.0)]),
              "batch": np.full(9, 60.0)}
    names = ["interactive", "batch"]
    times, tidx, lidx = JTN.merge_tenant_arrivals(traces, names)
    n_arr = len(times)
    toks, _, _ = JT.synthetic_classification_data(n_arr, seed=7)
    top2 = np.asarray(jax.lax.top_k(JT.apply_tiny(
        FAM[0], params_by[MODELS[0]], jnp.asarray(toks)), 2)[0])
    ref_certs = top2[:, 0] - top2[:, 1]
    # calibration: the stage-0 threshold mid-way across the widest gap of
    # the requests' reference certainties in their middle half
    s = np.sort(ref_certs)[n_arr // 4:3 * n_arr // 4]
    k = int(np.argmax(np.diff(s)))
    thr = float(0.5 * (s[k] + s[k + 1]))
    near = np.flatnonzero(np.abs(ref_certs - thr) <= NEAR)
    assert near.size == 0, (
        f"requests {near.tolist()} have a stage-0 certainty within {NEAR} "
        f"of the threshold {thr}: the comparison cannot be exact")

    jeng = {cfg.name: JInferenceEngine(
        cfg.name, lambda p, t, c=cfg: JT.apply_tiny(c, p, t),
        params_by[cfg.name]) for cfg in FAM}
    teng = {cfg.name: TInferenceEngine(
        cfg.name, lambda p, t, c=cfg: TT.apply_tiny(c, p, t),
        tiny_params_from_numpy(jax.tree.map(np.asarray, params_by[cfg.name]),
                               device="cpu")) for cfg in FAM}
    out = {}
    for pkg, Server, Request, RoutePool, DecisionTrace, Admission, eng in (
            ("jax", JMultiTenantServer, JRequest, JRoutePool,
             JDecisionTrace, JAdmissionController, jeng),
            ("torch", TMultiTenantServer, TRequest, TRoutePool,
             TDecisionTrace, TAdmissionController, teng)):
        mt = _tiny_mt(pkg, thr)
        # request g of the merged stream carries token row g
        reqs = {n: [None] * int((tidx == i).sum())
                for i, n in enumerate(names)}
        for g in range(n_arr):
            n = names[int(tidx[g])]
            reqs[n][int(lidx[g])] = Request(rid=g, tokens=toks[g])
        tr = {n: DecisionTrace() for n in names}
        fleet = DecisionTrace()
        srv = Server(mt, eng, admission=Admission(mt), decision_traces=tr,
                     fleet_trace=fleet,
                     route_pools={n: RoutePool.for_arrivals(
                         0, len(reqs[n]), key=n) for n in names})
        done = srv.run_virtual(reqs, traces, batch_runtime=_tiny_runtime)
        out[pkg] = (srv, done, tr, fleet)
    jsrv, jdone, jtr, jfleet = out["jax"]
    tsrv, tdone, ttr, tfleet = out["torch"]

    assert len(jfleet.fires) > 10
    assert len(jtr["interactive"].gear_switches) >= 2
    assert any(h[2] != "resolve" for h in jtr["interactive"].hops)
    assert any(h[2] == "resolve" for h in jtr["batch"].hops)
    assert tfleet.fires == jfleet.fires
    for n in names:
        assert ttr[n].routes == jtr[n].routes
        assert ttr[n].gear_switches == jtr[n].gear_switches
        assert [(s, o) for s, _, o in ttr[n].hops] == \
            [(s, o) for s, _, o in jtr[n].hops]
        np.testing.assert_allclose([c for _, c, _ in ttr[n].hops],
                                   [c for _, c, _ in jtr[n].hops],
                                   atol=CERT_TOL, rtol=0)
        jby = {r.rid: r for r in jdone[n]}
        assert len(tdone[n]) == len(jdone[n]) > 0
        for r in tdone[n]:
            j = jby[r.rid]
            assert (r.resolver, r.t_done, r.gear_idx) == \
                (j.resolver, j.t_done, j.gear_idx)
            if abs(j.cert) > NEAR:
                assert r.pred == j.pred
    assert tsrv.shed_counts == jsrv.shed_counts


# ---------------------------------------------------------------------------
# the serve CLI: --tenants and --metrics-out
# ---------------------------------------------------------------------------

TENANTS = "interactive:latency:0.3:600:2,batch:latency:1.0:600:1"


def _cli(args, timeout=300, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _metrics(path):
    """The three files ``dump_metrics`` writes, parsed, and the span
    counts it printed."""
    with open(path) as f:
        jsonl = [json.loads(ln) for ln in f if ln.strip()]
    with open(path + ".prom") as f:
        prom = f.read()
    with open(path + ".attr.json") as f:
        attr = json.load(f)
    return jsonl, prom, attr


def _spans(stdout):
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("metrics written to")]
    assert len(line) == 1, stdout[-2000:]
    return {k: int(v) for k, v in
            (kv.split("=") for kv in line[0].split(": spans ")[1].split())}


def _conserved(spans):
    assert spans["open"] == 0
    assert spans["opened"] == (spans["completed"] + spans["shed"]
                               + spans["revoked"])


def _tenant_lines(stdout, header):
    lines = stdout.splitlines()
    i = lines.index(header)
    return lines[i + 1:i + 3]


def test_cli_tenants_des_writes_metrics(tmp_path):
    path = str(tmp_path / "m.jsonl")
    out = _cli(["-m", "repro_torch.launch.serve", "--workload", "qwen",
                "--device", "cpu", "--trace-seconds", "10", "--tenants",
                TENANTS, "--metrics-out", path])
    tl = _tenant_lines(out, "simulated (shared fleet):")
    assert [ln.split()[0] for ln in tl] == ["interactive:", "batch:"]
    for ln in tl:
        done, offered = map(int, ln.split()[1].split("/"))
        shed = int(ln.split()[3].split("=")[1])
        assert offered > 0 and done + shed <= offered
    jsonl, prom, attr = _metrics(path)
    # the admission controller's counters go to the registry; the
    # simulator's multi-tenant loop opens no spans (as the reference's)
    admitted = {r["labels"]["tenant"]: r["value"] for r in jsonl
                if r["name"] == "admitted_requests"}
    assert sorted(admitted) == ["batch", "interactive"]
    assert "admitted_requests" in prom and "total" in attr
    _conserved(_spans(out))


def test_cli_tenants_stress_replay_writes_metrics(tmp_path):
    path = str(tmp_path / "m.jsonl")
    out = _cli(["-m", "repro_torch.launch.serve", "--workload", "qwen",
                "--device", "cpu", "--trace-seconds", "3", "--tenants",
                TENANTS, "--stress-replay", "--metrics-out", path])
    tl = _tenant_lines(out, "REPLAY stress (wall clock, shared fleet):")
    assert [ln.split()[0] for ln in tl] == ["interactive:", "batch:"]
    jsonl, prom, attr = _metrics(path)
    spans = _spans(out)
    _conserved(spans)
    assert spans["opened"] > 0
    # every span is one tenant's; the attribution splits them per tenant
    assert sorted(k for k in attr["by_tenant"]) == ["batch", "interactive"]
    assert "admitted_requests" in prom


def _artifact(tmp_path_factory):
    """A whole TINY_FAMILY artifact trained briefly by the port."""
    path = str(tmp_path_factory.mktemp("art") / "tiny.npz")
    TT.train_tiny_family(n_train=256, n_val=128, steps_scale=0.02,
                         cache_path=path, device="cpu")
    return path


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _artifact(tmp_path_factory)


_SMALL = ["--device", "cpu", "--devices", "2", "--qps-max", "60",
          "--n-ranges", "2", "--trace", "azure", "--trace-seconds", "3",
          "--slo", "latency:0.3"]


@pytest.mark.parametrize("mode", ["des", "--real"])
def test_cli_metrics_out_writes_three_files(artifact, tmp_path, mode):
    path = str(tmp_path / "m.jsonl")
    out = _cli(["-m", "repro_torch.launch.serve", *_SMALL, "--artifact",
                artifact, "--metrics-out", path]
               + ([mode] if mode != "des" else []))
    spans = _spans(out)
    _conserved(spans)
    assert spans["completed"] > 0
    jsonl, prom, attr = _metrics(path)
    assert attr["total"]["count"] == spans["completed"]
    names = {r["name"] for r in jsonl}
    assert names and all(n in prom for n in names)
    if mode == "--real":
        # the served run's spans, not the simulator's beside it
        done = [ln for ln in out.splitlines()
                if ln.startswith("REAL runtime (cpu):")]
        assert len(done) == 1
        assert int(done[0].split()[3].split("/")[0]) == spans["completed"]
