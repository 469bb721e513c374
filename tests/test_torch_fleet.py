"""The port's scenarios and elastic fleet against the JAX package's, on the
CPU, on the inputs of ``tests/test_scenarios.py`` and
``tests/test_fleet.py``.

Both packages plan the conftest ``small_plan`` (the BERT-like family on 4
devices) and must give the same plan. Then, exactly:

* every traffic builder renders the same per-second trace, and every
  scenario lowers to the same device and fleet events (and the same
  hard-fail variant);
* ``ServingSimulator.run_trace(scenario=)`` and ``VecSim.run_trace
  (scenario=)`` on the chaos scenario (a flash crowd, a spot preemption, a
  recovery), with the ``PreemptionCoordinator`` on a warned and an
  unwarned revoke, and with a ``HedgePolicy``: the same ``SimResult``,
  every field, and the same ``DecisionTrace``;
* ``CascadeServer.run_virtual(scenario=)`` over replay engines: the same
  decisions, completions and sheds;
* ``rebalance_on_failure``, ``elastic_replan``, the coordinator's memo,
  and the ``FleetController``'s scale, veto, grant/revoke and metering
  sequence: the same plans (JSON) and actions;
* ``run_elastic_fleet`` static, with out-of-range events skipped, and
  elastic under a ramp: the same ``FleetRunResult``, every field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import scenarios as JS
from repro.core.adaption import MonitorConfig as JMonitorConfig
from repro.core.adaption import ReplanTrigger as JReplanTrigger
from repro.core.admission import plan_capacity_qps as j_capacity
from repro.core.planner import build_plan as j_build_plan
from repro.core.scheduling import DecisionTrace as JDecisionTrace
from repro.core.scheduling import RoutePool as JRoutePool
from repro.core.simulator import ServingSimulator as JServingSimulator
from repro.core.simulator import trace_to_arrivals
from repro.core.vecsim import VecSim as JVecSim
from repro.distributed import fault_tolerance as JF
from repro.serving.runtime import CascadeServer as JCascadeServer
from repro.serving.runtime import Request as JRequest
from repro_torch.core import scenarios as TS
from repro_torch.core.adaption import MonitorConfig as TMonitorConfig
from repro_torch.core.adaption import ReplanTrigger as TReplanTrigger
from repro_torch.core.admission import plan_capacity_qps as t_capacity
from repro_torch.core.gears import SLO as TSLO
from repro_torch.core.plan_state import HardwareSpec as THardwareSpec
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.core.planner import optimize_gear_plan as t_optimize
from repro_torch.core.profiles import synthetic_family as t_synthetic_family
from repro_torch.core.scheduling import DecisionTrace as TDecisionTrace
from repro_torch.core.scheduling import RoutePool as TRoutePool
from repro_torch.core.simulator import ServingSimulator as TServingSimulator
from repro_torch.core.vecsim import VecSim as TVecSim
from repro_torch.distributed import fault_tolerance as TF
from repro_torch.serving.runtime import CascadeServer as TCascadeServer
from repro_torch.serving.runtime import Request as TRequest

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def plans(small_plan):
    """(jax profiles, jax report, torch profiles, torch report)."""
    jreport, _ = small_plan
    tprof = t_synthetic_family(
        ["tiny", "mini", "small", "medium", "base"],
        base_runtime=2e-4, runtime_ratio=2.4, base_acc=0.70,
        acc_gain=0.05, mem_base=0.4e9, seed=3)
    treport = t_optimize(tprof, THardwareSpec(num_devices=4,
                                              mem_per_device=16e9),
                         TSLO(kind="latency", latency_p95=0.4),
                         qps_max=7600, n_ranges=8)
    return jreport.state.profiles, jreport, tprof, treport


def test_plans_equal(plans):
    _, jreport, _, treport = plans
    assert treport.plan.to_json() == jreport.plan.to_json()


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _assert_same(t, j, what=""):
    jd = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    td = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert sorted(td) == sorted(jd)
    for field, value in jd.items():
        assert _same(td[field], value), f"{what}: {field}"


# ---------------------------------------------------------------------------
# the scenario DSL
# ---------------------------------------------------------------------------

def _traffic(S):
    return {"constant": S.constant(10, 100.0),
            "ramp": S.ramp(20, 50.0, 500.0),
            "diurnal": S.diurnal_noise(days=2, day_seconds=30),
            "diurnal_noisy": S.diurnal_noise(days=1, day_seconds=50,
                                             noise=0.2, seed=9),
            "spike": S.spike(30, base_qps=100.0, spike_qps=900.0, at=10,
                             length=5),
            "flash": S.flash_crowd(40, base_qps=100.0, peak_qps=800.0,
                                   at=10),
            "sum": S.constant(10, 100.0) + S.constant(10, 50.0),
            "scaled": S.constant(10, 100.0).scaled(2.0)}


def _scenarios(S):
    return {
        "preempt": S.Scenario(traffic=S.constant(60, 100.0), events=(
            S.SpotPreemption(t=10.0, device=2, lead=5.0),
            S.DeviceRecover(t=40.0, device=2))),
        "hard": S.Scenario(traffic=S.constant(30, 100.0), events=(
            S.SpotPreemption(t=10.0, device=1, lead=0.0),)),
        "mixed": S.Scenario(traffic=S.constant(120, 100.0), events=(
            S.NetworkDegradation(t=50.0, until=60.0, factor=2.0),
            S.DeviceSlowdown(t=5.0, device=0, factor=3.0),
            S.DeviceFail(t=20.0, device=1),
            S.SpotPreemption(t=30.0, device=2, lead=10.0))),
        "fleet": S.Scenario(traffic=S.constant(60, 100.0), events=(
            S.CapacityGrant(t=10.0, devices=2),
            S.CapacityRevoke(t=30.0, devices=1))),
    }


def test_traffic_renders_equal():
    jt, tt = _traffic(JS), _traffic(TS)
    for name, j in jt.items():
        a, b = j.render(), tt[name].render()
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_scenario_lowering_equal():
    jsc, tsc = _scenarios(JS), _scenarios(TS)
    for name, j in jsc.items():
        t = tsc[name]
        assert t.device_events() == j.device_events(), name
        assert t.fleet_events() == j.fleet_events(), name
        assert np.array_equal(t.qps(), j.qps()), name
        assert t.hard_fail_variant().device_events() == \
            j.hard_fail_variant().device_events(), name
    with pytest.raises(ValueError):
        TS.Scenario(traffic=TS.constant(10, 100.0), drain=-1.0)


def _chaos(S):
    # tests/test_scenarios.py's ``chaos_scenario``
    return S.Scenario(
        traffic=S.flash_crowd(40, base_qps=300.0, peak_qps=1200.0, at=10),
        events=(S.SpotPreemption(t=12.0, device=3, lead=6.0),
                S.DeviceRecover(t=30.0, device=3)),
        drain=2.0, name="determinism-regression")


def _hedged(S):
    # tests/test_scenarios.py's hedge/preemption scenario
    return S.Scenario(traffic=S.constant(30, 3000.0),
                      events=(S.DeviceSlowdown(t=5.0, device=1, factor=12.0),
                              S.SpotPreemption(t=12.0, device=2, lead=4.0),
                              S.DeviceRecover(t=22.0, device=2)),
                      drain=5.0)


def _warned(S):
    # tests/test_scenarios.py's revoke scenario
    return S.Scenario(traffic=S.constant(30, 6000.0), drain=2.0,
                      events=(S.SpotPreemption(t=15.0, device=3, lead=8.0),))


def _run_scenarios(S, F, Sim, Vec, DecisionTrace, profiles, plan):
    """Every scenario run of the comparison, as (label, result, trace)."""
    out = []
    sim = Sim(profiles, plan.replicas, plan.num_devices)
    vec = Vec(profiles, plan.replicas, plan.num_devices)
    for label, driver in (("sim", sim), ("vec", vec)):
        tr = DecisionTrace()
        out.append((f"chaos-{label}",
                    driver.run_trace(plan, scenario=_chaos(S),
                                     decision_trace=tr), tr))
    coord = F.PreemptionCoordinator(plan, profiles)
    for label, sc in (("warned", _warned(S)),
                      ("hard", _warned(S).hard_fail_variant())):
        coord.reset(plan)
        tr = DecisionTrace()
        out.append((f"revoke-{label}",
                    sim.run_trace(plan, scenario=sc, decision_trace=tr,
                                  on_failure=coord.on_failure), tr))
    out.append(("coordinator", (coord.solves, coord.hits, coord.infeasible),
                None))
    hedge = F.HedgePolicy(hedge_multiplier=2.0, max_hedges_per_batch=1)
    tr = DecisionTrace()
    out.append(("hedged", sim.run_trace(plan, scenario=_hedged(S),
                                        hedge=hedge, decision_trace=tr), tr))
    return out


def test_scenario_runs_equal(plans):
    jprof, jreport, tprof, treport = plans
    jout = _run_scenarios(JS, JF, JServingSimulator, JVecSim,
                          JDecisionTrace, jprof, jreport.plan)
    tout = _run_scenarios(TS, TF, TServingSimulator, TVecSim,
                          TDecisionTrace, tprof, treport.plan)
    assert [x[0] for x in tout] == [x[0] for x in jout]
    for (label, jres, jtr), (_, tres, ttr) in zip(jout, tout):
        if jtr is None:
            assert tres == jres, label
            continue
        _assert_same(tres, jres, label)
        assert dataclasses.asdict(ttr) == dataclasses.asdict(jtr), label
    by = {label: res for label, res, _ in jout}
    # the scenarios bite: the hard revoke sheds, the warning saves some
    assert by["revoke-hard"].shed > by["revoke-warned"].shed
    assert by["chaos-sim"].completed > 0


class _ReplayEngine:
    """``tests/test_scheduling_parity.py``'s engine: the request's
    recorded certainty in scores[:, 0] (tokens[0] carries the rid)."""

    def __init__(self, certs):
        self.certs = np.asarray(certs, np.float64)

    def infer(self, tokens):
        vi = np.asarray(tokens)[:, 0] % len(self.certs)
        out = np.zeros((len(vi), 2))
        out[:, 0] = self.certs[vi]
        return out


def _cert_estimator(scores):
    return scores[:, 0]


def test_run_virtual_scenario_equal(plans):
    jprof, jreport, tprof, treport = plans
    out = {}
    for pkg, S, Server, Request, RoutePool, DecisionTrace, prof, plan in (
            ("jax", JS, JCascadeServer, JRequest, JRoutePool,
             JDecisionTrace, jprof, jreport.plan),
            ("torch", TS, TCascadeServer, TRequest, TRoutePool,
             TDecisionTrace, tprof, treport.plan)):
        sc = _chaos(S)
        n_arr = len(trace_to_arrivals(sc.qps()))
        tr = DecisionTrace()
        srv = Server(plan, {m: _ReplayEngine(prof[m].validation.certs)
                            for m in prof},
                     estimator=_cert_estimator, decision_trace=tr,
                     route_pool=RoutePool.for_arrivals(0, n_arr))
        done = srv.run_virtual(
            [Request(rid=i, tokens=np.array([i], np.int64))
             for i in range(n_arr)],
            batch_runtime=lambda m, b, p=prof: p[m].runtime(b), scenario=sc)
        out[pkg] = (srv, done, tr)
    (jsrv, jdone, jtr), (tsrv, tdone, ttr) = out["jax"], out["torch"]
    assert len(jtr.fires) > 10 and len(jtr.gear_switches) >= 1
    assert dataclasses.asdict(ttr) == dataclasses.asdict(jtr)
    assert tsrv.gear_switches == jsrv.gear_switches
    assert [(r.rid, r.t_done, r.resolver) for r in tdone] == \
        [(r.rid, r.t_done, r.resolver) for r in jdone]


# ---------------------------------------------------------------------------
# re-planning on failure and the fleet controller
# ---------------------------------------------------------------------------

def _plan_dict(p):
    return None if p is None else p.to_dict()


def test_rebalance_and_replan_equal(plans):
    jprof, jreport, tprof, treport = plans
    for down in ({3}, {2, 3}, {0}):
        a = JF.rebalance_on_failure(jreport.plan, jprof, set(down))
        b = TF.rebalance_on_failure(treport.plan, tprof, set(down))
        assert b.to_json() == a.to_json(), down
    for kind in (JF, TF):
        with pytest.raises(RuntimeError):
            rep = jreport if kind is JF else treport
            prof = jprof if kind is JF else tprof
            kind.rebalance_on_failure(rep.plan, prof, {0, 1, 2, 3})
    for n, qps_max in ((2, 3800.0), (3, None), (5, None)):
        a = j_build_plan(JF.elastic_replan(jreport.state, n, qps_max))
        b = t_build_plan(TF.elastic_replan(treport.state, n, qps_max))
        assert b.to_json() == a.to_json(), n
    # the coordinator's memo: a drain then a revoke of one device, a
    # recovery, the same device again, then every device
    seq = []
    for F, rep, prof in ((JF, jreport, jprof), (TF, treport, tprof)):
        c = F.PreemptionCoordinator(rep.plan, prof)
        got = [c.on_failure(10.0, 3), c.on_failure(18.0, 3),
               c.on_recover(3), c.on_failure(20.0, 3)]
        got += [c.on_failure(float(d), d) for d in range(4)]
        seq.append(([None if g is None else [x.to_dict() for x in g]
                     for g in got], c.solves, c.hits, c.infeasible))
    assert seq[1] == seq[0]


def _drive_controller(F, ReplanTrigger, Capacity, report):
    def trig(reason, t):
        return ReplanTrigger(reason=reason, t=t, measured_qps=500.0)

    cfg = F.FleetConfig(min_devices=1, max_devices=6, cooldown=50.0,
                        shrink_guard=1.2, device_hour_price=2.0)
    fc = F.FleetController(report.state, cfg, base_plan=report.plan)
    log = []
    cap3 = Capacity(fc.plan_for(3), report.state.profiles)
    for t, reason, peak in ((100.0, "scale-out", 5000.0),
                            (120.0, "scale-out", 5000.0),
                            (200.0, "scale-in", cap3),
                            (300.0, "scale-in", 100.0),
                            (400.0, "scale-out", 5000.0),
                            (500.0, "scale-out", 5000.0),
                            (600.0, "scale-out", 5000.0)):
        fc.meter(t)
        fc.request(trig(reason, t), t)
        log.append((_plan_dict(fc.act(t, recent_peak_qps=peak)),
                    fc.n_devices))
    log.append(_plan_dict(fc.apply_fleet_event(700.0, "grant", 2)))
    log.append(_plan_dict(fc.apply_fleet_event(710.0, "revoke", 5)))
    log.append([dataclasses.asdict(a) for a in fc.actions])
    log.append((fc.device_seconds, fc.device_hours, fc.cost,
                fc.max_devices, fc.n_devices))
    log.append([Capacity(fc.plan_for(n), report.state.profiles)
                for n in (2, 3, 4)])
    return log


def test_fleet_controller_equal(plans):
    _, jreport, _, treport = plans
    jlog = _drive_controller(JF, JReplanTrigger, j_capacity, jreport)
    tlog = _drive_controller(TF, TReplanTrigger, t_capacity, treport)
    assert tlog == jlog
    assert any(a["applied"] for a in jlog[-3]) and \
        any(not a["applied"] for a in jlog[-3])


# ---------------------------------------------------------------------------
# run_elastic_fleet
# ---------------------------------------------------------------------------

def _fleet_runs(S, F, MonitorConfig, profiles, report):
    out = {}
    out["static"] = F.run_elastic_fleet(
        profiles, S.Scenario(traffic=S.constant(20, 1000.0), drain=2.0),
        plan=report.plan, slo_latency=0.4, window=8.0)
    fc = F.FleetController(report.state,
                           F.FleetConfig(min_devices=2, max_devices=4,
                                         cooldown=0.0),
                           base_plan=report.plan, start_devices=2)
    out["skipped"] = F.run_elastic_fleet(
        profiles, S.Scenario(traffic=S.constant(12, 200.0), drain=2.0,
                             events=(S.SpotPreemption(t=4.0, device=3,
                                                      lead=2.0),
                                     S.DeviceRecover(t=9.0, device=3))),
        controller=fc, slo_latency=0.4, window=6.0)
    fc = F.FleetController(report.state,
                           F.FleetConfig(min_devices=2, max_devices=4,
                                         cooldown=10.0),
                           base_plan=report.plan, start_devices=2)
    out["ramp"] = F.run_elastic_fleet(
        profiles, S.Scenario(traffic=S.ramp(60, 500.0, 6000.0), drain=2.0),
        controller=fc, monitor_cfg=MonitorConfig(
            scale_out_frac=0.5, scale_out_ticks=3, cooldown=5.0),
        slo_latency=0.4, window=15.0)
    return out


def test_run_elastic_fleet_equal(plans):
    jprof, jreport, tprof, treport = plans
    jout = _fleet_runs(JS, JF, JMonitorConfig, jprof, jreport)
    tout = _fleet_runs(TS, TF, TMonitorConfig, tprof, treport)
    for name, j in jout.items():
        _assert_same(tout[name], j, name)
    assert jout["skipped"].skipped_events == 3
    assert max(n for _, n in jout["ramp"].fleet_sizes) > 2
    with pytest.raises(ValueError):
        TF.run_elastic_fleet(tprof, TS.Scenario(
            traffic=TS.constant(5, 100.0)))
