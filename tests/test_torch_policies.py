"""The port's baseline policies and admission control against the JAX
package's, on the CPU.

* DynBa (every model), MS+ (its grid), Cocktail+ (its grid with the
  ground-truth forecast, and its default without) and the static partition, on the same
  profiles in both packages (the shared BERT-like family, and a small
  tiny-classifier family trained by JAX): each builds the same gears,
  replicas and device count, its selector picks the same gear at every
  probe, and ``run_policy`` returns the same ``SimResult``, every field
  exactly (the static partition: the same per-tenant plans and the same
  ``run_multi_tenant`` results). ``build_plan`` gives the same plan JSON,
  and raises ``NotImplementedError`` on Cocktail+'s ensemble gears in both.
* MS+ and DynBa through ``build_plan`` on ``CascadeServer.run_virtual``
  over torch tiny engines and over JAX tiny engines with the same weights:
  the same routes, gear switches, batch firings and hops; the certainty
  each hop records within 1e-5 (the packages' f32 scores differ in the last
  bits). The guard of the other decision-parity tests holds vacuously:
  these gears are single models, so no decision reads a certainty against
  a threshold (asserted).
* Admission: ``fleet_capacities``, ``gear_capacity``,
  ``cheapest_gear_index``, ``weighted_fair_shares`` and the
  ``AdmissionController`` on the inputs of ``tests/test_admission.py``:
  the same numbers and the same per-tick decisions and admit sequences,
  exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import admission as JA
from repro.core.cascade import Cascade as JCascade
from repro.core.execution import EngineBackend as JEngineBackend
from repro.core.gears import SLO as JSLO
from repro.core.gears import GearPlan as JGearPlan
from repro.core.lp import Replica as JReplica
from repro.core.plan_state import HardwareSpec as JHardwareSpec
from repro.core.profiles import ModelProfile as JModelProfile
from repro.core.scheduling import DecisionTrace as JDecisionTrace
from repro.core.scheduling import RoutePool as JRoutePool
from repro.core.simulator import ServingSimulator as JServingSimulator
from repro.core.simulator import make_gear as j_make_gear
from repro.core.simulator import trace_to_arrivals
from repro.core.tenancy import MultiTenantPlan as JMultiTenantPlan
from repro.core.tenancy import TenantSpec as JTenantSpec
from repro.serving import baselines as JB
from repro.serving import tinymodels as JT
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro.serving.runtime import CascadeServer as JCascadeServer
from repro.serving.runtime import Request as JRequest
from repro_torch.convert import tiny_params_from_numpy
from repro_torch.core import admission as TA
from repro_torch.core.cascade import Cascade as TCascade
from repro_torch.core.execution import EngineBackend as TEngineBackend
from repro_torch.core.gears import SLO as TSLO
from repro_torch.core.gears import GearPlan as TGearPlan
from repro_torch.core.lp import Replica as TReplica
from repro_torch.core.plan_state import HardwareSpec as THardwareSpec
from repro_torch.core.profiles import ModelProfile as TModelProfile
from repro_torch.core.profiles import synthetic_family as t_synthetic_family
from repro_torch.core.scheduling import DecisionTrace as TDecisionTrace
from repro_torch.core.scheduling import RoutePool as TRoutePool
from repro_torch.core.simulator import ServingSimulator as TServingSimulator
from repro_torch.core.simulator import make_gear as t_make_gear
from repro_torch.core.tenancy import MultiTenantPlan as TMultiTenantPlan
from repro_torch.core.tenancy import TenantSpec as TTenantSpec
from repro_torch.serving import baselines as TB
from repro_torch.serving import tinymodels as TT
from repro_torch.serving.engine import InferenceEngine as TInferenceEngine
from repro_torch.serving.runtime import CascadeServer as TCascadeServer
from repro_torch.serving.runtime import Request as TRequest

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

CERT_TOL = 1e-5
FAM = JT.TINY_FAMILY[:3]
# a step up and back down: the switching policies change gear both ways
TRACE = np.concatenate([np.full(2, 200.0), np.full(3, 1700.0),
                        np.full(2, 200.0)])
QPS_MAX = 2000.0


def _bert_like(synthetic_family):
    # the arguments of the conftest ``bert_like_profiles`` fixture
    return synthetic_family(
        ["tiny", "mini", "small", "medium", "base"],
        base_runtime=2e-4, runtime_ratio=2.4, base_acc=0.70,
        acc_gain=0.05, mem_base=0.4e9, seed=3)


@pytest.fixture(scope="module")
def trained():
    """A three-member tiny family trained briefly by JAX: params, and each
    package's profiles over the same validation scores (each reduced by
    its own estimator) with one fixed runtime curve per model."""
    params_by, scores_by, _, lab_va = JT.train_tiny_family(
        n_train=768, n_val=384, steps_scale=0.15, family=FAM)
    bs = np.array([1.0, 4.0, 16.0, 64.0])
    jprof, tprof = {}, {}
    for i, cfg in enumerate(FAM):
        rts = 2e-4 * (1.8 ** i) * (1.0 + 0.15 * (bs - 1.0))
        mem = 4.0 * 1e4 * (i + 1)
        jprof[cfg.name] = JModelProfile(
            name=cfg.name, mem_bytes=mem, batch_sizes=bs,
            batch_runtimes=rts, validation=JT.validation_record_from_scores(
                scores_by[cfg.name], lab_va))
        tprof[cfg.name] = TModelProfile(
            name=cfg.name, mem_bytes=mem, batch_sizes=bs.copy(),
            batch_runtimes=rts.copy(),
            validation=TT.validation_record_from_scores(
                scores_by[cfg.name], lab_va))
    return params_by, jprof, tprof


@pytest.fixture(scope="module", params=["bert_like", "tiny_trained"])
def profiles(request, bert_like_profiles):
    if request.param == "bert_like":
        return bert_like_profiles, _bert_like(t_synthetic_family)
    _, jprof, tprof = request.getfixturevalue("trained")
    return jprof, tprof


def _policies(B, profiles, forecast):
    """Every grid point of the three baselines (Cocktail+'s with the
    ground-truth forecast), and Cocktail+'s default without it, as
    (label, policy)."""
    out = [(f"dynba-{p.model}", p) for p in B.DynBaPolicy.grid(profiles)]
    out += [(f"msplus-{p.headroom}", p) for p in B.MSPlusPolicy.grid(profiles)]
    out += [(f"cocktail-{p.scale_interval}-{p.target_util}", p)
            for p in B.CocktailPlusPolicy.grid(profiles, forecast=forecast)]
    out.append(("cocktail-default-measured", B.CocktailPlusPolicy()))
    return out


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _assert_same_result(t, j, what):
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert sorted(td) == sorted(jd)
    for field, value in jd.items():
        assert _same(td[field], value), f"{what}: {field}"


def _gears(gears):
    return [(g.to_dict(), getattr(g, "mode", None)) for g in gears]


@pytest.mark.parametrize("devices", [2, 4])
def test_baseline_policies_equal_reference(profiles, devices):
    jprof, tprof = profiles
    jhw = JHardwareSpec(num_devices=devices, mem_per_device=16e9)
    thw = THardwareSpec(num_devices=devices, mem_per_device=16e9)
    jslo = JSLO(kind="latency", latency_p95=0.4)
    tslo = TSLO(kind="latency", latency_p95=0.4)
    jpols = _policies(JB, jprof, TRACE)
    tpols = _policies(TB, tprof, TRACE)
    assert [n for n, _ in tpols] == [n for n, _ in jpols]
    switched = 0
    for (name, jp), (_, tp) in zip(jpols, tpols):
        jg, jsel, jreps, jnd = jp.build(jprof, jhw, jslo, QPS_MAX)
        tg, tsel, treps, tnd = tp.build(tprof, thw, tslo, QPS_MAX)
        assert _gears(tg) == _gears(jg), name
        assert [dataclasses.asdict(r) for r in treps] == \
            [dataclasses.asdict(r) for r in jreps], name
        assert tnd == jnd
        for t in (0.0, 0.1, 4.95, 5.0, 12.3):
            for q in (0.0, 150.0, 1000.0, 1999.0, 9000.0):
                for cur in range(len(jg)):
                    assert tsel(t, q, cur, 3) == jsel(t, q, cur, 3), name
        jtr, ttr = JDecisionTrace(), TDecisionTrace()
        jres = JServingSimulator(jprof, jreps, jnd).run_policy(
            jg, jsel, TRACE, decision_trace=jtr)
        tres = TServingSimulator(tprof, treps, tnd).run_policy(
            tg, tsel, TRACE, decision_trace=ttr)
        _assert_same_result(tres, jres, name)
        assert dataclasses.asdict(ttr) == dataclasses.asdict(jtr), name
        if name.startswith("cocktail"):
            assert TB.CocktailPlusPolicy.active_device_cost(tres, tg) == \
                JB.CocktailPlusPolicy.active_device_cost(jres, jg)
            with pytest.raises(NotImplementedError):
                tp.build_plan(tprof, thw, tslo, QPS_MAX)
            with pytest.raises(NotImplementedError):
                jp.build_plan(jprof, jhw, jslo, QPS_MAX)
        else:
            jplan, _ = jp.build_plan(jprof, jhw, jslo, QPS_MAX)
            tplan, _ = tp.build_plan(tprof, thw, tslo, QPS_MAX)
            assert tplan.to_json() == jplan.to_json(), name
        assert jres.completed > 0
        switched += bool(jres.gear_switches)
    assert switched >= 3       # MS+ and Cocktail+ change gear on the step


def test_static_partition_equals_reference(profiles):
    jprof, tprof = profiles
    specs = []
    for TenantSpec, SLO in ((JTenantSpec, JSLO), (TTenantSpec, TSLO)):
        specs.append([
            TenantSpec("interactive", SLO(kind="latency", latency_p95=0.5),
                       qps_max=800.0, weight=2.0, n_ranges=2),
            TenantSpec("analytics", SLO(kind="latency", latency_p95=1.0),
                       qps_max=400.0, weight=1.0, n_ranges=2)])
    for n_dev in (2, 3):
        assert TB.partition_devices(specs[1], n_dev) == \
            JB.partition_devices(specs[0], n_dev)
    jbuilt = JB.StaticPartitionPolicy().build_plans(
        jprof, JHardwareSpec(num_devices=3, mem_per_device=16e9), specs[0])
    tbuilt = TB.StaticPartitionPolicy().build_plans(
        tprof, THardwareSpec(num_devices=3, mem_per_device=16e9), specs[1])
    assert sorted(tbuilt) == sorted(jbuilt) == ["analytics", "interactive"]
    traces = {"interactive": np.concatenate([np.full(3, 200.0),
                                             np.full(3, 900.0)]),
              "analytics": np.full(6, 300.0)}
    for name, (jmt, jhw, _) in jbuilt.items():
        tmt, thw, _ = tbuilt[name]
        assert tmt.to_json() == jmt.to_json()
        assert dataclasses.asdict(thw) == dataclasses.asdict(jhw)
        tr = {name: traces[name]}
        jres = JServingSimulator(jprof, jmt.replicas, jhw.num_devices
                                 ).run_multi_tenant(jmt, tr)[name]
        tres = TServingSimulator(tprof, tmt.replicas, thw.num_devices
                                 ).run_multi_tenant(tmt, tr)[name]
        assert (tres.offered, tres.shed) == (jres.offered, jres.shed)
        _assert_same_result(tres.result, jres.result, name)
        assert jres.result.completed > 0


# ---------------------------------------------------------------------------
# baselines on the real runtime: torch engines against JAX engines
# ---------------------------------------------------------------------------

def _runtime(profiles):
    return lambda m, b: profiles[m].runtime(b)


@pytest.mark.parametrize("policy", ["msplus", "dynba"])
def test_baseline_on_real_runtime_decides_as_jax(trained, policy):
    params_by, jprof, tprof = trained
    trace = np.concatenate([np.full(3, 60.0), np.full(3, 1100.0),
                            np.full(2, 60.0)])
    n_arr = len(trace_to_arrivals(trace))
    toks, _, _ = JT.synthetic_classification_data(n_arr, seed=7)
    built = {}
    for pkg, B, prof, HardwareSpec, SLO in (
            ("jax", JB, jprof, JHardwareSpec, JSLO),
            ("torch", TB, tprof, THardwareSpec, TSLO)):
        pol = B.MSPlusPolicy(n_ranges=4) if policy == "msplus" \
            else B.DynBaPolicy(FAM[1].name)
        built[pkg] = pol.build_plan(
            prof, HardwareSpec(num_devices=2, mem_per_device=16e9),
            SLO(kind="latency", latency_p95=0.4), 1200.0)
    assert built["torch"][0].to_json() == built["jax"][0].to_json()
    # the guard: every gear is one model, so no decision compares a
    # certainty with a threshold and f32 rounding cannot flip one
    assert all(len(g.cascade.models) == 1 and not g.cascade.thresholds
               for g in built["jax"][0].gears)

    jeng = {cfg.name: JInferenceEngine(
        cfg.name, lambda p, t, c=cfg: JT.apply_tiny(c, p, t),
        params_by[cfg.name]) for cfg in FAM}
    teng = {cfg.name: TInferenceEngine(
        cfg.name, lambda p, t, c=cfg: TT.apply_tiny(c, p, t),
        tiny_params_from_numpy(jax.tree.map(np.asarray, params_by[cfg.name]),
                               device="cpu")) for cfg in FAM}
    jtr, ttr = JDecisionTrace(), TDecisionTrace()
    jplan, jsel = built["jax"]
    tplan, tsel = built["torch"]
    jsrv = JCascadeServer(jplan, backend=JEngineBackend(jeng), selector=jsel,
                          route_pool=JRoutePool.for_arrivals(0, n_arr),
                          decision_trace=jtr)
    tsrv = TCascadeServer(tplan, backend=TEngineBackend(teng), selector=tsel,
                          route_pool=TRoutePool.for_arrivals(0, n_arr),
                          decision_trace=ttr)
    jdone = jsrv.run_virtual([JRequest(rid=i, tokens=toks[i])
                              for i in range(n_arr)], trace,
                             batch_runtime=_runtime(jprof))
    tdone = tsrv.run_virtual([TRequest(rid=i, tokens=toks[i])
                              for i in range(n_arr)], trace,
                             batch_runtime=_runtime(tprof))
    assert len(jtr.fires) > 10
    if policy == "msplus":
        assert len(jtr.gear_switches) >= 2   # up on the step, back down
    assert ttr.routes == jtr.routes
    assert ttr.gear_switches == jtr.gear_switches
    assert tsrv.gear_switches == jsrv.gear_switches
    assert ttr.fires == jtr.fires
    assert [(s, o) for s, _, o in ttr.hops] == \
        [(s, o) for s, _, o in jtr.hops]
    np.testing.assert_allclose([c for _, c, _ in ttr.hops],
                               [c for _, c, _ in jtr.hops], atol=CERT_TOL,
                               rtol=0)
    assert len(tdone) == len(jdone) == n_arr
    jby = {r.rid: r for r in jdone}
    for r in tdone:
        j = jby[r.rid]
        assert (r.resolver, r.t_done, r.gear_idx) == \
            (j.resolver, j.t_done, j.gear_idx)


# ---------------------------------------------------------------------------
# admission control on the inputs of tests/test_admission.py
# ---------------------------------------------------------------------------

def _mt_two_tenants(pkg, rt=1e-3, slo_a=None, slo_b=None, w_a=1.0,
                    w_b=1.0, qps_a=400.0, qps_b=400.0):
    """``tests/test_admission.py``'s two single-model tenants over two
    shared replicas, built from package ``pkg``'s types."""
    if pkg == "jax":
        SLO, Replica, GearPlan, Cascade, make_gear, TenantSpec, MTP = (
            JSLO, JReplica, JGearPlan, JCascade, j_make_gear, JTenantSpec,
            JMultiTenantPlan)
    else:
        SLO, Replica, GearPlan, Cascade, make_gear, TenantSpec, MTP = (
            TSLO, TReplica, TGearPlan, TCascade, t_make_gear, TTenantSpec,
            TMultiTenantPlan)
    reps = [Replica("m", 0, rt), Replica("m", 1, rt)]
    slo_a = SLO(**slo_a) if slo_a else SLO(kind="latency", latency_p95=0.5)
    slo_b = SLO(**slo_b) if slo_b else SLO(kind="latency", latency_p95=0.5)
    specs = [TenantSpec("a", slo_a, qps_a, weight=w_a, n_ranges=1),
             TenantSpec("b", slo_b, qps_b, weight=w_b, n_ranges=1)]

    def plan(slo):
        return GearPlan(qps_max=qps_a, gears=[
            make_gear(Cascade(("m",), ()), reps)], replicas=reps,
            num_devices=2, slo=slo)

    return MTP(tenants=specs, plans={"a": plan(slo_a), "b": plan(slo_b)},
               gear_demand={"a": [{"m": 1.0}], "b": [{"m": 1.0}]})


# (two-tenant plan arguments, controller config, per-tick measured qps)
ADMISSION_CASES = {
    "boundary": ({}, {}, [{"a": 400.0, "b": 0.0},
                          {"a": 400.0 + 1e-6, "b": 0.0}]),
    "disengage": ({}, {"disengage_ticks": 3},
                  [{"a": 900.0, "b": 0.0}] + [{"a": 100.0, "b": 0.0}] * 3),
    "zero_weight": ({"w_b": 0.0}, {}, [{"a": 2000.0, "b": 2000.0}]),
    "all_overloaded": ({"w_a": 3.0}, {}, [{"a": 4000.0, "b": 4000.0}]),
    "deadline_shed": ({"rt": 5e-2, "slo_a": {"kind": "latency",
                                             "latency_p95": 0.01}}, {},
                      [{"a": 10.0, "b": 10.0}]),
    "no_deadline_shed": ({"rt": 5e-2, "slo_a": {"kind": "latency",
                                                "latency_p95": 0.01}},
                         {"deadline_shed": False}, [{"a": 10.0, "b": 10.0}]),
    "flash_crowd": ({}, {}, [{"a": 4000.0, "b": 300.0}]),
    "reserved": ({"w_a": 3.0, "qps_b": 700.0}, {},
                 [{"a": 10000.0, "b": 600.0}]),
    "utilization_cap": ({}, {"utilization_cap": 0.75},
                        [{"a": 1500.0, "b": 900.0},
                         {"a": 300.0, "b": 300.0}]),
}


def _drive(AM, mt, cfg, ticks):
    ac = AM.AdmissionController(mt, AM.AdmissionConfig(**cfg))
    out = []
    for k, measured in enumerate(ticks):
        d = ac.on_tick(0.1 * (k + 1), measured, {"a": 0, "b": 0})
        out.append({n: dataclasses.asdict(v) for n, v in sorted(d.items())})
        out.append({n: [ac.admit(n) for _ in range(300)] for n in "ab"})
    out.append(dict(ac.shed_counts))
    out.append(dict(ac.admitted_counts))
    out.append(dict(ac.cheapest))
    return out


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_controller_equals_reference(case):
    mt_kw, cfg, ticks = ADMISSION_CASES[case]
    jout = _drive(JA, _mt_two_tenants("jax", **mt_kw), cfg, ticks)
    tout = _drive(TA, _mt_two_tenants("torch", **mt_kw), cfg, ticks)
    assert tout == jout


def test_admission_functions_equal_reference():
    for pkg, AM, Replica in (("jax", JA, JReplica), ("torch", TA, TReplica)):
        reps = [Replica("m", 0, 1e-3), Replica("m", 1, 2e-3),
                Replica("n", 0, 1e-2)]
        caps = AM.fleet_capacities(reps)
        out = [caps, AM.gear_capacity({"m": 1.0, "n": 0.1}, caps),
               AM.gear_capacity({"m": 1.0}, caps)]
        for needs, weights, cap in (
                ({"a": 0.3, "b": 0.4}, {"a": 1.0, "b": 1.0}, 1.0),
                ({"a": 2.0, "b": 1.5, "c": 3.0},
                 {"a": 2.0, "b": 1.0, "c": 1.0}, 1.0),
                ({"a": 0.1, "b": 5.0, "c": 5.0},
                 {"a": 1.0, "b": 1.0, "c": 3.0}, 1.0),
                ({"a": 2.0, "z": 2.0}, {"a": 1.0, "z": 0.0}, 1.0),
                ({"a": 0.25, "z": 2.0}, {"a": 1.0, "z": 0.0}, 1.0),
                ({"a": 3.0, "b": 0.5}, {"a": 1.0, "b": 2.0}, 2.5)):
            out.append(AM.weighted_fair_shares(needs, weights,
                                               capacity=cap))
        mt = _mt_two_tenants(pkg)
        out.append(AM.plan_capacity_qps(mt.plans["a"]))
        out.append(AM.cheapest_gear_index(mt.plans["a"], [{"m": 1.0}]))
        if pkg == "jax":
            jout = out
    assert out == jout
