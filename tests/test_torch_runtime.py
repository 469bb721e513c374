"""The port's serving runtime and serve entry point on the CPU.

* ``CascadeServer.run_virtual`` over torch engines and over JAX engines
  (the same JAX-trained params, plan, routing draws and requests) makes the
  same decisions: routes, gear switches, batch firings and cascade hops are
  identical, the certainty each hop records within 1e-5 (the two packages'
  f32 scores differ in the last bits). Before comparing, the test asserts
  that no request's reference certainty lies within 1e-4 of the threshold
  it meets, so such rounding cannot flip a decision.
* A short threaded ``run_trace`` through ``launch.serve.serve_real`` on
  the wall clock, with the loose bounds of the reference's real-runtime
  test, and cascade semantics checked on every completed request (trained
  briefly by the port, in a process of its own).
* ``repro_torch.launch.serve`` with ``--device cpu``: ``main`` on the
  simulator path, and the command line on the threaded ``--real`` path and
  ``--stress-replay``, at small size; the options that wait for later
  modules are refused.
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

from repro.core.cascade import Cascade as JCascade
from repro.core.execution import EngineBackend as JEngineBackend
from repro.core.gears import SLO as JSLO
from repro.core.gears import GearPlan as JGearPlan
from repro.core.lp import Replica as JReplica
from repro.core.scheduling import DecisionTrace as JDecisionTrace
from repro.core.scheduling import RoutePool as JRoutePool
from repro.core.simulator import make_gear as j_make_gear
from repro.core.simulator import trace_to_arrivals
from repro.serving import tinymodels as JT
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro.serving.runtime import CascadeServer as JCascadeServer
from repro.serving.runtime import Request as JRequest
from repro_torch.convert import tiny_params_from_numpy
from repro_torch.core.cascade import Cascade as TCascade
from repro_torch.core.execution import EngineBackend as TEngineBackend
from repro_torch.core.gears import SLO as TSLO
from repro_torch.core.gears import GearPlan as TGearPlan
from repro_torch.core.lp import Replica as TReplica
from repro_torch.core.scheduling import DecisionTrace as TDecisionTrace
from repro_torch.core.scheduling import RoutePool as TRoutePool
from repro_torch.core.simulator import make_gear as t_make_gear
from repro_torch.launch import serve as S
from repro_torch.serving import tinymodels as TT
from repro_torch.serving.engine import InferenceEngine as TInferenceEngine
from repro_torch.serving.runtime import CascadeServer as TCascadeServer
from repro_torch.serving.runtime import Request as TRequest

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

FAM = (JT.TINY_FAMILY[0], JT.TINY_FAMILY[2])
MODELS = tuple(cfg.name for cfg in FAM)
NEAR = 1e-4


@pytest.fixture(scope="module")
def trained():
    """A two-member family trained briefly by JAX: params, validation
    scores, validation tokens and labels."""
    return JT.train_tiny_family(n_train=768, n_val=256, steps_scale=0.15,
                                family=FAM)


def _torch_params(params_by):
    return {n: tiny_params_from_numpy(jax.tree.map(np.asarray, p),
                                      device="cpu")
            for n, p in params_by.items()}


def _plan(make_gear, Cascade, Replica, GearPlan, SLO, thr):
    reps = [Replica(m, d, 1e-3 * (1 + 2 * i))
            for d in range(2) for i, m in enumerate(MODELS)]
    g0 = make_gear(Cascade(MODELS, (thr,)), reps, {MODELS[0]: 2})
    g1 = make_gear(Cascade(MODELS[:1], ()), reps, {MODELS[0]: 4})
    return GearPlan(qps_max=400.0, gears=[g0, g1], replicas=reps,
                    num_devices=2, slo=SLO(kind="latency", latency_p95=1.0))


def _runtime(model, b):
    return (2e-3 if model == MODELS[0] else 6e-3) * (1.0 + 0.05 * (b - 1))


def test_run_virtual_decisions_match_jax(trained):
    params_by, _, _, _ = trained
    trace = np.concatenate([np.full(3, 40.0), np.full(3, 350.0),
                            np.full(4, 40.0)])
    n_arr = len(trace_to_arrivals(trace))
    toks, _, _ = JT.synthetic_classification_data(n_arr, seed=7)
    top2 = np.asarray(jax.lax.top_k(JT.apply_tiny(
        FAM[0], params_by[MODELS[0]], jnp.asarray(toks)), 2)[0])
    ref_certs = top2[:, 0] - top2[:, 1]
    # calibration: the stage-0 threshold sits mid-way across the widest
    # gap between the requests' reference certainties in their middle
    # half, so both outcomes occur
    s = np.sort(ref_certs)[n_arr // 4:3 * n_arr // 4]
    k = int(np.argmax(np.diff(s)))
    thr = float(0.5 * (s[k] + s[k + 1]))

    # no request's reference certainty at stage 0 sits within NEAR of the
    # threshold: rounding between the packages cannot flip a decision
    near = np.flatnonzero(np.abs(ref_certs - thr) <= NEAR)
    assert near.size == 0, (
        f"requests {near.tolist()} have a stage-0 certainty within {NEAR} "
        f"of the threshold {thr}: the comparison cannot be exact")

    jeng = {cfg.name: JInferenceEngine(
        cfg.name, lambda p, t, c=cfg: JT.apply_tiny(c, p, t),
        params_by[cfg.name]) for cfg in FAM}
    tparams = _torch_params(params_by)
    teng = {cfg.name: TInferenceEngine(
        cfg.name, lambda p, t, c=cfg: TT.apply_tiny(c, p, t),
        tparams[cfg.name]) for cfg in FAM}

    jtr, ttr = JDecisionTrace(), TDecisionTrace()
    jsrv = JCascadeServer(
        _plan(j_make_gear, JCascade, JReplica, JGearPlan, JSLO, thr),
        backend=JEngineBackend(jeng), max_batch=128,
        route_pool=JRoutePool.for_arrivals(0, n_arr), decision_trace=jtr)
    tsrv = TCascadeServer(
        _plan(t_make_gear, TCascade, TReplica, TGearPlan, TSLO, thr),
        backend=TEngineBackend(teng), max_batch=128,
        route_pool=TRoutePool.for_arrivals(0, n_arr), decision_trace=ttr)
    jdone = jsrv.run_virtual([JRequest(rid=i, tokens=toks[i])
                              for i in range(n_arr)], trace,
                             batch_runtime=_runtime)
    tdone = tsrv.run_virtual([TRequest(rid=i, tokens=toks[i])
                              for i in range(n_arr)], trace,
                             batch_runtime=_runtime)

    # the scenario exercises every decision type
    assert len(jtr.gear_switches) >= 2
    assert len(jtr.fires) > 10
    assert any(h[2] != "resolve" for h in jtr.hops)
    assert any(h[2] == "resolve" for h in jtr.hops)

    assert ttr.routes == jtr.routes
    assert ttr.gear_switches == jtr.gear_switches
    assert ttr.fires == jtr.fires
    assert ttr.swaps == jtr.swaps
    assert [(s, o) for s, _, o in ttr.hops] == \
        [(s, o) for s, _, o in jtr.hops]
    np.testing.assert_allclose([c for _, c, _ in ttr.hops],
                               [c for _, c, _ in jtr.hops], atol=1e-5,
                               rtol=0)
    assert len(tdone) == len(jdone) == n_arr
    jby = {r.rid: r for r in jdone}
    for r in tdone:
        j = jby[r.rid]
        assert (r.resolver, r.t_done, r.gear_idx) == \
            (j.resolver, j.t_done, j.gear_idx)
        if abs(j.cert) > NEAR:
            assert r.pred == j.pred


# The threaded tests run in a process of their own: with JAX loaded in the
# test process, torch CPU ops issued from the server's consumer threads
# leave its intra-op thread pool many times slower for every later test
# in that process.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_THREADED = """
import json
import numpy as np
from repro_torch.core.gears import SLO
from repro_torch.core.plan_state import HardwareSpec
from repro_torch.core.planner import optimize_gear_plan
from repro_torch.core.scheduling import DecisionTrace
from repro_torch.launch import serve as S
from repro_torch.serving import tinymodels as TT

fam = (TT.TINY_FAMILY[0], TT.TINY_FAMILY[2])
backend = TT.make_engine_backend(
    *TT.train_tiny_family(n_train=768, n_val=256, steps_scale=0.15,
                          family=fam, device="cpu"),
    family=fam, batch_sizes=(1, 4, 16), repeats=2)
plan = optimize_gear_plan(backend.profiles,
                          HardwareSpec(num_devices=2, mem_per_device=16e9),
                          SLO(kind="latency", latency_p95=0.5),
                          qps_max=300, n_ranges=4).plan
tr = DecisionTrace()
server, done, labels, offered = S.serve_real(plan, backend,
                                             np.full(3, 60.0),
                                             decision_trace=tr)
bad = []
for r in done:
    casc = r.gear.cascade
    ok = 0 <= r.resolver < len(casc.models) and r.pred in (0, 1)
    if ok and r.resolver < len(casc.thresholds):
        ok = r.cert >= casc.thresholds[r.resolver]
    if not ok:
        bad.append(r.rid)
print(json.dumps({"done": len(done), "offered": offered,
                  "fires": len(tr.fires), "bad": bad,
                  **S.summarize(done, labels)}))
"""


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"        # as the in-process tests (above)
    out = subprocess.run([sys.executable, *args], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_threaded_run_trace_serves_on_the_wall_clock():
    """The reference's real-runtime bounds (``tests/test_serving_runtime
    .py``): at least 95 % of the arrivals done, p95 under 1 s, accuracy
    above chance; every completed request resolved at a stage of its
    cascade, above that stage's threshold unless it is the last."""
    s = json.loads(_run(["-c", _THREADED]).splitlines()[-1])
    assert s["offered"] == 180
    assert s["done"] >= 0.95 * s["offered"]
    assert s["p95_ms"] < 1000.0
    assert s["accuracy"] > 0.5
    assert s["bad"] == [] and s["fires"] > 0


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


def test_serve_main_des_path(artifact, tmp_path, capsys):
    plan_out = str(tmp_path / "plan.json")
    S.main(_SMALL + ["--artifact", artifact, "--plan-out", plan_out])
    out = capsys.readouterr().out
    assert "memory per logical device" in out
    assert "simulated (replay backend):" in out
    with open(plan_out) as f:
        plan = TGearPlan.from_json(f.read())
    assert len(plan.gears) == 2 and plan.num_devices == 2


@pytest.mark.parametrize("mode", ["--real", "--stress-replay"])
def test_serve_main_threaded_paths(artifact, mode):
    out = _run(["-m", "repro_torch.launch.serve", *_SMALL,
                "--artifact", artifact, mode])
    if mode == "--real":
        assert "REAL runtime (cpu):" in out
        assert "simulated, same plan and trace:" in out
    else:
        assert "REPLAY stress (wall clock):" in out


@pytest.mark.parametrize("extra,item", [
    (["--workload", "qwen"], "item 10"),
    (["--tenants", "a:latency:0.3:600"], "item 12"),
    (["--metrics-out", "m.jsonl"], "item 13")])
def test_serve_main_refuses_what_is_not_ported(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        S.main(["--device", "cpu"] + extra)
