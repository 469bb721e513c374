"""The port's decision layer against the JAX package's, on the CPU: its
import closure, multi-tenant simulation, and the certainty estimators
other than ``top2_gap``.

* Every ``repro_torch`` import in the port (module level and inside
  functions) names a module or attribute that exists: a verbatim copy that
  reaches a module the port lacks fails here, not at run time.
* ``ServingSimulator.run_multi_tenant`` on one two-tenant plan and trace,
  with and without per-tenant plan lifecycles: every field of every
  ``TenantResult`` and every decision of the per-tenant traces equal.
* ``top2_gap_softmax``, ``max_prob`` and ``neg_entropy`` against
  ``repro/core/certainty.py`` on tensors and on host arrays, with planted
  ties, within atol 1e-6 and rtol 1e-6 (float32: the entropy is a sum over
  V terms in another order, a few ULPs apart at |6|); ``EngineBackend.
  execute`` with each estimator against the JAX backend: certainties at
  the same tolerance, predictions equal (ties to the lower class in both).
"""
import ast
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import certainty as jcert
from repro.core.execution import EngineBackend as JEngineBackend
from repro.core.gears import SLO as JSLO
from repro.core.plan_state import HardwareSpec as JHardwareSpec
from repro.core.profiles import synthetic_family as j_synthetic_family
from repro.core.scheduling import DecisionTrace as JDecisionTrace
from repro.core.simulator import ServingSimulator as JServingSimulator
from repro.core.simulator import SimConfig as JSimConfig
from repro.core import tenancy as JTN
from repro.core.adaption import MonitorConfig as JMonitorConfig
from repro_torch.core import certainty as tcert
from repro_torch.core.execution import EngineBackend as TEngineBackend
from repro_torch.core.gears import SLO as TSLO
from repro_torch.core.plan_state import HardwareSpec as THardwareSpec
from repro_torch.core.profiles import synthetic_family as t_synthetic_family
from repro_torch.core.scheduling import DecisionTrace as TDecisionTrace
from repro_torch.core.simulator import ServingSimulator as TServingSimulator
from repro_torch.core.simulator import SimConfig as TSimConfig
from repro_torch.core import tenancy as TTN
from repro_torch.core.adaption import MonitorConfig as TMonitorConfig

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
EST_TOL = dict(atol=1e-6, rtol=1e-6)
OTHER_ESTIMATORS = ["top2_gap_softmax", "max_prob", "neg_entropy"]


# ---------------------------------------------------------------------------
# the port's import closure
# ---------------------------------------------------------------------------

def _port_imports():
    """(file, line, module, names) of every repro_torch import in the port,
    relative imports resolved, at any depth of the syntax tree."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        pkg = ".".join(path.relative_to(PORT.parent).with_suffix("")
                       .parts)
        if path.name != "__init__.py":
            pkg = pkg.rsplit(".", 1)[0]
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] == "repro_torch":
                        out.append((path.name, node.lineno, a.name, []))
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:
                    base = pkg.split(".")
                    base = base[:len(base) - node.level + 1]
                    mod = ".".join(base + ([mod] if mod else []))
                if mod.split(".")[0] == "repro_torch":
                    out.append((path.name, node.lineno, mod,
                                [a.name for a in node.names]))
    return out


def test_no_port_import_dangles():
    imports = _port_imports()
    assert len(imports) > 150
    missing = []
    for fname, line, mod, names in imports:
        if importlib.util.find_spec(mod) is None:
            missing.append(f"{fname}:{line} {mod}")
            continue
        m = importlib.import_module(mod)
        for n in names:
            if not hasattr(m, n) and \
                    importlib.util.find_spec(f"{mod}.{n}") is None:
                missing.append(f"{fname}:{line} {mod}.{n}")
    assert missing == []


# ---------------------------------------------------------------------------
# multi-tenant simulation
# ---------------------------------------------------------------------------

def _tenants(TenantSpec, SLO):
    return [TenantSpec("interactive", SLO(kind="latency", latency_p95=0.5),
                       qps_max=400.0, weight=2.0, n_ranges=2),
            TenantSpec("analytics", SLO(kind="latency", latency_p95=1.0),
                       qps_max=200.0, weight=1.0, n_ranges=2)]


def _family(synthetic_family):
    # the arguments of tests/test_tenancy.py's ``small_family``
    return synthetic_family(["tiny", "small", "base"], base_runtime=2e-4,
                            runtime_ratio=2.4, base_acc=0.70,
                            acc_gain=0.06, mem_base=0.4e9, seed=3)


def _run_multi_tenant(TN, synthetic_family, HardwareSpec, SLO,
                      ServingSimulator, SimConfig, DecisionTrace,
                      MonitorConfig, traces, lifecycles):
    fam = _family(synthetic_family)
    hw = HardwareSpec(num_devices=2, mem_per_device=16e9)
    report = TN.plan_multi_tenant(fam, hw, _tenants(TN.TenantSpec, SLO))
    mt = report.plan
    lcs = None
    if lifecycles:
        lcs = TN.make_tenant_lifecycles(
            report, fam, hw,
            monitor_cfg=MonitorConfig(qps_sustain_ticks=3, cooldown=60.0),
            plan_latency=0.5)
    sim = ServingSimulator(fam, mt.replicas, hw.num_devices,
                           SimConfig(max_batch=128))
    dtr = {n: DecisionTrace() for n in mt.names}
    res = sim.run_multi_tenant(mt, traces, lifecycles=lcs,
                               decision_traces=dtr)
    return mt, res, dtr, lcs


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("lifecycles", [False, True])
def test_run_multi_tenant_equals_reference(lifecycles):
    traces = {"interactive": np.concatenate([np.full(2, 300.0),
                                             np.full(6, 800.0),
                                             np.full(4, 300.0)]),
              "analytics": np.full(12, 100.0)}
    jmt, jres, jtr, jlcs = _run_multi_tenant(
        JTN, j_synthetic_family, JHardwareSpec, JSLO, JServingSimulator,
        JSimConfig, JDecisionTrace, JMonitorConfig, traces, lifecycles)
    tmt, tres, ttr, tlcs = _run_multi_tenant(
        TTN, t_synthetic_family, THardwareSpec, TSLO, TServingSimulator,
        TSimConfig, TDecisionTrace, TMonitorConfig, traces, lifecycles)
    assert tmt.to_json() == jmt.to_json()
    assert sorted(tres) == sorted(jres) == sorted(traces)
    for name, j in jres.items():
        t = tres[name]
        assert type(t).__name__ == type(j).__name__ == "TenantResult"
        assert (t.name, t.offered, t.shed) == (j.name, j.offered, j.shed)
        jd = dataclasses.asdict(j.result)
        td = dataclasses.asdict(t.result)
        assert sorted(td) == sorted(jd)
        for field, value in jd.items():
            assert _same(td[field], value), f"{name}.result.{field}"
        assert t.p95 == j.p95 and t.accuracy == j.accuracy
        assert ttr[name].routes == jtr[name].routes
        assert ttr[name].gear_switches == jtr[name].gear_switches
        assert ttr[name].hops == jtr[name].hops
    assert tres["interactive"].result.completed > 0
    if lifecycles:
        # the drifted tenant re-planned in both, at the same moments
        assert tres["interactive"].result.plan_swaps
        assert [s.reason for s in tlcs["interactive"].swaps] == \
            [s.reason for s in jlcs["interactive"].swaps]


# ---------------------------------------------------------------------------
# certainty estimators other than top2_gap
# ---------------------------------------------------------------------------

def _scores(v, seed):
    """(6, v) float32 logits: row 0 a two-way tie at the top, row 1 all
    equal, row 2 a three-way tie, row 3 large logits (softmax stability),
    rows 4-5 plain draws."""
    x = (np.random.default_rng(seed).standard_normal((6, v)) * 2.0
         ).astype(np.float32)
    x[0, v - 1] = x[0, 0] = x[0].max() + 1.0
    x[1] = 0.75
    if v >= 3:
        x[2, 1] = x[2, v // 2] = x[2, v - 1] = x[2].max() + 0.5
    x[3] *= 40.0
    return x


@pytest.mark.parametrize("v", [2, 7, 512])
@pytest.mark.parametrize("name", OTHER_ESTIMATORS)
def test_estimator_matches_jax(name, v):
    x = _scores(v, seed=v)
    ref = np.asarray(jcert.CERTAINTY_ESTIMATORS[name](jnp.asarray(x)))
    fn = tcert.CERTAINTY_ESTIMATORS[name]
    out = fn(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **EST_TOL)
    host = fn(x)                       # numpy in, numpy out
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, out.numpy())
    if name == "top2_gap_softmax":     # planted top ties: gap exactly 0
        assert out[0] == 0.0 and out[1] == 0.0
        if v >= 3:
            assert out[2] == 0.0


class _RowScores:
    """An engine whose scores for a batch are rows of a fixed table, keyed
    by each sample's first token: in torch (the port) or in jnp (JAX)."""

    def __init__(self, table):
        self.table = table

    def infer(self, tokens):
        rows = np.asarray(tokens)[:, 0].astype(np.int64)
        if isinstance(self.table, torch.Tensor):
            return self.table[torch.from_numpy(rows)]
        return self.table[rows]


@pytest.mark.parametrize("name", ["top2_gap"] + OTHER_ESTIMATORS)
def test_engine_backend_estimator_branch_matches_jax(name):
    """``EngineBackend.execute`` with each estimator on the same (n, 5)
    scores: the port's tensor branch (``_reduce_tensor``) against the JAX
    backend."""
    table = np.concatenate([_scores(5, seed=s) for s in range(4)])
    toks = np.arange(len(table), dtype=np.int32)[:, None].repeat(3, 1)
    labels = np.random.default_rng(0).integers(0, 5, len(table)) \
        .astype(np.int32)
    sids = [0, 1, 2, 3, 4, 5, 9, 13, 17, 23, 7]
    jb = JEngineBackend({"m": _RowScores(jnp.asarray(table))},
                        estimator=name, tokens=toks, labels=labels)
    tb = TEngineBackend({"m": _RowScores(torch.from_numpy(table))},
                        estimator=name, tokens=toks, labels=labels)
    jx, tx = jb.execute("m", sids), tb.execute("m", sids)
    assert tx.certs.dtype == np.float64
    np.testing.assert_allclose(tx.certs, np.asarray(jx.certs), **EST_TOL)
    assert np.array_equal(tx.preds, np.asarray(jx.preds))
    assert tx.correct == jx.correct
    assert tx.preds[0] == 0 and tx.preds[1] == 0    # ties: the lower class
