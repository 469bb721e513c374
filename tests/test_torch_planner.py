"""The port's planner and simulator against the JAX package's, on the CPU.

The decision layer (profiles, cascade replay, LP, gears, scheduling,
simulators, planner and its four submodules) is numpy in both packages, and
the port keeps verbatim copies; so the same profiles must give the same
gear plan (``to_json`` equal, character for character) and the same DES run
(completed, p95, accuracy, gear switches and every decision of the
``DecisionTrace``, exactly). Profiles come from the shared synthetic BERT-
like family and from the validation scores of a small tiny-classifier
family trained by JAX, reduced by each package's own ``top2_gap``.
"""
import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.gears import SLO as JSLO
from repro.core.plan_state import HardwareSpec as JHardwareSpec
from repro.core.planner import optimize_gear_plan as j_optimize
from repro.core.profiles import ModelProfile as JModelProfile
from repro.core.scheduling import DecisionTrace as JDecisionTrace
from repro.core.simulator import ServingSimulator as JServingSimulator
from repro.serving import tinymodels as JT
from repro_torch.core.gears import SLO as TSLO
from repro_torch.core.plan_state import HardwareSpec as THardwareSpec
from repro_torch.core.planner import optimize_gear_plan as t_optimize
from repro_torch.core.profiles import ModelProfile as TModelProfile
from repro_torch.core.profiles import synthetic_family as t_synthetic_family
from repro_torch.core.scheduling import DecisionTrace as TDecisionTrace
from repro_torch.core.simulator import ServingSimulator as TServingSimulator
from repro_torch.serving import tinymodels as TT

# the suite runs under pytest-xdist: one intra-op thread per worker keeps
# these CPU tests from oversubscribing the cores that the repo's
# wall-clock tests measure on other workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# modules the port copies verbatim (imports rewritten to repro_torch)
VERBATIM = ["core/profiles.py", "core/lp.py", "core/cascade.py",
            "core/gears.py", "core/scheduling.py", "core/pareto.py",
            "core/traces.py", "core/simulator.py", "core/fastsim.py",
            "core/vecsim.py", "core/plan_state.py", "core/planner.py",
            "core/submodules/__init__.py",
            "core/submodules/cascade_search.py",
            "core/submodules/workload_adaption.py",
            "core/submodules/hardware_mapping.py",
            "core/submodules/batching.py", "core/telemetry.py",
            "core/adaption.py", "core/tenancy.py",
            "profiling/cost_model.py", "core/admission.py",
            "core/scenarios.py", "serving/baselines.py",
            "distributed/fault_tolerance.py", "training/data.py"]
# verbatim definitions inside modules that are otherwise ported
VERBATIM_DEFS = {
    "core/execution.py": ["resolve_estimator", "BatchExecution",
                          "ExecutionBackend", "ReplayBackend",
                          "TokenReplayBackend", "CostModelBackend",
                          "profile_backend"],
    "core/certainty.py": ["StreamingCertainty", "threshold_grid",
                          "coverage_accuracy_curve"],
    "serving/runtime.py": ["Request", "_ReplicaQueue", "CascadeServer",
                           "_TenantReplicaQueue", "MultiTenantServer"],
    "launch/serve.py": ["dump_metrics", "parse_slo", "parse_tenants"],
    "configs/shapes.py": ["ShapeCell", "SHAPES", "cell_is_applicable",
                          "skip_reason", "text_len", "source_len"],
    "serving/tinymodels.py": ["TinyClassifierConfig", "TINY_FAMILY",
                              "synthetic_classification_data",
                              "_FAMILY_STEPS", "_FAMILY_LR"],
}

_IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)


def _after_docstring(text: str) -> str:
    tree = ast.parse(text)
    first = tree.body[0]
    if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
        return "".join(text.splitlines(keepends=True)[first.end_lineno:])
    return text


def _definitions(text: str) -> dict:
    """Top-level name -> source segment (functions, classes, assignments)."""
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.get_source_segment(text, node)
    return out


def _rewrite(text: str) -> str:
    return _IMPORT.sub(r"\1\2 repro_torch.", text)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_is_source_identical(rel):
    ref = _rewrite((ROOT / "src/repro" / rel).read_text())
    port = (ROOT / "src/repro_torch" / rel).read_text()
    assert port.splitlines()[0].startswith(
        f'"""Verbatim copy of ``repro/{rel}``')
    assert _after_docstring(port) == _after_docstring(ref)


@pytest.mark.parametrize("rel", sorted(VERBATIM_DEFS))
def test_verbatim_definitions_are_source_identical(rel):
    ref = _definitions(_rewrite((ROOT / "src/repro" / rel).read_text()))
    port = _definitions((ROOT / "src/repro_torch" / rel).read_text())
    for name in VERBATIM_DEFS[rel]:
        assert port[name] == ref[name], f"{rel}: {name} drifted"


def _bert_like(synthetic_family):
    # the arguments of the conftest ``bert_like_profiles`` fixture
    return synthetic_family(
        ["tiny", "mini", "small", "medium", "base"],
        base_runtime=2e-4, runtime_ratio=2.4, base_acc=0.70,
        acc_gain=0.05, mem_base=0.4e9, seed=3)


def _plan_both(jprof, tprof, qps_max, n_ranges, devices=4, p95=0.4):
    j = j_optimize(jprof, JHardwareSpec(num_devices=devices,
                                        mem_per_device=16e9),
                   JSLO(kind="latency", latency_p95=p95),
                   qps_max=qps_max, n_ranges=n_ranges).plan
    t = t_optimize(tprof, THardwareSpec(num_devices=devices,
                                        mem_per_device=16e9),
                   TSLO(kind="latency", latency_p95=p95),
                   qps_max=qps_max, n_ranges=n_ranges).plan
    return j, t


def test_plan_identical_on_bert_like_profiles(bert_like_profiles):
    tprof = _bert_like(t_synthetic_family)
    jp, tp = _plan_both(bert_like_profiles, tprof, qps_max=3000, n_ranges=3)
    assert tp.to_json() == jp.to_json()
    assert len(jp.gears) == 3


@pytest.fixture(scope="module")
def trained_profiles():
    """Profiles of a small JAX-trained tiny family: validation records from
    each package's own estimator on the same JAX scores, and one fixed
    runtime curve per model (wall-clock measurements would differ between
    the two runs)."""
    fam = JT.TINY_FAMILY[:3]
    _, scores_by, _, lab_va = JT.train_tiny_family(
        n_train=768, n_val=384, steps_scale=0.15, family=fam)
    jprof, tprof, recs = {}, {}, {}
    bs = np.array([1.0, 4.0, 16.0, 64.0])
    for i, cfg in enumerate(fam):
        jrec = JT.validation_record_from_scores(scores_by[cfg.name], lab_va)
        trec = TT.validation_record_from_scores(scores_by[cfg.name], lab_va)
        recs[cfg.name] = (jrec, trec)
        rts = 2e-4 * (1.8 ** i) * (1.0 + 0.15 * (bs - 1.0))
        mem = 4.0 * 1e4 * (i + 1)
        jprof[cfg.name] = JModelProfile(
            name=cfg.name, mem_bytes=mem, batch_sizes=bs,
            batch_runtimes=rts, validation=jrec)
        tprof[cfg.name] = TModelProfile(
            name=cfg.name, mem_bytes=mem, batch_sizes=bs.copy(),
            batch_runtimes=rts.copy(), validation=trec)
    return jprof, tprof, recs, scores_by


def test_validation_records_bit_equal(trained_profiles):
    _, _, recs, _ = trained_profiles
    for jrec, trec in recs.values():
        assert trec.certs.dtype == np.asarray(jrec.certs).dtype
        assert np.array_equal(trec.certs, np.asarray(jrec.certs))
        assert np.array_equal(trec.correct, jrec.correct)
        assert np.array_equal(trec.preds, jrec.preds)


@pytest.fixture(scope="module")
def trained_plans(trained_profiles):
    jprof, tprof, _, _ = trained_profiles
    return _plan_both(jprof, tprof, qps_max=1500, n_ranges=3, devices=2,
                      p95=0.3)


def test_plan_identical_on_trained_family(trained_plans):
    jp, tp = trained_plans
    assert tp.to_json() == jp.to_json()
    # the plan cascades somewhere (a threshold is in play)
    assert any(len(g.cascade.models) > 1 for g in tp.gears)


def test_run_cascade_on_scores_matches_jax(trained_profiles, trained_plans):
    """Online cascade execution on raw host score matrices: the port's
    estimator reduces numpy scores on the host, bit-equal to JAX's."""
    from repro.core.cascade import run_cascade_on_scores as j_run
    from repro_torch.core.cascade import run_cascade_on_scores as t_run
    _, _, _, scores_by = trained_profiles
    jp, tp = trained_plans
    for jg, tg in zip(jp.gears, tp.gears):
        for a, b in zip(j_run(jg.cascade, scores_by),
                        t_run(tg.cascade, scores_by)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_des_identical_on_trained_plan(trained_profiles, trained_plans):
    jprof, tprof, _, _ = trained_profiles
    jp, tp = trained_plans
    trace = np.concatenate([np.full(3, 150.0), np.full(3, 1400.0),
                            np.full(3, 150.0)])
    jtr, ttr = JDecisionTrace(), TDecisionTrace()
    jres = JServingSimulator(jprof, jp.replicas, jp.num_devices).run_trace(
        jp, trace, decision_trace=jtr)
    tres = TServingSimulator(tprof, tp.replicas, tp.num_devices).run_trace(
        tp, trace, decision_trace=ttr)
    assert jres.completed > 0 and len(jres.gear_switches) >= 1
    assert tres.completed == jres.completed
    assert tres.offered == jres.offered
    assert tres.p95 == jres.p95
    assert tres.accuracy == jres.accuracy
    assert tres.gear_switches == jres.gear_switches
    assert np.array_equal(tres.latencies, jres.latencies)
    assert dataclasses.asdict(ttr) == dataclasses.asdict(jtr)
    assert len(jtr.hops) > 0
