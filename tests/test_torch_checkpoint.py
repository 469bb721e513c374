"""The port's checkpoint manager: the counterparts of
``tests/test_checkpoint.py`` (round trip with bf16, retention, crash
safety, gear plans, a missing checkpoint), and the on-disk format shared
with the JAX package: a checkpoint the JAX manager writes restores in the
port, and one the port writes restores in the JAX manager, bf16 leaves
included, bit for bit, the params and AdamW state of a smoke model among
them. Restored tensors land on the template's device (the CPU here).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.training import init_opt_state as j_init_opt_state
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import opt_state_from_numpy, params_from_numpy

torch.set_num_threads(1)


def _tree():
    return {
        "w": torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4, 8)).astype(np.float32)).bfloat16(),
        "m": {"v": torch.arange(5, dtype=torch.float32),
              "step": torch.tensor(7, dtype=torch.int32)},
    }


def _bits(t):
    """A leaf's bytes, whatever its package and dtype."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), tuple(t.shape)
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a.tobytes(), a.shape


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def test_roundtrip_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(3, tree)
    restored, meta = mgr.restore(tree)
    assert meta["step"] == 3
    # leaf order: m.step, m.v, w (keys sorted at every level)
    assert meta["dtypes"] == ["int32", "float32", "bfloat16"]
    for a, b in zip(tree_lib.leaves(tree), tree_lib.leaves(restored)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert _bits(a) == _bits(b)
    assert restored["m"]["step"].shape == ()


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]  # retention pruned 1, 2


def test_crash_safety_tmp_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    # simulate a crash mid-save: orphan tmp dir must not shadow LATEST
    os.makedirs(tmp_path / "step_000000002.tmp")
    assert mgr.latest_step() == 1
    restored, meta = mgr.restore(tree)
    assert meta["step"] == 1


def test_gear_plan_checkpointing(tmp_path):
    from repro_torch.core.gears import SLO, GearPlan
    from repro_torch.core.plan_state import HardwareSpec
    from repro_torch.core.planner import optimize_gear_plan
    from repro_torch.core.profiles import synthetic_family
    profiles = synthetic_family(
        ["tiny", "mini", "small", "medium", "base"], base_runtime=2e-4,
        runtime_ratio=2.4, base_acc=0.70, acc_gain=0.05, mem_base=0.4e9,
        seed=3)
    report = optimize_gear_plan(
        profiles, HardwareSpec(num_devices=4, mem_per_device=16e9),
        SLO(kind="latency", latency_p95=0.4), qps_max=7600, n_ranges=8)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, {"x": torch.zeros(1)}, gear_plan_json=report.plan.to_json())
    plan = GearPlan.from_json(mgr.restore_gear_plan())
    assert plan.n_ranges == report.plan.n_ranges
    # the JAX manager reads the same plan file
    assert JCheckpointManager(str(tmp_path)).restore_gear_plan() == \
        report.plan.to_json()


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(1)})
    assert mgr.restore_gear_plan() is None


def test_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"x": torch.zeros(1)})


def _model_state():
    """The JAX params (bf16 weights, f32 norm scales) and AdamW state of a
    smoke model, with nonzero moments and step."""
    cfg = jax_smoke_config("qwen2-0.5b")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    opt = j_init_opt_state(params)
    opt = {"m": jax.tree.map(lambda a: a + 0.25, opt["m"]),
           "v": jax.tree.map(lambda a: a + 0.5, opt["v"]),
           "step": jnp.asarray(12, jnp.int32)}
    return params, opt


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    params, opt = _model_state()
    JCheckpointManager(str(tmp_path)).save(12, (params, opt),
                                           extra={"arch": "qwen2-0.5b"})
    np_params = jax.tree.map(np.asarray, params)
    np_opt = jax.tree.map(np.asarray, opt)
    template = (params_from_numpy(np_params, device="cpu"),
                opt_state_from_numpy(np_opt, device="cpu"))
    template = tree_lib.tree_map(torch.zeros_like, template)
    restored, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 12 and meta["extra"] == {"arch": "qwen2-0.5b"}
    jleaves = jax.tree.leaves((params, opt))
    tleaves = tree_lib.leaves(restored)
    assert len(jleaves) == len(tleaves)
    assert any(t.dtype == torch.bfloat16 for t in tleaves)
    for j, t in zip(jleaves, tleaves):
        assert _dtype_name(t) == _dtype_name(j)
        assert _bits(t) == _bits(j)


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    params, opt = _model_state()
    ours = (params_from_numpy(jax.tree.map(np.asarray, params),
                              device="cpu"),
            opt_state_from_numpy(jax.tree.map(np.asarray, opt),
                                 device="cpu"))
    CheckpointManager(str(tmp_path)).save(12, ours,
                                          extra={"arch": "qwen2-0.5b"})
    template = jax.tree.map(jnp.zeros_like, (params, opt))
    restored, meta = JCheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 12
    jleaves = jax.tree.leaves(restored)
    assert any(np.asarray(j).dtype.name == "bfloat16" for j in jleaves)
    for t, j in zip(tree_lib.leaves(ours), jleaves):
        assert _dtype_name(t) == _dtype_name(j)
        assert _bits(t) == _bits(j)


def test_flatten_order_is_jax_tree_util_order():
    """Dict keys sorted, lists and tuples in order, None no leaf."""
    tree = {"b": [1, (2, None, 3)], "a": {"z": 4, "c": None, "d": [5]},
            "c": 6}
    leaves, treedef = tree_lib.flatten(tree)
    assert leaves == jax.tree_util.tree_flatten(tree)[0] == [5, 4, 1, 2, 3,
                                                             6]
    back = tree_lib.unflatten(treedef, leaves)
    assert back == tree
    pairs, _ = tree_lib.flatten_with_path(tree)
    assert [p for p, _ in pairs][:2] == [("a", "d", 0), ("a", "z")]
